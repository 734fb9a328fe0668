#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the paged serving engine on
SmolLM3-3B (bf16, and int8 weights over an int8 KV pool), the one-card
trainer on SmolLM3-3B-L8 (fp8 and int8 projections), the FSDP trainer
on SmolLM3-3B-L8 (``ring_fused_pallas``, one NCCL rank; and with int8
gathers, grads and Adam moments), with the hand-written Hopper kernels,
DDP and ZeRO-1/2/3 on the ZeRO toy MLP, the pipeline schedules and the
remat policies (one NCCL rank).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and nvcc.
TF32 is off for matmuls and cuDNN, so the plain paths are f32 oracles.
Phases, each of which fails the run:

1. card and build — print the card's name and power limit, build every
   kernel from ``csrc/`` (one nvcc per source, in parallel);
2. kernels — each kernel against its plain PyTorch version at the shapes
   its path gives it, at the tolerance its module states (K4 and K5 bit
   for bit), and launched twice on the same inputs with bit-equal
   results; K3 also over ``COMPARE_DRAWS`` draws of its serve shapes
   from each seed of ``K3_DRAW_SEEDS``, beside an f64 oracle of the
   reference's arithmetic, with each seed's count of outputs off the
   plain path gated, and K3's count off the oracle over the plain
   path's; the flash forward over ``FA_ORACLE_DRAWS`` draws beside its
   f64 oracle, its count off the oracle over the plain path's gated;
   the flash backward at a pipeline stage's microbatch (B 16, S 256)
   from each seed of ``FA_BWD_PIPE_SEEDS``, each grad's L2 distance from
   the exact f64 gradient over the plain path's gated;
   then CUDA-event times of the
   kernel, the plain version and a library yardstick (SDPA,
   ``torch._scaled_mm``, ``torch._int_mm``, ``torch.matmul``), beside
   the card's bound; K4 on each of its designs: the training products
   (wgmma), decode at M 1, 8 and 16 and the unembedding (the split-K
   GEMV, timed at M 8 in CUDA-graph replays beside ``torch._int_mm`` on
   the rows zero-padded to the fewest it takes) and one prefill chunk
   (M 256, mma.sync);
3. serve — ``ServingEngine`` with K1 and K3 on SMOLLM3_3B (full width,
   all 36 layers, seeded random weights scaled ×3) answers 8 requests;
   launch counts must equal the steps × layers, plain counts must be 0;
4. parity — against the port's one-shot ``generate`` at the engine's
   view capacity: first tokens equal, the prefill logits through K3 and
   through the plain gather path within ``PREFILL_LOGIT_ATOL`` on the
   serve's first two prompts and on two prompts from each seed of
   ``PARITY_PROMPT_SEEDS`` (beside the logits through K3's f64 oracle,
   a second witness of how far any other summation order moves them),
   and one
   decode step's logits through the kernels and through the plain path
   from one pool state allclose;
5. train parity — SMOLLM3_3B_L8 at full width and depth, seq 8192: the
   step-0 loss and grads through K6 and the flash attention against the
   plain path (plain fp8 forward, plain attention) on the same params
   and batch, and the grads again with bf16 projections (flash against
   plain attention);
6. train — ``train.flagship.run_leg`` takes 6 AdamW steps on the card
   through K6 and the flash attention (forward and backward): launch
   counts exact, plain counts 0, losses finite and falling, the step-0
   loss bit-equal to phase 5's kernel path; step time,
   tokens/s, MFU, peak memory, and a ``torch.profiler`` breakdown of
   the last step;
7. int8 serve and parity — the SMOLLM3_3B weights through
   ``quantize_decode_params``, served with ``kv_quant`` through K2
   (decode attention) and K4 (every projection and the unembedding):
   launch counts exact, plain counts 0; every first token equals the
   port's one-shot ``generate(kv_quant=True)``, and one decode step's
   logits through K2 and K4 and through the plain path allclose;
8. int8 train parity and train — SMOLLM3_3B_L8 at ``int8_pallas_bwd``:
   the step-0 loss and every grad leaf through K5 (forward) and K4 (dX,
   dW) bit-equal to the plain int8 products, then 4 steps of
   ``run_leg`` with exact launch counts, as phase 6;
9. FSDP train parity and train — on a one-rank NCCL process group (the
   group ``torchrun --nproc-per-node 1`` would give), SMOLLM3_3B_L8 at
   seq 8192, batch 1, bf16: the step-0 loss and every grad leaf of the
   FSDP step at ``overlap="ring_fused_pallas"`` (every projection
   through K7) against ``overlap="none"`` (plain bf16 products), then 4
   steps of ``train.train_fsdp.run`` at ``ring_fused_pallas``: K7's
   launches exact (7 projections x 8 layers x 2, remat, a step), plain
   calls 0, losses finite and falling, the step-0 loss bit-equal to the
   parity's K7 path; step time, tokens/s, MFU, peak memory and a
   ``torch.profiler`` breakdown of the last step.  K7 itself is held
   against its plain version in phase 2, at the seven one-rank products
   and at a rank's K-chunks of a four-rank ring (Kc 512 and 2752, the
   activation a strided view);
10. ddp and zero — on the same one-rank NCCL group, the ZeRO toy MLP at
   full width (6 x Linear(10 000, 10 000), 600 060 000 f32 params, no
   kernel of the table: its products are cuBLAS's, as the reference's
   are XLA dots): ``train.ddp.run`` takes 6 SGD steps at batch 32 with
   per-leaf sync (the sync check reads 0.0; 12 init broadcasts; 14
   all_reduces a step; the first batch's loss lower under the final
   params), then ``train.zero.run`` 6 steps a leg at batch 16 for
   ZeRO-1 (both rebuilds), -2 and -3: every sharded leg equal to its
   baseline Adam leg in losses and final params bit for bit, the
   broadcast rebuild bit-equal to the all_gather one, the shim's counts a
   step the contracts' (``parallel.contracts``); step ms beside each
   step's byte bound (``STEP_BYTES_OVER_P``), optimizer MB, memory, and a
   ``torch.profiler`` breakdown of the last step of DDP, ZeRO-1 and
   ZeRO-3 (both legs);
11. pipeline — (a) the PP toy at full width (50 -> 4 x 500 -> 50) through
   ``train.pipeline.run``, 16 epochs each of GPipe and 1F1B at 2 stages
   and of interleaved 1F1B at 4 virtual stages on 2 logical devices of
   the card: each schedule's step 0 against one monolithic Adam step,
   GPipe against 1F1B, the pinned 1F1B tick trace, the high-water marks,
   no collective, the first batch's loss lower under the final params;
   (b) SMOLLM3_3B_L8 at full width as 4 stages of 2 layers on the card
   (seq 256, batch 64 in 4 microbatches, untied head, flash attention,
   the streamed loss, remat ``"full"``): the GPipe step 0 against one
   monolithic ``lm_loss`` step and against the same pipeline with plain
   attention, FA's launches exact, then 3 epochs each of GPipe and 1F1B
   through ``train.pipeline.run``: launches exact, plain calls 0, step
   ms, tokens/s, MFU, memory and a ``torch.profiler`` breakdown of the
   last step;
12. busbench — ``train.busbench.run`` on the one-rank group: every
   collective at 1, 16 and 128 MiB, bf16, the reference's schema and
   sizing, each output a copy of its input (one rank measures no link);
13. precision — on the same group: (a) SMOLLM3_3B_L8 at int8_pallas_bwd
   with flash attention, seq 8192, batch 1, through the FSDP step with
   int8 gathers, int8 grad reduce-scatters and int8 Adam moments: step
   0 bit-equal to the plain int8 products, the flash kernels on the
   step's own layer-0 attention inputs at FA's limits, the step against
   plain attention (``PREC_PLAIN_*``), the gathered weights bit for bit
   the int8 round-trip, launches and collectives exact (the latter
   ``parallel.contracts.fsdp_quantized_step_collectives``), the int8
   moments after two updates bit-equal to ``optim8.adam8_update`` on a CPU copy, the
   update's time beside its byte bound; then 4 steps of
   ``train_fsdp.run`` with those options (launches and collectives
   exact, step 0 bit-equal to the parity's, the moments' bytes at rest
   against bf16's, step time, MFU, peak, a profile of the last step);
   (b) the same model at bf16 under each remat policy, one step after a
   warm-up: the flash forward's launches (2·L, L under ``save_attn``),
   ``save_attn`` and ``save_dots`` bit-equal to ``full``,
   ``save_dots_q8``'s loss within ``REMAT_Q8_LOSS_RTOL`` and not closer
   than ``REMAT_Q8_LOSS_MIN_RTOL``, its kept bytes at most
   ``REMAT_Q8_SAVED_RATIO`` of ``save_dots``', each policy's peak and
   step time; (c) ``train.precision_benchmark.run_one`` at seq 2048 for
   bf16, int8_pallas_bwd and fp8_pallas (K6), each row's step 0 first
   on its own inputs: the flash kernels on its layer-0 attention inputs
   at FA's limits, int8 bit-equal to the plain products, K6 on the
   row's operands at its tolerance and the step against the plain fp8
   recipe; then the rows: the reference's row keys, step 0 bit-equal to
   the parity's, launches exact.

After each serving path's gates, a second serve run of the same shape
under ``torch.profiler`` reports the device's busy share and its top
kernels, and a profile of ``DECODE_PROFILE_STEPS`` decode steps over the
serve's slots reports the decode step's device time beside its host
clock.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no card or when any phase fails.

    python3 chip_smoke.py --parent-csrc DIR

builds K7, K4/K5, K1, K2, K3, K6 and the flash attention (forward and
backward) from DIR (another commit's ``csrc/``, unpacked under the
gitignored ``build/``) beside this checkout's, gates both builds against
the plain versions (K3 over the multi-draw reading and the forward over
its f64 oracle reading too), times both in turns at the kernel phase's
shapes (K4 at training, where the parent's wrapper copied X's codes
transposed for dW, and at decode; K1 and K2 in CUDA-graph replays),
reads the int8 serve's decode step on the device with each build's K2
(in turns), serves the serve phase's kind of requests with each build's
K1 in the engine's decode step (in turns, after a warm-up serve), prints
a ``{"compare": ...}`` line and runs nothing else.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from distributed_training_sandbox_tpu_torch.kernels import loader
from distributed_training_sandbox_tpu_torch.models import mlp as MLP
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.models.generate import (
    _forward_cached, generate, init_cache, quantize_decode_params)
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.ops import flash_attention as FA
from distributed_training_sandbox_tpu_torch.ops import flash_prefill as FP
from distributed_training_sandbox_tpu_torch.ops import paged_attention as PA
from distributed_training_sandbox_tpu_torch.ops import quant as Q
from distributed_training_sandbox_tpu_torch.ops import busbench as BB
from distributed_training_sandbox_tpu_torch.parallel import fsdp, optim8
from distributed_training_sandbox_tpu_torch.parallel import pipeline as PP
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    fsdp_quantized_step_collectives, step_collectives)
from distributed_training_sandbox_tpu_torch.train import busbench as bb_run
from distributed_training_sandbox_tpu_torch.train import ddp as ddp_run
from distributed_training_sandbox_tpu_torch.train import flagship, train_fsdp
from distributed_training_sandbox_tpu_torch.train import (
    precision_benchmark as prec_bench)
from distributed_training_sandbox_tpu_torch.train import pipeline as pp_run
from distributed_training_sandbox_tpu_torch.train import zero as zero_run
from distributed_training_sandbox_tpu_torch.utils import mesh
from distributed_training_sandbox_tpu_torch.serving import engine as E
from distributed_training_sandbox_tpu_torch.serving.accounting import (
    kv_bytes_per_step, tree_bytes, weight_read_bytes)
from distributed_training_sandbox_tpu_torch.serving.kv_pool import PagedKVPool

SEED = 0
CFG = T.SMOLLM3_3B
PARAM_SCALE = 3.0
N_REQUESTS, NEW_TOKENS = 8, 64
SERVE_ROUNDS = 5   # --parent-csrc: serves in turns, 4 a round
PROMPT_LEN = (256, 1536)
ENGINE = dict(paged_kernel=True, flash_prefill=True, max_batch=8,
              page_size=16, max_seq_len=2048, prefill_chunk=256,
              sync_every=8)
# H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP8_FLOPS = 1979e12
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
# the training phase: run_leg's flagship at a quarter of its batch
TRAIN = dict(model="smollm3-3b-l8", precision="fp8_pallas", seq=8192, bs=1,
             num_steps=6, warmup_steps=3, peak_lr=3e-4, seed=42)
TRAIN_CFG = dataclasses.replace(T.SMOLLM3_3B_L8,
                                matmul_precision=TRAIN["precision"])
# the int8 training phase: int8_pallas_bwd, 4 steps
INT8_TRAIN = dict(TRAIN, precision="int8_pallas_bwd", num_steps=4)
INT8_TRAIN_CFG = dataclasses.replace(T.SMOLLM3_3B_L8,
                                     matmul_precision="int8_pallas_bwd")
# the int8 serve phase: int8 weights, the int8 pool, K2 for decode; the
# reference refuses kv_quant with flash_prefill, so prefill gathers
INT8_ENGINE = dict(ENGINE, kv_quant=True, flash_prefill=False)
# the projections of one layer: (name, K, N) of x @ w at M = seq · bs
PROJECTIONS = [("wq", 2048, 2048), ("wk", 2048, 512), ("wv", 2048, 512),
               ("wo", 2048, 2048), ("w_gate", 2048, 11008),
               ("w_up", 2048, 11008), ("w_down", 11008, 2048)]
# draws of the serve shapes on which K3's multi-draw gate reads its
# accuracy (kernel_phase, and --parent-csrc for both builds)
COMPARE_DRAWS = 10
# the seeds of K3's multi-draw readings (k3_draws): COMPARE_DRAWS draws
# each, every seed's count gated on its own
K3_DRAW_SEEDS = (SEED, SEED + 5)
# the FA forward's reading against its f64 oracle (fa_oracle_reading):
# draws of B 1, S FA_ORACLE_SEQ at the training shape's heads, one seed
# each from FA_ORACLE_SEED (the default run and --parent-csrc read the
# same draws)
FA_ORACLE_SEQ, FA_ORACLE_DRAWS, FA_ORACLE_SEED = 2048, 4, SEED + 100
# Step-0 parity, kernel path vs plain path on the same params and batch:
# |loss difference| <= LOSS_ATOL, and every grad leaf's relative L2
# error <= GRAD_REL_L2; the same without fp8 (bf16 projections, so only
# the attention kernels differ from the plain path): every grad leaf's
# relative L2 error <= BF16_GRAD_REL_L2.  Each is set between the sound
# kernels' reading and a mutant's (chip_gate_mutation.py; PERF.md).  The
# fp8 grad reading is mostly fp8 rounding noise (one-ulp differences
# upstream flip e4m3/e5m2 roundings), so GRAD_REL_L2 separates only a
# K6 mutant, by a thin margin; BF16_GRAD_REL_L2 is the backward
# kernel's step-level gate.
LOSS_ATOL = 1.5e-3
GRAD_REL_L2 = 0.182
BF16_GRAD_REL_L2 = 0.017
# the FSDP phases: train_fsdp.run at ring_fused_pallas on a one-rank
# NCCL group, SMOLLM3_3B_L8 (bf16, flash attention) at seq 8192, batch 1
FSDP_TRAIN = dict(model="smollm3-3b-l8", overlap="ring_fused_pallas",
                  seq=8192, bs=1, num_steps=4, seed=42)
FSDP_CFG = train_fsdp.model_config(FSDP_TRAIN["model"])
# K7 at one rank's K-chunk of a four-rank ring: (name, K, Kc, N), the
# chunk a strided view of the (M, K) activation
AG_CHUNKS = [("wq/wo chunk", 2048, 512, 2048),
             ("w_down chunk", 11008, 2752, 2048)]
# FSDP step-0 parity, ring_fused_pallas (K7) vs none (plain bf16
# products) on the same shards and batch: |loss difference| <=
# FSDP_LOSS_ATOL and every grad leaf's relative L2 error <=
# FSDP_GRAD_REL_L2.  Both paths run the same flash attention and the
# same plain backward products; they can differ only where K7's f32 sum
# and the library's round to neighbouring bf16 values.  On an H100 they
# read 0 (bit-equal: both sum each output's products in K order); K7
# mutants read 1.75e-4 and 8.5e-4 on the loss, 0.73 and 0.064 on the
# grads (chip_gate_mutation.py; PERF.md).  The limits leave room for a
# library that sums in another order, whose one-ulp flips would move
# the loss by ~1e-5 and the grads by a few 1e-3.
FSDP_LOSS_ATOL = 1e-4
FSDP_GRAD_REL_L2 = 0.02
# phase 10, DDP and ZeRO-1/2/3: the ZeRO toy MLP at full width (scale 1:
# 6 layers of 10 000 x 10 000, 12 leaves, 600 060 000 f32 params) on the
# FSDP phases' one-rank NCCL group; DDP takes SGD steps on a new global
# batch each step, each ZeRO stage's A/B run Adam steps on one batch
DDP_ZERO = dict(scale=1, num_steps=6, ddp_batch=32, zero_batch=16, seed=42)
# each step's least bytes over the MLP's param bytes P (f32; the GEMMs at
# M 16 or 32 are bound by reading the weights, not by their FLOPs):
# forward + backward read the weights 3 times (x @ w, dy @ w^T, and dW
# written); Adam reads p, g, m, v and writes p, m, v (7 P); SGD reads p,
# g and writes p (3 P); ZeRO-3 reads the weights once more, in the
# backward's recompute
STEP_BYTES_OVER_P = {"ddp": 3 + 3, "adam": 3 + 7, "zero1": 3 + 7,
                     "zero2": 3 + 7, "zero3": 4 + 7}
# phase 11, the pipeline.  (a) The reference's PP toy at full width (50
# -> 4 x 500 -> 50), batch 64 in 4 microbatches, 16 epochs a leg through
# train.pipeline.run: GPipe and 1F1B at 2 stages, interleaved at 4
# virtual stages on 2 logical devices (V 2) of the one card.  Step 0 of
# each leg against one monolithic Adam step on the same params and batch:
# the loss within rel PIPE_TOY_LOSS_RTOL (the reference's tier,
# tests/test_pipeline.py), every grad leaf that Adam takes within
# relative L2 PIPE_TOY_GRAD_REL_L2 (f32 sums of 4 microbatches against
# one), the params after the step within PIPE_TOY_PARAM_ATOL.  The
# reference's 1e-5 on the params does not hold on an H100 (1.8e-5):
# Adam's first step is lr · g / (|g| + eps), so a grad that cancels to
# within a few eps of zero turns a last-bit difference of the sum into a
# share of lr; any defect that moves an update moves it by ~lr = 1e-3.
# GPipe against 1F1B: the first PIPE_GPIPE_1F1B_EPOCHS epochs' losses
# within rel PIPE_GPIPE_1F1B_RTOL (the reference's law, 3 steps); later
# epochs part, by the same amplification (the two accumulate the
# microbatches' grads in opposite orders)
PIPE_TOY = dict(batch=64, n_micro=4, epochs=16, seed=42, lr=1e-3)
PIPE_TOY_LEGS = (("gpipe", 2), ("1f1b", 2), ("interleaved", 4))
PIPE_TOY_LOSS_RTOL, PIPE_TOY_GRAD_REL_L2 = 1e-5, 1e-5
PIPE_TOY_PARAM_ATOL = 1e-4
PIPE_GPIPE_1F1B_RTOL, PIPE_GPIPE_1F1B_EPOCHS = 1e-6, 3
# the reference's pinned 1F1B clock at 2 stages and 4 microbatches
# (tests/test_pipeline.py; tests/test_torch_pipeline.py holds the port's
# clock to it on the CPU): (tick, stage, op, microbatch)
PIPE_1F1B_TRACE = [
    (0, 0, "fwd", 0), (0, 1, "fwd", 0), (0, 1, "bwd", 0),
    (1, 0, "fwd", 1), (1, 0, "bwd", 0), (1, 1, "fwd", 1), (1, 1, "bwd", 1),
    (2, 0, "fwd", 2), (2, 0, "bwd", 1), (2, 1, "fwd", 2), (2, 1, "bwd", 2),
    (3, 0, "fwd", 3), (3, 0, "bwd", 2), (3, 1, "fwd", 3), (3, 1, "bwd", 3),
    (4, 0, "bwd", 3),
]
# (b) SMOLLM3_3B_L8 at full width (8 layers, flash attention, the
# streamed loss, remat "full", bf16), untied, as 4 stages of 2 layers on
# the one card: seq 256, batch 64 in 4 microbatches (the shapes of
# scripts/_pp_driver.py), 3 epochs each of GPipe and 1F1B
PIPE_LM = dict(model="smollm3-3b-l8", n_stages=4, n_micro=4, batch=64,
               seq=256, epochs=3, seed=42, lr=3e-4, warmup=2)
PIPE_LM_CFG = T.SMOLLM3_3B_L8
# Step-0 parity of the flash pipeline: (i) against one monolithic lm_loss
# step on the same untied params and batch, through the same kernels:
# |loss difference| <= PIPE_MONO_LOSS_ATOL, every grad leaf's relative L2
# error <= PIPE_MONO_GRAD_REL_L2.  The pipeline adds four microbatches'
# bf16 grads where the monolithic step rounds one: on an H100 the loss
# reads 0 and the grads 0.0036-0.0037; a microbatch left out or counted
# twice moves every grad by a quarter.  (ii) Against the same pipeline
# with plain attention (PIPE_PLAIN_LOSS_ATOL, PIPE_PLAIN_GRAD_REL_L2),
# set between the sound kernels' reading (loss 4.0e-5, grads 0.0347)
# and the FA mutants' (chip_gate_mutation.py: PV tile dropped 0.0032 and
# 0.861, dV tile dropped 4.0e-5 and 0.207; PERF.md)
PIPE_MONO_LOSS_ATOL = 1e-4
PIPE_MONO_GRAD_REL_L2 = 0.01
PIPE_PLAIN_LOSS_ATOL = 1e-3
PIPE_PLAIN_GRAD_REL_L2 = 0.07
# the FA backward at a pipeline stage's microbatch (B 16, S 256, 16 / 4
# heads, hd 128), one draw from each seed: each of dQ, dK, dV held to
# the exact f64 gradient (FA.BWD_ORACLE_L2_RATIO), with the module's
# elementwise ratio and block relative L2 against the plain path logged
FA_BWD_PIPE_SEEDS = tuple(range(8))
# phase 12, busbench: every collective at these payloads (MiB), bf16, on
# the one-rank NCCL group
BUSBENCH_MB = (1, 16, 128)
# phase 13, the precision tier on the one-rank NCCL group.  (a) The FSDP
# step with int8 gathers, int8 grad reduce-scatters and int8 Adam
# moments: SMOLLM3_3B_L8 at int8_pallas_bwd (K5 forward, K4 backward),
# flash attention, remat "full", seq 8192, batch 1, 4 steps of
# train_fsdp.run.  Its step 0 against the same step with the plain int8
# products (bit-equal: K5 and K4 are); the flash kernels on the step's
# own layer-0 attention inputs and output grad against the plain
# attention at FA's limits (FA.TOLERANCE, FA.BLOCK_REL_L2, FA.LSE_ATOL);
# and the step against the plain int8 products with plain attention:
# |loss difference| <= PREC_PLAIN_LOSS_ATOL, every grad leaf's relative
# L2 error <= PREC_PLAIN_GRAD_REL_L2.  That last reading is mostly int8
# codes flipped by the attention's last-bit differences: the sound
# kernels read 4.4e-4 and 0.0824, the FA forward dropping a PV tile
# 4.0e-4 and 0.0926 (chip_gate_mutation.py; PERF.md).  The grad limit
# sits between the two; no mutant moves the loss past the sound
# reading, so its limit is the pipeline gate's (PIPE_PLAIN_LOSS_ATOL)
PREC_TRAIN = dict(model="smollm3-3b-l8", precision="int8_pallas_bwd",
                  attention="flash", seq=8192, bs=1, num_steps=4, seed=42)
PREC_CFG = train_fsdp.model_config(PREC_TRAIN["model"],
                                   PREC_TRAIN["precision"],
                                   PREC_TRAIN["attention"])
PREC_PLAIN_LOSS_ATOL = PIPE_PLAIN_LOSS_ATOL
PREC_PLAIN_GRAD_REL_L2 = 0.087
# the FSDP step's Adam (its defaults) for the int8 moments' CPU check
PREC_ADAM = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8)
# (b) the remat policies: the same model at bf16 with flash attention,
# one step after a warm-up under each policy.  save_dots_q8's loss
# within rel REMAT_Q8_LOSS_RTOL of full's (the reference's tier,
# tests/test_quant.py) and at least REMAT_Q8_LOSS_MIN_RTOL from it: the
# sound round-trip reads 3.79e-5, a forward that skips it reads 0
# (chip_gate_mutation.py's dot_q8_skipped; PERF.md).  Its saved bytes
# (peak above the step's start, less full's) at most
# REMAT_Q8_SAVED_RATIO of save_dots': int8 codes and f32 row scales
# read 0.502; keeping the bf16 products, as save_dots does, reads 1.
REMAT = dict(model="smollm3-3b-l8", seq=8192, bs=1, num_steps=1, seed=42)
REMAT_Q8_LOSS_RTOL = 0.02
REMAT_Q8_LOSS_MIN_RTOL = 4e-6
REMAT_Q8_SAVED_RATIO = 0.6
# (c) train.precision_benchmark.run_one at seq 2048, batch 1, 3 steps, for
# each of these precisions (K6 runs in the fp8_pallas row).  Each row's
# step 0 first, on its own inputs: the flash kernels on its layer-0
# attention inputs at FA's limits; int8_pallas_bwd bit-equal to the
# plain int8 products; fp8_pallas K6 on each projection's first operands
# at K6's tolerance (Q.TOLERANCE), and the step against the plain fp8
# recipe (flash attention on both sides): |loss difference| <=
# PREC_BENCH_FP8_LOSS_ATOL, every grad leaf's relative L2 error <=
# PREC_BENCH_FP8_GRAD_REL_L2; then the run's step-0 loss bit-equal to
# the kernel path's.  At S 2048 the sound K6 reads 1.95e-3 and 0.2195
# there, above the fp8 training phase's limits (S 8192: 1.188e-3,
# 0.173): fewer tokens average fewer e4m3/e5m2 code flips.  K6 rounding
# its accumulator to bf16 reads 1.41e-3 and 0.2736 (chip_gate_mutation.py;
# PERF.md): the grad limit sits between; no mutant moves the loss past
# the sound reading, so its limit is an end check
PREC_BENCH = dict(model="smollm3-3b-l8", seq=2048, bs=1, num_steps=3,
                  precisions=("bf16", "int8_pallas_bwd", "fp8_pallas"))
PREC_BENCH_FP8_LOSS_ATOL = 2.5e-3
PREC_BENCH_FP8_GRAD_REL_L2 = 0.24
PREC_BENCH_KEYS = {"model", "precision", "sequence_length", "num_devices",
                   "batch_size", "steps_per_second", "tokens_per_second",
                   "tflops_per_device", "avg_loss", "peak_memory"}
# One decode step's logits through the kernels vs the plain path, from
# one pool state: max |difference| <= LOGIT_ATOL.  The kernels do the
# plain path's operations in another summation order, so a few bf16
# roundings per layer land one ulp apart, and 36 layers of x3 weights
# amplify that.  On an H100 the kernels read 0.89 at max |logit| 35
# (argmax unchanged); a decode kernel that skips the probabilities' bf16
# rounding read 2.81 (one-pass) and 2.13 (``chip_gate_mutation.py``).
# The limit lies between them.
LOGIT_ATOL = 1.5
# The prefill logits through K3 and through the plain gather path (the
# parity phase's chunked prefill of two prompts into fresh pools): max
# |difference| <= PREFILL_LOGIT_ATOL, the max over the serve's first two
# prompts and two prompts from each seed of PARITY_PROMPT_SEEDS.  The
# plain path equals one-shot generate's bit for bit (the same
# arithmetic); K3 differs from it where a normalised probability rounds
# to the neighbouring bf16 value, and 36 layers of x3 weights over up to
# six chunks amplify each such flip: the f64 oracle pushed through the
# same prefill, an attention independent of both, reads as far from the
# plain path.  On an H100 K3 reads 2.0-2.6035 over the five pairs
# (oracle 1.9375-2.625) at max |logit| 31.75-36.0, argmax unchanged; K3
# truncating the probabilities reads 3.5625-5.375, K3 losing each row's
# own key 8.875-12.97 (chip_gate_mutation.py).  The limit lies between.
PREFILL_LOGIT_ATOL = 3.5
# the prefill-logit gate's further prompt pairs: two prompts from each
# seed, of the serve's prompt lengths
PARITY_PROMPT_SEEDS = (SEED + 6, SEED + 7, SEED + 8, SEED + 9)
# The same for int8 serving, through K2 and K4 against the plain int8
# path: K4 is bit-equal to its plain version, so the logits differ only
# where K2 moves a code of the requantised probabilities or a row's
# scale by an ulp (which the bf16 rounding of the attention output has
# absorbed in every run: the sound kernels read 0.0000).  Set between
# that and the mutants' readings: K2 losing each slot's own key 0.6562,
# a rank's partial PV sums 32.875, each block requantising with its own
# absmax 50.5; K4's GEMV losing a split 47.125 (PERF.md).
INT8_LOGIT_ATOL = 0.25


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    """CUDA-event mean of ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=8, replays=20) -> float:
    """Device ms of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, its replays timed by CUDA events (no host launch cost between
    the calls, which a kernel of a few tens of microseconds would
    otherwise measure)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del g
    return ms


def bound(nbytes: float, flops: float,
          peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gate_ratio(got, ref, atol, rtol) -> float:
    """max |got - ref| / (atol + rtol·|ref|): allclose passes iff <= 1."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() / (atol + rtol * r.abs())).max())


# ------------------------------------------------------------ kernel phase

def _pools(gen, n_pages, page, nkv, hd, copies):
    """``copies`` independent K/V pools: timing cycles through them so
    that no launch finds the previous one's pages in the 50 MB L2."""
    def one():
        return torch.randn((n_pages, page, nkv, hd), generator=gen,
                           device="cuda", dtype=CFG.dtype)
    return [(one(), one()) for _ in range(copies)]


def _page_table(rng, last, page, P, n_pages):
    pages = np.zeros((len(last), P), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    used = 0
    for b, a in enumerate(last):
        n = int(a) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    return torch.as_tensor(pages, device="cuda")


def _sdpa_inputs(qg, pk, pv, pages, apos):
    """SDPA operands for the same attention over a gathered view (the
    gather is done here, outside the timed call)."""
    B, S, nkv, rep, hd = qg.shape
    V = pages.shape[1] * pk.shape[1]
    gk = pk[pages.long()].reshape(B, V, nkv, hd).transpose(1, 2)
    gv = pv[pages.long()].reshape(B, V, nkv, hd).transpose(1, 2)
    q = qg.reshape(B, S, nkv * rep, hd).transpose(1, 2)
    mask = (torch.arange(V, device="cuda")[None, None, :]
            <= apos[:, :, None])[:, None]
    return q, gk.contiguous(), gv.contiguous(), mask


def kernel_phase(rng, gen) -> list[dict]:
    """Both kernels at the serve phase's shapes: B = 8 slots, pages of
    16 rows, a 2048-position view, 4 kv heads × 4 query rows, hd 128,
    bf16; apos drawn like the serve phase's prompts."""
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    n_pages, V = B * P + 1, P * page
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    copies = 4
    pools = _pools(gen, n_pages, page, nkv, hd, copies)
    results = []

    # K1 decode: one row per slot somewhere in its 64 decode steps
    dec_apos = plen + rng.integers(0, NEW_TOKENS, size=B)
    # K3 prefill: each slot's final 256-row chunk
    chunk = ENGINE["prefill_chunk"]
    pos = (plen - 1) // chunk * chunk
    pre_apos = pos[:, None] + np.arange(chunk)[None, :]
    specs = [
        ("paged_decode", PA.paged_attention_decode, PA.paged_attention_plain,
         PA, 1, dec_apos[:, None], "distributed_training_sandbox_tpu/ops/"
         "paged_attention.py:104 (paged_attention_decode, _decode_kernel)"),
        ("flash_prefill", FP.paged_flash_prefill,
         FP.paged_flash_prefill_plain, FP, chunk, pre_apos,
         "distributed_training_sandbox_tpu/ops/flash_prefill.py:126 "
         "(paged_flash_prefill, _prefill_kernel)"),
    ]
    for name, fn, plain, mod, S, apos_np, replaces in specs:
        apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
        pages = _page_table(rng, apos_np.max(axis=1), page, P, n_pages)
        qg = torch.randn((B, S, nkv, rep, hd), generator=gen, device="cuda",
                         dtype=CFG.dtype)
        pk, pv = pools[0]
        got = fn(qg, pk, pv, pages, apos)
        torch.cuda.synchronize()
        ref = plain(qg, pk, pv, pages, apos)
        err = float((got - ref).abs().max())
        atol, rtol = mod.TOLERANCE[CFG.dtype]
        check(torch.isfinite(got).all(), f"{name}: non-finite output")
        check(torch.allclose(got, ref, atol=atol, rtol=rtol),
              f"{name}: max |kernel - plain| = {err} over atol {atol} "
              f"rtol {rtol}")

        it = iter(range(10 ** 9))

        def cyc():
            return pools[next(it) % copies]

        # device times from CUDA-graph replays (the calls cycle through
        # the pool copies; a graph replays the same ones), the host-loop
        # time of the kernel beside them
        k_eager = time_ms(lambda: fn(qg, *cyc(), pages, apos))
        k_ms = graph_ms(lambda: fn(qg, *cyc(), pages, apos))
        p_ms = time_ms(lambda: plain(qg, *cyc(), pages, apos), iters=5)
        sd = [_sdpa_inputs(qg, k_, v_, pages, apos) for k_, v_ in pools]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        l_ms = graph_ms(lambda: sdpa(*sd[next(it) % copies][:3],
                                     attn_mask=sd[0][3], enable_gqa=True))

        # work this run's data needs: every visible key row read once,
        # QK and PV over the visible positions of every query row
        vis_rows = np.minimum(apos_np, V - 1) + 1                # (B, S)
        kv_rows = vis_rows.max(axis=1).sum()
        item = qg.element_size()
        nbytes = (qg.numel() * item + kv_rows * nkv * hd * item * 2
                  + got.numel() * 4 + pages.numel() * 4 + apos.numel() * 4)
        flops = float(vis_rows.sum()) * nkv * rep * hd * 4
        b_ms, b_by = bound(nbytes, flops)
        log(f"{name}: max_abs_err {err:.3e} (atol {atol}, rtol {rtol}); "
            f"kernel {k_ms:.5f} ms (graph replays; host loop {k_eager:.5f} "
            f"ms), plain {p_ms:.4f} ms, SDPA {l_ms:.5f} ms (graph), bound "
            f"{b_ms:.6f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        results.append({
            "name": name, "route": "cuda",
            "source": f"distributed_training_sandbox_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms, "eager_ms": k_eager,
            "max_err": err, "kernel_ms": k_ms})
        del sd
    del pools
    torch.cuda.empty_cache()
    k3_draws_reading(FP.paged_flash_prefill)
    return results


def k3_draws(seed, n=COMPARE_DRAWS):
    """``n`` draws of K3's serve shapes (kernel_phase's: 8 slots, each
    slot's final 256-row chunk of a prompt of 256-1536, a 2048 view),
    from ``seed``: four pool copies are drawn and the first is read, then
    each draw's prompt lengths, page table and queries.  The default run
    and ``--parent-csrc`` read the same draws; yields (qg, pk, pv, pages,
    apos)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    chunk = ENGINE["prefill_chunk"]
    pk, pv = _pools(gen, B * P + 1, page, nkv, hd, 4)[0]
    for _ in range(n):
        plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
        apos_np = ((plen - 1) // chunk * chunk)[:, None] + np.arange(chunk)
        pages = _page_table(rng, apos_np.max(axis=1), page, P, B * P + 1)
        qg = torch.randn((B, chunk, nkv, rep, hd), generator=gen,
                         device="cuda", dtype=CFG.dtype)
        yield (qg, pk, pv, pages,
               torch.as_tensor(apos_np.astype(np.int32), device="cuda"))


def k3_draws_reading(kernels, label="flash_prefill", gated=None) -> dict:
    """K3 over ``COMPARE_DRAWS`` draws (:func:`k3_draws`) of each seed of
    ``K3_DRAW_SEEDS``: each kernel of ``kernels`` (one callable, or a
    dict of named ones) and the plain path against the f64 oracle of the
    reference's arithmetic, and each kernel against the plain path; per
    reading the max |difference| over a seed's draws and the count of
    outputs off by more than atol / 4.  Every output where |kernel -
    plain| passes atol is logged with |plain - oracle| and |kernel -
    oracle| there.  Gates each seed's count of ``|kernel - plain|`` at
    ``FP.DRAW_COUNT_LIMIT`` (the one-draw atol stays kernel_phase's), and
    the kernel's count against the oracle, summed over the seeds, at
    ``FP.ORACLE_COUNT_RATIO`` times the plain path's; ``gated`` names
    the kernels held to the ratio (all by default), the others log it."""
    kernels = kernels if isinstance(kernels, dict) else {label: kernels}
    gated = set(kernels) if gated is None else set(gated)
    atol = FP.TOLERANCE[CFG.dtype][0]
    th = atol / 4
    res = {}
    # outputs off the oracle by more than atol / 4, summed over the seeds
    vs_oracle = {n: 0 for n in [*kernels, "plain"]}
    for seed in K3_DRAW_SEEDS:
        read = {f"{n} - {r}": [0.0, 0] for n in kernels
                for r in ("oracle", "plain")}
        read["plain - oracle"] = [0.0, 0]
        # where |kernel - plain| > atol: (draw, index, kernel - plain,
        # plain - oracle, kernel - oracle)
        over = {n: [] for n in kernels}
        for d, (qg, pk, pv, pages, apos) in enumerate(k3_draws(seed)):
            orc = FP.paged_flash_prefill_oracle(qg, pk, pv, pages, apos)
            ref = FP.paged_flash_prefill_plain(qg, pk, pv, pages, apos)
            outs = {n: fn(qg, pk, pv, pages, apos)
                    for n, fn in kernels.items()}
            torch.cuda.synchronize()
            pairs = [("plain - oracle", ref, orc)]
            for n, got in outs.items():
                pairs += [(f"{n} - oracle", got, orc),
                          (f"{n} - plain", got, ref)]
                kp = got.double() - ref.double()
                for i in (kp.abs() > atol).nonzero()[:16].tolist():
                    i = tuple(i)
                    over[n].append([d, list(i), float(kp[i]),
                                    float(ref[i].double() - orc[i]),
                                    float(got[i].double() - orc[i])])
            for key, a, b in pairs:
                read[key][0] = max(read[key][0], float(
                    (a.double() - b.double()).abs().max()))
                read[key][1] += FP.off_count(a, b, th)
            del orc, ref, outs
        torch.cuda.empty_cache()
        log(f"{label} over {COMPARE_DRAWS} draws of seed {seed}, (max "
            f"|difference|, outputs off by > {th}): {json.dumps(read)}; "
            f"outputs where |kernel - plain| > {atol}, as [draw, index, "
            f"kernel - plain, plain - oracle, kernel - oracle]: "
            f"{json.dumps(over)}")
        vs_oracle["plain"] += read["plain - oracle"][1]
        for n in kernels:
            vs_oracle[n] += read[f"{n} - oracle"][1]
            cnt = read[f"{n} - plain"][1]
            check(cnt <= FP.DRAW_COUNT_LIMIT,
                  f"{n} draws: {cnt} outputs off the plain path by more "
                  f"than {th} over {COMPARE_DRAWS} draws of seed {seed}, "
                  f"above {FP.DRAW_COUNT_LIMIT}")
        res[f"seed {seed}"] = {"readings": read, "over_atol": over}
    ratios = {n: vs_oracle[n] / max(vs_oracle["plain"], 1) for n in kernels}
    log(f"{label} over the seeds {list(K3_DRAW_SEEDS)}: outputs off the "
        f"oracle by > {th} {json.dumps(vs_oracle)}; each kernel's count over"
        f" the plain path's {json.dumps(ratios)} (limit "
        f"{FP.ORACLE_COUNT_RATIO} for {sorted(gated)})")
    for n in sorted(gated):
        check(ratios[n] <= FP.ORACLE_COUNT_RATIO,
              f"{n} oracle: {vs_oracle[n]} outputs off the f64 oracle by "
              f"more than {th}, {ratios[n]:.3f} times the plain path's "
              f"{vs_oracle['plain']}, above {FP.ORACLE_COUNT_RATIO}")
    res["oracle_counts"], res["oracle_ratio"] = vs_oracle, ratios
    return res


def _q8_pools(gen, n_pages, page, nkv, hd, copies):
    """``copies`` int8 pools quantised per row from random bf16 K/V rows
    (codes and f32 scales, as the engine writes them)."""
    def one():
        return Q.quantize_int8(torch.randn((n_pages, page, nkv, hd),
                                           generator=gen, device="cuda"))
    return [(*one(), *one()) for _ in range(copies)]   # kq, ks, vq, vs


def _q8_decode_inputs(rng, gen, copies=4):
    """K2's inputs at the int8 serve phase's shapes: B = 8 slots, pages
    of 16 rows, a 2048-position view, 4 kv heads × 4 query rows, hd 128,
    int8 codes with f32 row scales; apos drawn like the serve phase's.
    Returns (qq, qs, pools, pages, apos, apos_np), ``copies`` pools."""
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    n_pages = B * P + 1
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    apos_np = (plen + rng.integers(0, NEW_TOKENS, size=B))[:, None]
    apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
    pages = _page_table(rng, apos_np.max(axis=1), page, P, n_pages)
    pools = _q8_pools(gen, n_pages, page, nkv, hd, copies)
    qq, qs = Q.quantize_int8(torch.randn((B, 1, nkv, rep, hd), generator=gen,
                                         device="cuda"))
    return qq, qs, pools, pages, apos, apos_np


def _q8_reading(name, got, ref) -> tuple[float, float]:
    """K2's output against its plain version's: logged (with the count of
    outputs that differ at all) and gated at ``PA.TOLERANCE_Q8``;
    returns (max |difference|, gate ratio)."""
    atol, rtol = PA.TOLERANCE_Q8
    err, ratio = float((got - ref).abs().max()), gate_ratio(got, ref, atol,
                                                            rtol)
    n_diff = int((got != ref).sum())
    # an f32 ulp of a row's scale moves every output of the row by about
    # an ulp; a moved code moves one output by a step of sc · |v|
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    log(f"{name}: max_abs_err {err:.3e}, gate ratio {ratio:.4f} (atol "
        f"{atol}, rtol {rtol}); {n_diff} of {got.numel()} outputs differ, "
        f"by at most {rel:.3e} of |plain|; max |plain| "
        f"{float(ref.abs().max()):.4f}")
    check(torch.isfinite(got).all(), f"{name}: non-finite output")
    check(ratio <= 1.0, f"{name}: max |kernel - plain| = {err} over atol "
          f"{atol} rtol {rtol} (gate ratio {ratio:.3f})")
    return err, ratio


def q8_decode_phase(rng, gen) -> dict:
    """K2 at the int8 serve phase's shapes (:func:`_q8_decode_inputs`):
    against its plain version, twice bit-equal, then timed in CUDA-graph
    replays and in a host loop, beside SDPA over the dequantised view
    timed both ways."""
    qq, qs, pools, pages, apos, apos_np = _q8_decode_inputs(rng, gen)
    copies = len(pools)
    V = pages.shape[1] * ENGINE["page_size"]
    nkv, rep, hd = qq.shape[2:]

    def kernel(kq, ks, vq, vs):
        return PA.paged_attention_decode(qq, kq, vq, pages, apos, q_scale=qs,
                                         pk_s=ks, pv_s=vs)

    def plain(kq, ks, vq, vs):
        return PA.paged_attention_plain_q8(qq, qs, kq, vq, ks, vs, pages, apos)

    got = kernel(*pools[0])
    torch.cuda.synchronize()
    err, ratio = _q8_reading("paged_decode_q8", got, plain(*pools[0]))
    _twice_equal("paged_decode_q8", lambda: kernel(*pools[0]))

    it = iter(range(10 ** 9))

    def cyc():
        return pools[next(it) % copies]

    # graph replays: a host loop times the launch of a kernel of a few
    # tens of microseconds, not the kernel
    k_ms = graph_ms(lambda: kernel(*cyc()))
    k_eager = time_ms(lambda: kernel(*cyc()))
    p_ms = time_ms(lambda: plain(*cyc()), iters=5)
    # the yardstick: SDPA over the dequantised gathered view (dequantised
    # and gathered outside the timed call)
    qd = (qq.float() * qs).to(CFG.dtype)
    sd = [_sdpa_inputs(qd, (kq.float() * ks).to(CFG.dtype),
                       (vq.float() * vs).to(CFG.dtype), pages, apos)
          for kq, ks, vq, vs in pools]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            *sd[next(it) % copies][:3], attn_mask=sd[0][3], enable_gqa=True)

    l_ms = graph_ms(sdpa)
    l_eager = time_ms(sdpa)
    del sd, pools
    torch.cuda.empty_cache()
    # what this run's data needs: every visible K and V row (codes and
    # scale) read once, the int8 q rows and scales, the f32 output;
    # QK and PV over the visible positions as int8 operations
    vis_rows = np.minimum(apos_np, V - 1) + 1
    kv_rows = int(vis_rows.sum())
    nbytes = (qq.numel() + qs.numel() * 4 + kv_rows * nkv * (hd + 4) * 2
              + got.numel() * 4 + pages.numel() * 4 + apos.numel() * 4)
    ops = float(kv_rows) * nkv * rep * hd * 4
    b_ms, b_by = bound(nbytes, ops, PEAK_INT8_OPS)
    log(f"paged_decode_q8: kernel {k_ms:.5f} ms (graph replays; host loop "
        f"{k_eager:.5f} ms), plain {p_ms:.4f} ms, SDPA (dequantised view) "
        f"{l_ms:.5f} ms (graph; host loop {l_eager:.5f} ms), bound "
        f"{b_ms:.6f} ms by {b_by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} G "
        f"int8 operations)")
    entry = _entry("paged_decode_q8", "paged_decode_q8.cu",
                   "distributed_training_sandbox_tpu/ops/paged_attention.py"
                   ":140 (paged_attention_decode int8 branch, "
                   "_decode_kernel_q8 :75)", err, ratio, k_ms, p_ms, l_ms,
                   b_ms, b_by)
    entry.update(eager_ms=k_eager, library_eager_ms=l_eager)
    return entry


# ------------------------------------------------------------- serve phase

def build_params():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(CFG, gen, "cuda")
    for leaf in [params["embed"], params["final_norm"],
                 *params["layers"].values()]:
        leaf.mul_(PARAM_SCALE)
    return params


def serve_phase(params, rng, card: str):
    prompts = [rng.integers(1, CFG.vocab_size,
                            size=int(rng.integers(PROMPT_LEN[0],
                                                  PROMPT_LEN[1] + 1))
                            ).astype(np.int32) for _ in range(N_REQUESTS)]
    eng = E.ServingEngine(params, CFG, **ENGINE)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.COUNTS.reset()
    FP.COUNTS.reset()
    eng.run()
    torch.cuda.synchronize()
    counts = {"paged_decode": (PA.COUNTS.launches, PA.COUNTS.plain_calls),
              "flash_prefill": (FP.COUNTS.launches, FP.COUNTS.plain_calls)}
    L = CFG.num_hidden_layers
    steps, chunks = eng.stats["decode_steps"], eng.stats["prefill_chunks"]
    for r in reqs:
        check(len(r.tokens) == NEW_TOKENS,
              f"request {r.rid}: {len(r.tokens)} tokens, not {NEW_TOKENS}")
        check(all(0 <= t < CFG.vocab_size for t in r.tokens),
              f"request {r.rid}: token out of the vocabulary")
    check(counts["paged_decode"] == (steps * L, 0),
          f"paged_decode (launches, plain) {counts['paged_decode']} != "
          f"({steps} decode steps x {L} layers, 0)")
    check(counts["flash_prefill"] == (chunks * L, 0),
          f"flash_prefill (launches, plain) {counts['flash_prefill']} != "
          f"({chunks} prefill chunks x {L} layers, 0)")
    slo = eng.slo_report()
    log(f"serve on {card}: {slo['completed']}/{N_REQUESTS} requests, "
        f"{steps} decode steps, {chunks} prefill chunks; TTFT p50 "
        f"{slo['ttft_ms']['p50']} ms p99 {slo['ttft_ms']['p99']} ms, "
        f"per-token p50 {slo['per_token_ms']['p50']} ms, "
        f"{slo['tokens_per_s']} tok/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"serve scheduler: {json.dumps(slo['scheduler'])}")
    # the least a decode step could take: every weight byte and the KV
    # rows of the active slots read once (the mean context of the run)
    ctx = np.mean([r.n_prompt + NEW_TOKENS / 2 for r in reqs])
    step_bytes = (weight_read_bytes(CFG, params, tree_bytes(params))
                  + kv_bytes_per_step(CFG, N_REQUESTS, int(ctx)))
    log(f"decode step: {slo['scheduler']['decode_ms_total'] / steps:.3f} ms"
        f" on the host clock, bound {step_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms by bytes ({step_bytes / 1e9:.3f} GB: weights + KV of "
        f"{N_REQUESTS} slots at mean context {ctx:.0f})")
    return eng, reqs, {k: v[0] for k, v in counts.items()}


# ------------------------------------------------------------ parity phase

def _prefill(reqs, eng, flash: bool):
    """Chunked prefill of ``reqs`` (one row each) into a fresh pool, the
    engine's way; returns the pool, the page table and each row's f32
    logits at its last prompt position (B, vocab)."""
    page, P, Ck = eng.page_size, eng.pages_per_request, eng.prefill_chunk
    B = len(reqs)
    pool = PagedKVPool(eng.cfg, B * P + 1, page, kv_quant=eng.kv_quant,
                       device="cuda")
    pages = torch.arange(1, B * P + 1, dtype=torch.int32,
                         device="cuda").reshape(B, P)
    plen = np.array([r.n_prompt for r in reqs], np.int32)
    plen_d = torch.as_tensor(plen, device="cuda")
    logits = None
    for pos in range(0, int(plen.max()), Ck):
        ids = np.zeros((B, Ck), np.int32)
        for i, r in enumerate(reqs):
            ids[i, :len(r.prompt[pos:pos + Ck])] = r.prompt[pos:pos + Ck]
        apos = pos + torch.arange(Ck, dtype=torch.int32,
                                  device="cuda")[None, :].repeat(B, 1)
        with torch.no_grad():
            x = E._paged_forward(eng._params,
                                 torch.as_tensor(ids, device="cuda"),
                                 eng.cfg, pool.bufs, pages, apos,
                                 apos < plen_d[:, None],
                                 flash_prefill=flash)
            last = torch.as_tensor(np.clip(plen - 1 - pos, 0, Ck - 1),
                                   device="cuda").long()
            lg = E._last_logits(eng._params,
                                x[torch.arange(B, device="cuda"), last][:, None],
                                eng.cfg)
        # a row's logits count only in the chunk holding its last position
        ends = torch.as_tensor((pos < plen) & (plen <= pos + Ck),
                               device="cuda")[:, None]
        logits = lg if logits is None else torch.where(ends, lg, logits)
    return pool, pages, logits


@contextlib.contextmanager
def _oracle_prefill():
    """The engine's flash prefill through K3's f64 oracle of the
    reference's arithmetic, rounded to f32 as K3 returns it (uncounted):
    a second attention that sums in another order than the plain path,
    independent of K3."""
    saved = E.paged_flash_prefill
    E.paged_flash_prefill = \
        lambda *a: FP.paged_flash_prefill_oracle(*a).float()
    try:
        yield
    finally:
        E.paged_flash_prefill = saved


def _prefill_logit_readings(pair, eng):
    """The prefill logits of ``pair`` through K3, the plain gather path
    and the oracle (:func:`_oracle_prefill`): the readings (max |K3 -
    plain|, |oracle - plain|, |K3 - oracle|, max |logit|) and K3's pool,
    page table and logits, and the plain path's logits."""
    pool, pages, lg_k = _prefill(pair, eng, flash=True)
    _, _, lg_p = _prefill(pair, eng, flash=False)
    with _oracle_prefill():
        _, _, lg_o = _prefill(pair, eng, flash=True)
    d = lambda a, b: float((a - b).abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (lg_k, lg_p, lg_o))
    read = {"kernel - plain": d(lg_k, lg_p), "oracle - plain": d(lg_o, lg_p),
            "kernel - oracle": d(lg_k, lg_o),
            "max |logit|": float(lg_p.abs().max()), "finite": finite}
    return read, pool, pages, lg_k, lg_p


def _pool_tensors(pool):
    b = pool.bufs
    return [*b.k, *b.v, *(b.k_scale or ()), *(b.v_scale or ())]


def _decode_step_logits(eng, pool, pages, toks, lengths, kernel: bool):
    """One decode step from the pool's current state, restored after."""
    snapshot = [t.clone() for t in _pool_tensors(pool)]
    with torch.no_grad():
        x = E._paged_forward(eng._params, toks[:, None], eng.cfg, pool.bufs,
                             pages, lengths[:, None],
                             torch.ones_like(toks[:, None], dtype=torch.bool),
                             paged_kernel=kernel)
        out = E._last_logits(eng._params, x, eng.cfg)
    for t, s in zip(_pool_tensors(pool), snapshot):
        t.copy_(s)
    return out


def _gap(logits):
    top = torch.topk(logits, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def parity_phase(params, reqs, eng):
    """One-shot ``generate`` against the engine, and the kernels against
    the plain path from one state.  Everything is logged first; the
    gates follow."""
    pair = reqs[:2]
    failures = []
    gen_first = []
    for r in pair:
        ref = generate(params, r.prompt[None], CFG,
                       max_new_tokens=NEW_TOKENS,
                       cache_capacity=eng.view_capacity)[0].tolist()
        gen_first.append(ref[0])
        same = sum(a == b for a, b in zip(r.tokens, ref))
        prefix = next((i for i, (a, b) in enumerate(zip(r.tokens, ref))
                       if a != b), len(ref))
        log(f"parity rid {r.rid}: {same}/{len(ref)} tokens agree with "
            f"one-shot generate, first {prefix} in a row")
        if r.tokens[0] != ref[0]:
            failures.append(f"request {r.rid}: first token {r.tokens[0]} "
                            f"!= one-shot generate's {ref[0]}")
    cache_logits = []
    for r in pair:
        cache = init_cache(CFG, 1, eng.view_capacity, device="cuda")
        with torch.no_grad():
            lg, _ = _forward_cached(params, torch.as_tensor(
                r.prompt[None], device="cuda").long(), CFG, cache, 0)
        cache_logits.append(lg[0])
    lg_gen = torch.stack(cache_logits)
    read, pool, pages, lg_k, lg_p = _prefill_logit_readings(pair, eng)
    d = lambda a, b: float((a - b).abs().max())
    log(f"parity prefill logits: |kernel - plain| "
        f"{read['kernel - plain']:.4f}, |oracle - plain| "
        f"{read['oracle - plain']:.4f}, |kernel - oracle| "
        f"{read['kernel - oracle']:.4f}, |kernel - generate| "
        f"{d(lg_k, lg_gen):.4f}, |plain - generate| {d(lg_p, lg_gen):.4f}"
        f"; max |logit| {read['max |logit|']:.2f}; top1-top2 gap "
        f"(generate) {_gap(lg_gen)}; argmax kernel "
        f"{lg_k.argmax(-1).tolist()} plain {lg_p.argmax(-1).tolist()} "
        f"generate {lg_gen.argmax(-1).tolist()} engine "
        f"{[r.tokens[0] for r in pair]}")
    reads = {"serve": read}
    for seed in PARITY_PROMPT_SEEDS:
        prng = np.random.default_rng(seed)
        prompts = [prng.integers(1, CFG.vocab_size, size=int(prng.integers(
            PROMPT_LEN[0], PROMPT_LEN[1] + 1))).astype(np.int32)
            for _ in range(2)]
        reads[f"seed {seed}"] = _prefill_logit_readings(
            [types.SimpleNamespace(prompt=p, n_prompt=len(p))
             for p in prompts], eng)[0]
        torch.cuda.empty_cache()
    log(f"parity prefill logits by prompt pair (the serve's first two, "
        f"then two prompts from each seed): {json.dumps(reads)}")
    pre_err = max(r["kernel - plain"] for r in reads.values())
    if not all(r["finite"] for r in reads.values()):
        failures.append("non-finite prefill logits")
    if not pre_err <= PREFILL_LOGIT_ATOL:
        failures.append(f"prefill logits kernel vs plain: max abs diff "
                        f"{pre_err} over atol {PREFILL_LOGIT_ATOL} (max "
                        f"over the prompt pairs)")
    toks = lg_k.argmax(-1).to(torch.int32)
    lengths = torch.as_tensor([r.n_prompt for r in pair], dtype=torch.int32,
                              device="cuda")
    lk = _decode_step_logits(eng, pool, pages, toks, lengths, True)
    lp = _decode_step_logits(eng, pool, pages, toks, lengths, False)
    err, scale = d(lk, lp), float(lp.abs().max())
    log(f"parity decode logits kernel vs plain: max abs diff {err:.4f}, "
        f"max |logit| {scale:.2f}, atol {LOGIT_ATOL}, argmax equal "
        f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}, top1-top2 gap "
        f"(plain) {_gap(lp)}")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        failures.append("non-finite decode logits")
    if not torch.allclose(lk, lp, atol=LOGIT_ATOL, rtol=0.0):
        failures.append(f"decode logits kernel vs plain: max abs diff "
                        f"{err} over atol {LOGIT_ATOL}")
    check(not failures, "; ".join(failures))


def profile_phase(params, rng, engine=None, label="serve",
                  window=None) -> None:
    """A second serve run of the same shape under ``torch.profiler``
    (default: the bf16 serve's ``ENGINE``): the device's busy share of
    the run's wall time and the kernels that take it.  ``window =
    (first, n)`` profiles scheduler rounds first .. first + n - 1 only
    (each a prefill chunk or two and a decode burst): the int8 run
    launches ~50 000 kernels, whose trace takes minutes to post-process.
    It comes after every gate, so profiler overhead touches none of the
    gated numbers; it reports and gates nothing."""
    from torch.profiler import ProfilerActivity, profile
    eng = E.ServingEngine(params, CFG, **(engine or ENGINE))
    for _ in range(N_REQUESTS):
        n = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        eng.submit(rng.integers(1, CFG.vocab_size, size=n).astype(np.int32),
                   max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    # device activity only: tracing every CPU operator as well doubles
    # the run's wall time and takes minutes to post-process
    prof = profile(activities=[ProfilerActivity.CUDA])
    if window is None:
        with prof:
            t = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    else:
        # run()'s loop with every request arriving at t = 0
        first, n = window
        eng.start()
        for req in eng._pending:
            eng.batcher.submit(req, 0.0)
        eng._pending = []
        i = 0
        while eng.batcher.has_work():
            if i == first:
                torch.cuda.synchronize()
                prof.start()
                t = time.perf_counter()
            eng.step_round(time.perf_counter() - eng._t0)
            if i == first + n - 1:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t) * 1e6
                prof.stop()
            i += 1
        eng.close_pump()
        if i < first + n:
            check(False, f"profile ({label}): the run took {i} rounds, "
                  f"fewer than the window's {first + n}")
            return
        label += f", rounds {first}-{first + n - 1}"
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(d for _, _, d in dev)
    if not dev:
        log(f"profile ({label}): torch.profiler recorded no device time "
            f"(not measured)")
        return
    log(f"profile ({label} run under torch.profiler): device busy "
        f"{busy_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall = "
        f"{busy_us / wall_us:.3f}; idle share {1 - busy_us / wall_us:.3f}")
    for key, count, d in sorted(dev, key=lambda e: -e[2])[:8]:
        log(f"profile ({label}): {d / busy_us:.3f} of device time, {count} "
            f"calls, {d / 1e3:.1f} ms: {key[:90]}")


DECODE_PROFILE_STEPS = 8


# the paged decode kernels' names in a profile (K1's, K2's, and the
# four passes of K2's first design)
PAGED_DECODE_KERNELS = "(anonymous namespace)::decode_"


def decode_step_profile(eng, reqs, label, flash: bool) -> dict:
    """The device time of one decode step at the serve's shape: every
    request of the serve prefilled into a fresh pool (the engine's way),
    then ``DECODE_PROFILE_STEPS`` steps of the engine's ``_decode_core``
    over all its slots under ``torch.profiler`` (device activity): the
    device's busy time a step beside the step's host clock, the kernels
    that take it, and the paged decode attention's share
    (``PAGED_DECODE_KERNELS``).  Reports and gates nothing."""
    from torch.profiler import ProfilerActivity, profile
    pool, pages, lg = _prefill(reqs, eng, flash=flash)
    toks = lg.argmax(-1).to(torch.int32)
    lengths = torch.as_tensor([r.n_prompt for r in reqs], dtype=torch.int32,
                              device="cuda")
    stop = lengths + DECODE_PROFILE_STEPS + 1
    active = torch.ones_like(toks, dtype=torch.bool)
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(DECODE_PROFILE_STEPS):
            toks, lengths, active, _ = E._decode_core(
                pool.bufs, eng._params, pages, toks, lengths, stop, active,
                cfg=eng.cfg, paged_kernel=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / DECODE_PROFILE_STEPS
    dev = sorted(((e.key, e.count, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda e: -e[2])
    busy_ms = sum(d for _, _, d in dev) / 1e3 / DECODE_PROFILE_STEPS
    log(f"decode step profile ({label}, {len(reqs)} slots, "
        f"{DECODE_PROFILE_STEPS} steps): device busy {busy_ms:.3f} ms a "
        f"step, host clock {wall_ms:.3f} ms a step")
    for key, count, d in dev[:5]:
        step_ms = d / 1e3 / DECODE_PROFILE_STEPS
        log(f"decode step profile ({label}): {step_ms:.4f} ms a step, "
            f"{count} calls: {key[:90]}")
    attn_ms = sum(d for key, _, d in dev if PAGED_DECODE_KERNELS in key) \
        / 1e3 / DECODE_PROFILE_STEPS
    log(f"decode step profile ({label}): the paged decode attention's "
        f"kernels {attn_ms:.4f} ms a step")
    del pool
    return {"device_busy_ms": busy_ms, "host_ms": wall_ms,
            "paged_decode_ms": attn_ms}


# ------------------------------------------------------ int8 serve phases

def int8_serve_phase(params_q8, rng, card: str):
    """The int8 engine (int8 weights, int8 pool, K2 decode, K4 for every
    projection and the unembedding) answers 8 requests."""
    prompts = [rng.integers(1, CFG.vocab_size,
                            size=int(rng.integers(PROMPT_LEN[0],
                                                  PROMPT_LEN[1] + 1))
                            ).astype(np.int32) for _ in range(N_REQUESTS)]
    eng = E.ServingEngine(params_q8, CFG, **INT8_ENGINE)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (PA.Q8_COUNTS, Q.INT8_COUNTS, Q.INT8_FUSED_COUNTS, PA.COUNTS,
                FP.COUNTS)
    for c in counters:
        c.reset()
    eng.run()
    torch.cuda.synchronize()
    counts = {"paged_decode_q8": (PA.Q8_COUNTS.launches,
                                  PA.Q8_COUNTS.plain_calls),
              "int8_matmul": (Q.INT8_COUNTS.launches,
                              Q.INT8_COUNTS.plain_calls)}
    L = CFG.num_hidden_layers
    steps, chunks = eng.stats["decode_steps"], eng.stats["prefill_chunks"]
    want = {"paged_decode_q8": steps * L,
            "int8_matmul": (steps + chunks) * (len(PROJECTIONS) * L + 1)}
    log(f"int8 serve launches (kernel, plain): {json.dumps(counts)}; "
        f"expected kernel launches {json.dumps(want)} ({steps} decode steps,"
        f" {chunks} prefill chunks); K1 {PA.COUNTS.launches}, K3 "
        f"{FP.COUNTS.launches}, K5 {Q.INT8_FUSED_COUNTS.launches}")
    for r in reqs:
        check(len(r.tokens) == NEW_TOKENS,
              f"int8 request {r.rid}: {len(r.tokens)} tokens, not "
              f"{NEW_TOKENS}")
        check(all(0 <= t < CFG.vocab_size for t in r.tokens),
              f"int8 request {r.rid}: token out of the vocabulary")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"int8 serve: {name} (launches, plain) {(launches, plain)} != "
              f"({want[name]}, 0)")
    slo = eng.slo_report()
    log(f"int8 serve on {card}: {slo['completed']}/{N_REQUESTS} requests, "
        f"{steps} decode steps, {chunks} prefill chunks; TTFT p50 "
        f"{slo['ttft_ms']['p50']} ms p99 {slo['ttft_ms']['p99']} ms, "
        f"per-token p50 {slo['per_token_ms']['p50']} ms, "
        f"{slo['tokens_per_s']} tok/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, pool "
        f"prediction {slo['pool']['predicted_gb']:.3f} GiB")
    log(f"int8 serve scheduler: {json.dumps(slo['scheduler'])}")
    ctx = np.mean([r.n_prompt + NEW_TOKENS / 2 for r in reqs])
    w_bytes = weight_read_bytes(CFG, params_q8, tree_bytes(params_q8))
    kv_bytes = kv_bytes_per_step(CFG, N_REQUESTS, int(ctx), kv_quant=True)
    step_bytes = w_bytes + kv_bytes
    log(f"int8 decode step: {slo['scheduler']['decode_ms_total'] / steps:.3f}"
        f" ms on the host clock, bound {step_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms by bytes ({w_bytes / 1e9:.3f} GB of weights + "
        f"{kv_bytes / 1e9:.3f} GB of int8 KV of {N_REQUESTS} slots at mean "
        f"context {ctx:.0f})")
    return eng, reqs, {k: v[0] for k, v in counts.items()}


def int8_parity_phase(params_q8, reqs, eng):
    """Every request's first token against the port's one-shot
    ``generate(kv_quant=True)`` at the view capacity, and one decode
    step's logits through K2 and K4 against the plain int8 path from one
    pool state.  Everything is logged first; the gates follow."""
    failures = []
    firsts = []
    for r in reqs:
        ref = int(generate(params_q8, r.prompt[None], CFG, max_new_tokens=1,
                           cache_capacity=eng.view_capacity,
                           kv_quant=True)[0, 0])
        firsts.append((r.tokens[0], ref))
        if r.tokens[0] != ref:
            failures.append(f"int8 request {r.rid}: first token "
                            f"{r.tokens[0]} != one-shot generate's {ref}")
    log(f"int8 parity: first tokens (engine, generate) {firsts}; "
        f"{sum(a == b for a, b in firsts)}/{len(firsts)} equal")
    pair = reqs[:2]
    pool, pages, lg = _prefill(pair, eng, flash=False)
    toks = lg.argmax(-1).to(torch.int32)
    lengths = torch.as_tensor([r.n_prompt for r in pair], dtype=torch.int32,
                              device="cuda")
    lk = _decode_step_logits(eng, pool, pages, toks, lengths, True)
    with Q.plain_int8_products():
        lp = _decode_step_logits(eng, pool, pages, toks, lengths, False)
    err, scale = float((lk - lp).abs().max()), float(lp.abs().max())
    log(f"int8 parity decode logits kernel vs plain: max abs diff {err:.4f},"
        f" max |logit| {scale:.2f}, atol {INT8_LOGIT_ATOL}, argmax equal "
        f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}, top1-top2 gap "
        f"(plain) {_gap(lp)}")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        failures.append("non-finite int8 decode logits")
    if not torch.allclose(lk, lp, atol=INT8_LOGIT_ATOL, rtol=0.0):
        failures.append(f"int8 decode logits kernel vs plain: max abs diff "
                        f"{err} over atol {INT8_LOGIT_ATOL}")
    del pool
    check(not failures, "; ".join(failures))


# ------------------------------------------------- training kernel phase

def _twice_equal(name, fn):
    """Launch ``fn`` twice on the same inputs; the results must be bit
    for bit equal (no float atomics: remat's recompute repeats)."""
    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{name}: two launches on the same inputs differ")


def _entry(name, source, replaces, err, ratio, k_ms, p_ms, l_ms, b_ms,
           b_by):
    return {"name": name, "route": "cuda",
            "source": f"distributed_training_sandbox_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "gate_ratio": ratio, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "max_err": err, "kernel_ms": k_ms}


def fp8_phase() -> dict:
    """K6 at one layer's seven projections (M = 8192): each against the
    plain version, then times summed over the seven.  Operands cycle
    through 3 copies so that no launch finds the last one's in L2."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    M = TRAIN["seq"] * TRAIN["bs"]
    atol, rtol = Q.TOLERANCE[torch.bfloat16]

    def k6(aq, a_s, bt, b_s):
        return Q.fp8_matmul_kernel(aq, a_s, bt, b_s)

    tot = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, flops=0.0)
    err = ratio = 0.0
    times = {}
    for name, K, N in PROJECTIONS:
        if (K, N) not in times:
            ops = []
            for _ in range(3):
                x = torch.randn((M, K), generator=gen, device="cuda").to(
                    torch.bfloat16)
                w = (torch.randn((K, N), generator=gen, device="cuda")
                     * 0.02).to(torch.bfloat16)
                # the weight's codes K-major, as the training path
                # quantises them
                ops.append((*Q.quantize_fp8(x), *Q.quantize_fp8_kmajor(w)))
            aq, a_s, bt, b_s = ops[0]
            got = k6(aq, a_s, bt, b_s)
            ref = Q.fp8_matmul(aq, a_s, bt.t(), b_s, torch.bfloat16)
            e = float((got.float() - ref.float()).abs().max())
            r = gate_ratio(got, ref, atol, rtol)
            _twice_equal("fp8_matmul", lambda: k6(aq, a_s, bt, b_s))
            check(torch.isfinite(got).all(), "fp8_matmul: non-finite output")
            check(r <= 1.0, f"fp8_matmul: ({M}, {K}) x ({K}, {N}) max |kernel"
                  f" - plain| = {e} over atol {atol} rtol {rtol} (gate "
                  f"ratio {r:.3f})")
            it = iter(range(10 ** 9))
            cyc = lambda: ops[next(it) % len(ops)]
            k_ms = time_ms(lambda: k6(*cyc()))
            p_ms = time_ms(lambda: (lambda a, sa, b, sb: Q.fp8_matmul(
                a, sa, b.t(), sb, torch.bfloat16))(*cyc()), iters=5)
            # the library's layout, B column-major, is the K-major codes'
            # transposed view
            l_ms = time_ms(lambda: (lambda a, sa, b, sb: torch._scaled_mm(
                a, b.t(), sa, sb, out_dtype=torch.bfloat16))(*cyc()))
            del ops, got, ref
            times[(K, N)] = (k_ms, p_ms, l_ms, e, r)
            log(f"fp8_matmul ({M}, {K}) x ({K}, {N}): max_abs_err {e:.3e}, "
                f"gate ratio {r:.4f} (atol {atol}, rtol {rtol}); kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, _scaled_mm {l_ms:.4f} "
                f"ms")
        k_ms, p_ms, l_ms, e, r = times[(K, N)]
        err, ratio = max(err, e), max(ratio, r)
        tot["k"] += k_ms
        tot["p"] += p_ms
        tot["l"] += l_ms
        # fp8 operands read once, bf16 output written once (the weight
        # arrives K-major: no copy)
        tot["nbytes"] += M * K + K * N + 2 * M * N
        tot["flops"] += 2 * M * K * N
    b_ms, b_by = bound(tot["nbytes"], tot["flops"], PEAK_FP8_FLOPS)
    log(f"fp8_matmul, one layer's 7 projections: kernel {tot['k']:.4f} ms, "
        f"plain {tot['p']:.4f} ms, _scaled_mm {tot['l']:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({tot['nbytes'] / 1e6:.1f} MB, "
        f"{tot['flops'] / 1e12:.3f} TFLOP at fp8)")
    torch.cuda.empty_cache()
    return _entry("fp8_matmul", "fp8_matmul.cu",
                  "distributed_training_sandbox_tpu/ops/quant.py:613 "
                  "(fp8_matmul_pallas, _fp8_mm_kernel)", err, ratio,
                  tot["k"], tot["p"], tot["l"], b_ms, b_by)


def _int_mm_ms(a, b_kn, it, copies, timer=time_ms):
    """CUDA-event ms of ``torch._int_mm`` (int32 out, no scales) on
    row-major A and column-major B, cycling through ``copies``; None
    where its shape rules refuse (M must exceed 16)."""
    try:
        torch._int_mm(a[0], b_kn[0])
    except RuntimeError as e:
        log(f"torch._int_mm refuses ({a[0].shape[0]}, {a[0].shape[1]}) x "
            f"({b_kn[0].shape[0]}, {b_kn[0].shape[1]}): {str(e)[:80]}")
        return None
    return timer(lambda: torch._int_mm(*(lambda i: (a[i], b_kn[i]))(
        next(it) % copies)))


def _col_major(t):
    return t.t().contiguous().t()


def _gate_bitwise(name, shape, got, ref):
    """K4 and K5 must equal their plain versions bit for bit."""
    err = float((got.float() - ref.float()).abs().max())
    n = int((got != ref).sum())
    check(torch.isfinite(got).all(), f"{name}: non-finite output")
    check(n == 0, f"{name}: {shape} not bit-equal to the plain version: "
          f"{n} outputs differ, max |kernel - plain| {err}")
    return err


# K4 at decode: the rows it is gated at (the serve's 8 slots timed), and
# the weights as quantize_decode_params stores them ((K, N) codes, one
# scale a column): the seven projections and the unembedding
K4_DECODE_ROWS = (1, 8, 16)
K4_DECODE_SHAPES = PROJECTIONS + [("unembed", CFG.hidden_size,
                                   CFG.vocab_size)]
# K4 at the int8 prefill: one chunk of 256 rows (the mma.sync design)
K4_PREFILL_M = ENGINE["prefill_chunk"]


def _decode_operands(gen, M, K, N, copies=3):
    """``copies`` sets of (xq, xs, wq (K, N), ws) at decode"""
    sets = []
    for _ in range(copies):
        xq, xs = Q.quantize_int8(torch.randn((M, K), generator=gen,
                                             device="cuda"))
        wq = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                           dtype=torch.int8)
        ws = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
        sets.append((xq, xs, wq, ws))
    return sets


def k4_decode_gates() -> float:
    """K4 (its split-K GEMV) at every decode shape and each of
    ``K4_DECODE_ROWS``: bit-equal to the plain version and twice-launch
    equal.  Returns the max |kernel - plain| (0)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    err = 0.0
    for name, K, N in K4_DECODE_SHAPES:
        for M in K4_DECODE_ROWS:
            ops = _decode_operands(gen, M, K, N, copies=1)[0]
            check(Q.k4_design(M, N, K, False) == "gemv",
                  f"int8_matmul decode: ({M}, {K}) x ({K}, {N}) does not "
                  f"take the GEMV")
            err = max(err, _gate_bitwise(
                "int8_matmul decode", f"{name} ({M}, {K}) x ({K}, {N})",
                Q.int8_matmul_kernel(*ops),
                Q.int8_matmul(*ops, torch.bfloat16)))
            _twice_equal("int8_matmul decode",
                         lambda: Q.int8_matmul_kernel(*ops))
            del ops
    log(f"int8_matmul decode: bit-equal at M {K4_DECODE_ROWS} on the seven "
        f"projections and the unembedding")
    return err


def int8_gemm_phase() -> list[dict]:
    """K5 (forward) and K4 (the backward's dX and dW, both K-major, on
    its wgmma GEMM) at one layer's seven projections at M = 8192, then K4
    at decode (the split-K GEMV: :func:`k4_decode_gates`, then times at
    M = 8, the seven projections and the unembedding, in CUDA-graph
    replays) and at one prefill chunk (M = 256, mma.sync): bit-equal to
    the plain versions and twice-launch equal; times summed over the
    shapes.  Operands cycle through 3 copies so that no launch finds the
    last one's in L2."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    M = TRAIN["seq"] * TRAIN["bs"]
    bf16 = torch.bfloat16
    zero = lambda: dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, ops=0.0)  # noqa
    t5, t4 = zero(), zero()
    e5 = e4 = 0.0
    # the backward's quantisers of X and g along M into K-major codes,
    # and the same codes from a layout-keeping quantiser and an int8
    # transposed copy (the parent's dW operand)
    quant_ms = quant_copy_ms = 0.0
    lib_missing = set()
    for name, K, N in PROJECTIONS:
        sets = []
        for _ in range(3):
            x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 * 0.02).to(bf16)
            g = (torch.randn((M, N), generator=gen, device="cuda")
                 * 1e-3).to(bf16)
            wq, ws = Q.quantize_int8(w, axis=0)
            # the training path's K5 weight: (N, K) codes, K-major
            wq_t, ws_t = Q.quantize_int8(w.t(), axis=-1)
            gq, gs = Q.quantize_int8(g, axis=-1)
            wq_n, ws_n = Q.quantize_int8(w, axis=1)
            # dW's operands as the backward quantises them: along M,
            # the codes K-major ((K, M) and (N, M))
            xq_t, xs_t = Q.quantize_int8(x.t(), axis=-1)
            gq_t, gs_t = Q.quantize_int8(g.t(), axis=-1)
            sets.append(dict(x=x, g=g, wq=wq, ws=ws, wq_t=wq_t, ws_t=ws_t,
                             xq=Q.quantize_int8(x)[0],
                             dx=(gq, gs, wq_n, ws_n.T, (1, 1)),
                             dw=(xq_t, xs_t, gq_t, gs_t.T, (1, 1))))
            del w
        it = iter(range(10 ** 9))
        c = lambda: sets[next(it) % 3]  # noqa: E731
        s0 = sets[0]
        shape = f"({M}, {K}) x ({K}, {N})"
        quant_ms += time_ms(lambda: (lambda d: (
            Q.quantize_int8(d["x"].t(), axis=-1),
            Q.quantize_int8(d["g"].t(), axis=-1)))(c()), iters=5)
        quant_copy_ms += time_ms(lambda: (lambda d: (
            Q.quantize_int8(d["x"], axis=0)[0].t().contiguous(),
            Q.quantize_int8(d["g"], axis=0)[0].t().contiguous()))(c()),
            iters=5)
        # K5: the forward, the weight K-major as the training path passes
        # it, and in the reference's (K, N) layout (transposed by the
        # wrapper), both bit for bit
        def k5(d):
            return Q.int8_matmul_fused_kernel(d["x"], d["wq_t"], d["ws_t"],
                                              b_kmajor=True)

        ref = Q.int8_matmul_fused(s0["x"], s0["wq"], s0["ws"], bf16)
        e5 = max(e5, _gate_bitwise("int8_matmul_fused", shape, k5(s0), ref))
        e5 = max(e5, _gate_bitwise(
            "int8_matmul_fused", f"{shape}, weight (K, N)",
            Q.int8_matmul_fused_kernel(s0["x"], s0["wq"], s0["ws"]), ref))
        del ref
        _twice_equal("int8_matmul_fused", lambda: k5(s0))
        k_ms = time_ms(lambda: k5(c()))
        p_ms = time_ms(lambda: (lambda d: Q.int8_matmul_fused(
            d["x"], d["wq"], d["ws"], bf16))(c()), iters=3, warmup=1)
        l_ms = _int_mm_ms([d["xq"] for d in sets],
                          [_col_major(d["wq"]) for d in sets], it, 3)
        t5["k"] += k_ms
        t5["p"] += p_ms
        t5["l"] += l_ms or 0.0
        lib_missing |= {"int8_matmul_fused"} if l_ms is None else set()
        # x read, its codes written and read back (the scratch), the
        # K-major weight and scales read, the row scales written and
        # read, the bf16 output written
        t5["nbytes"] += 4 * M * K + K * N + 4 * N + 8 * M + 2 * M * N
        t5["ops"] += 2 * M * K * N
        log(f"int8_matmul_fused {shape}: bit-equal; kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, _int_mm {l_ms} ms")
        # K4: dX = g · Wᵀ and dW = Xᵀ · g, both operands K-major
        for prod, Mo, No, Kc in (("dx", M, K, N), ("dw", K, N, M)):
            sh = f"{prod} ({Mo}, {Kc}) x ({Kc}, {No})"
            got = Q._int8_dot(*s0[prod], bf16, plain=False)
            e4 = max(e4, _gate_bitwise("int8_matmul", sh, got, Q._int8_dot(
                *s0[prod], bf16, plain=True)))
            _twice_equal("int8_matmul", lambda: Q._int8_dot(
                *s0[prod], bf16, plain=False))
            k_ms = time_ms(lambda: Q._int8_dot(*c()[prod], bf16, plain=False))
            p_ms = time_ms(lambda: Q._int8_dot(*c()[prod], bf16, plain=True),
                           iters=3, warmup=1)
            # the library's layout, B column-major, is B's K-major codes'
            # transposed view
            l_ms = _int_mm_ms([d[prod][0] for d in sets],
                              [d[prod][2].t() for d in sets], it, 3)
            t4["k"] += k_ms
            t4["p"] += p_ms
            t4["l"] += l_ms or 0.0
            lib_missing |= {"int8_matmul"} if l_ms is None else set()
            # int8 operands read once, bf16 output written once, scales
            t4["nbytes"] += (Mo * Kc + Kc * No + 4 * (Mo + No)
                             + 2 * Mo * No)
            t4["ops"] += 2 * Mo * No * Kc
            log(f"int8_matmul {sh}: bit-equal; kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, _int_mm {l_ms} ms")
        del sets, got
        torch.cuda.empty_cache()
    b5 = bound(t5["nbytes"], t5["ops"], PEAK_INT8_OPS)
    b4 = bound(t4["nbytes"], t4["ops"], PEAK_INT8_OPS)
    for nm, t, b in (("int8_matmul_fused", t5, b5), ("int8_matmul", t4, b4)):
        log(f"{nm}, one layer's 7 projections at M = {M}: kernel "
            f"{t['k']:.4f} ms, plain {t['p']:.4f} ms, _int_mm {t['l']:.4f} "
            f"ms, bound {b[0]:.4f} ms by {b[1]} ({t['nbytes'] / 1e6:.1f} "
            f"MB, {t['ops'] / 1e12:.3f} T int8 operations)")
    log(f"the int8 backward's quantisers (plain PyTorch) of X and g along "
        f"M into K-major codes, one layer's 7 projections: {quant_ms:.4f} "
        f"ms; a layout-keeping quantiser and an int8 transposed copy "
        f"instead: {quant_copy_ms:.4f} ms")

    # K4 at decode: gated at every decode row count, timed at the serve's
    # 8 rows in CUDA-graph replays (a host loop would time the launch);
    # the library yardstick is torch._int_mm on the 8 rows zero-padded
    # to the fewest rows it takes
    e4 = max(e4, k4_decode_gates())
    dec = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, ops=0.0)
    unembed, pad_rows = None, None
    Md = ENGINE["max_batch"]
    for name, K, N in K4_DECODE_SHAPES:
        sets = _decode_operands(gen, Md, K, N)
        it = iter(range(10 ** 9))
        shape = f"decode {name} ({Md}, {K}) x ({K}, {N})"
        k_ms = graph_ms(lambda: Q.int8_matmul_kernel(*sets[next(it) % 3]))
        p_ms = time_ms(lambda: Q.int8_matmul(*sets[next(it) % 3], bf16))
        l_ms = None
        for rows in (17, 24, 32):
            la = [torch.nn.functional.pad(d[0], (0, 0, 0, rows - Md))
                  for d in sets]
            l_ms = _int_mm_ms(la, [_col_major(d[2]) for d in sets], it, 3,
                              graph_ms)
            if l_ms is not None:
                pad_rows = rows
                break
        nbytes = Md * K + K * N + 4 * (Md + N) + 2 * Md * N
        b_ms = bound(nbytes, 2 * Md * K * N, PEAK_INT8_OPS)[0]
        log(f"int8_matmul {shape}: kernel {k_ms:.5f} ms (graph replays), "
            f"plain {p_ms:.4f} ms, _int_mm on {pad_rows} rows (padded) "
            f"{l_ms} ms, bound {b_ms:.5f} ms by bytes "
            f"({nbytes / 1e6:.2f} MB)")
        if name == "unembed":
            unembed = (k_ms, p_ms, l_ms, b_ms)
        else:
            dec["k"] += k_ms
            dec["p"] += p_ms
            dec["l"] += l_ms or 0.0
            dec["nbytes"] += nbytes
            dec["ops"] += 2 * Md * K * N
        del sets
    torch.cuda.empty_cache()
    db = bound(dec["nbytes"], dec["ops"], PEAK_INT8_OPS)
    log(f"int8_matmul at decode, one layer's 7 projections (M = {Md}): "
        f"kernel {dec['k']:.5f} ms, plain {dec['p']:.4f} ms, _int_mm on "
        f"{pad_rows} rows (padded) {dec['l']:.5f} ms, bound {db[0]:.5f} ms "
        f"by {db[1]}; the unembedding: kernel {unembed[0]:.5f} ms, plain "
        f"{unembed[1]:.4f} ms, _int_mm (padded) {unembed[2]} ms, bound "
        f"{unembed[3]:.5f} ms")

    # K4 at one int8 prefill chunk: M = 256 rows, (K, N) weights
    pre = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, ops=0.0)
    Mp = K4_PREFILL_M
    for name, K, N in PROJECTIONS:
        sets = _decode_operands(gen, Mp, K, N)
        it = iter(range(10 ** 9))
        shape = f"prefill {name} ({Mp}, {K}) x ({K}, {N})"
        check(Q.k4_design(Mp, N, K, False) == "mma",
              f"int8_matmul: {shape} does not take the mma.sync GEMM")
        e4 = max(e4, _gate_bitwise("int8_matmul", shape,
                                   Q.int8_matmul_kernel(*sets[0]),
                                   Q.int8_matmul(*sets[0], bf16)))
        _twice_equal("int8_matmul", lambda: Q.int8_matmul_kernel(*sets[0]))
        k_ms = time_ms(lambda: Q.int8_matmul_kernel(*sets[next(it) % 3]))
        p_ms = time_ms(lambda: Q.int8_matmul(*sets[next(it) % 3], bf16))
        l_ms = _int_mm_ms([d[0] for d in sets],
                          [_col_major(d[2]) for d in sets], it, 3)
        pre["k"] += k_ms
        pre["p"] += p_ms
        pre["l"] += l_ms or 0.0
        pre["nbytes"] += Mp * K + K * N + 4 * (Mp + N) + 2 * Mp * N
        pre["ops"] += 2 * Mp * K * N
        log(f"int8_matmul {shape}: bit-equal; kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, _int_mm {l_ms} ms")
        del sets
    torch.cuda.empty_cache()
    pb = bound(pre["nbytes"], pre["ops"], PEAK_INT8_OPS)
    log(f"int8_matmul at prefill, one layer's 7 projections (M = {Mp}): "
        f"kernel {pre['k']:.4f} ms, plain {pre['p']:.4f} ms, _int_mm "
        f"{pre['l']:.4f} ms, bound {pb[0]:.5f} ms by {pb[1]}")
    k5 = _entry("int8_matmul_fused", "int8_matmul.cu",
                "distributed_training_sandbox_tpu/ops/quant.py:226 "
                "(int8_matmul_pallas_fused, _fused_qmm_kernel :210)", e5, 0.0,
                t5["k"], t5["p"],
                None if "int8_matmul_fused" in lib_missing else t5["l"],
                *b5)
    k4 = _entry("int8_matmul", "int8_matmul.cu",
                "distributed_training_sandbox_tpu/ops/quant.py:162 "
                "(int8_matmul_pallas, _qmm_kernel :153)", e4, 0.0, t4["k"],
                t4["p"], None if "int8_matmul" in lib_missing else t4["l"],
                *b4)
    k4.update(decode_layer_ms=dec["k"], decode_layer_plain_ms=dec["p"],
              decode_layer_library_padded_ms=dec["l"],
              decode_library_rows=pad_rows,
              decode_layer_bound_ms=db[0], unembed_ms=unembed[0],
              unembed_plain_ms=unembed[1],
              unembed_library_padded_ms=unembed[2],
              unembed_bound_ms=unembed[3], prefill_layer_ms=pre["k"],
              prefill_layer_plain_ms=pre["p"],
              prefill_layer_library_ms=pre["l"],
              prefill_layer_bound_ms=pb[0], bwd_quantisers_layer_ms=quant_ms,
              bwd_quantisers_copy_layer_ms=quant_copy_ms)
    return [k4, k5]


def _fa_reading(kernel, name, got, ref, which) -> tuple[float, float]:
    """Log one flash-attention output against the plain version: its
    elementwise gate ratio (and the worst element), and its largest
    64-row block relative L2 error over ``FA.BLOCK_REL_L2``.  Returns
    (max abs error, gate ratio: the larger of the two)."""
    atol, rtol = FA.TOLERANCE[which]
    g, r = got.float(), ref.float()
    q = (g - r).abs() / (atol + rtol * r.abs())
    i = int(q.argmax())
    pos = i // (r.shape[2] * r.shape[3]) % r.shape[1]
    err, ratio = float((g - r).abs().max()), float(q.max())
    blk = FA.block_rel_l2(got, ref)
    log(f"{kernel}: {name} max_abs_err {err:.3e}; elementwise ratio "
        f"{ratio:.4f} (atol {atol}, rtol {rtol}), worst at position {pos}: "
        f"plain {float(r.flatten()[i]):.4e}, kernel "
        f"{float(g.flatten()[i]):.4e}; block relative L2 {blk:.5f} (limit "
        f"{FA.BLOCK_REL_L2})")
    return err, max(ratio, blk / FA.BLOCK_REL_L2)


def fa_draws():
    """``FA_ORACLE_DRAWS`` draws of (q, k, v): B 1, S ``FA_ORACLE_SEQ``,
    the training shape's 16 / 4 heads, hd 128, bf16."""
    nq, nkv = TRAIN_CFG.num_attention_heads, TRAIN_CFG.num_key_value_heads
    hd = TRAIN_CFG.resolved_head_dim
    for d in range(FA_ORACLE_DRAWS):
        gen = torch.Generator(device="cuda").manual_seed(FA_ORACLE_SEED + d)
        yield tuple(torch.randn((1, FA_ORACLE_SEQ, n, hd), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for n in (nq, nkv, nkv))


def fa_oracle_reading(kernels, label="flash_attention_fwd",
                      gated=None) -> dict:
    """The FA forward over :func:`fa_draws` beside the f64 oracle of the
    reference's arithmetic (``FA.attention_oracle``): for each kernel of
    ``kernels`` (name -> fn(q, k, v, scale) -> (O, lse)) and the plain
    path, O's count of outputs off the oracle by more than a quarter of
    the elementwise tolerance (``FA.off_count``), summed over the draws,
    and each kernel's count off the plain path; the max |difference| of
    each.  Gates the kernels named in ``gated`` (all by default): their
    count off the oracle over the plain path's, at most
    ``FA.ORACLE_COUNT_RATIO``."""
    gated = set(kernels) if gated is None else set(gated)
    scale = TRAIN_CFG.resolved_head_dim ** -0.5
    read = {f"{n} - {r}": [0.0, 0] for n in kernels
            for r in ("oracle", "plain")}
    read["plain - oracle"] = [0.0, 0]
    for q, k, v in fa_draws():
        orc = FA.attention_oracle(q, k, v, scale)
        ref = FA.attention_plain_lse(q, k, v, scale)[0]
        pairs = [("plain - oracle", ref, orc)]
        for n, fn in kernels.items():
            got = fn(q, k, v, scale)[0]
            pairs += [(f"{n} - oracle", got, orc), (f"{n} - plain", got, ref)]
        torch.cuda.synchronize()
        for key, a, b in pairs:
            read[key][0] = max(read[key][0], float(
                (a.double() - b.double()).abs().max()))
            read[key][1] += FA.off_count(a, b)
        del orc, ref, pairs
        torch.cuda.empty_cache()
    plain = read["plain - oracle"][1]
    ratios = {n: read[f"{n} - oracle"][1] / max(plain, 1) for n in kernels}
    log(f"{label} over {FA_ORACLE_DRAWS} draws (B 1, S {FA_ORACLE_SEQ}), "
        f"(max |difference|, outputs off by > a quarter of the elementwise "
        f"tolerance): {json.dumps(read)}; each kernel's count off the "
        f"oracle over the plain path's {json.dumps(ratios)} (limit "
        f"{FA.ORACLE_COUNT_RATIO} for {sorted(gated)})")
    for n in sorted(gated):
        check(ratios[n] <= FA.ORACLE_COUNT_RATIO,
              f"{n} oracle: {read[f'{n} - oracle'][1]} outputs off the f64 "
              f"oracle, {ratios[n]:.3f} times the plain path's {plain}, "
              f"above {FA.ORACLE_COUNT_RATIO}")
    return {"readings": read, "oracle_ratio": ratios}


def attention_phase() -> list[dict]:
    """The flash attention at the training shape (B 1, S 8192, 16 query
    and 4 kv heads, hd 128, bf16), forward and backward, against the
    plain version; inputs cycle through 3 copies."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, S = TRAIN["bs"], TRAIN["seq"]
    nq, nkv = TRAIN_CFG.num_attention_heads, TRAIN_CFG.num_key_value_heads
    hd = TRAIN_CFG.resolved_head_dim
    scale = hd ** -0.5
    mk = lambda n: torch.randn((B, S, n, hd), generator=gen,
                               device="cuda").to(torch.bfloat16)
    sets = [(mk(nq), mk(nkv), mk(nkv), mk(nq)) for _ in range(3)]
    q, k, v, do = sets[0]
    o, lse = FA.flash_attention_fwd(q, k, v, scale)
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    e_o, r_o = _fa_reading("flash_attention_fwd", "O", o, ref_o, "fwd")
    e_lse = float((lse - ref_lse).abs().max())
    r_fwd = max(r_o, e_lse / FA.LSE_ATOL)
    log(f"flash_attention_fwd: logsumexp max_abs_err {e_lse:.3e} (atol "
        f"{FA.LSE_ATOL}); gate ratio {r_fwd:.4f}")
    check(torch.isfinite(o).all(), "flash_attention_fwd: non-finite output")
    check(r_fwd <= 1.0, f"flash_attention_fwd: O max |kernel - plain| "
          f"{e_o}, logsumexp {e_lse} (gate ratio {r_fwd:.3f})")
    _twice_equal("flash_attention_fwd",
                 lambda: FA.flash_attention_fwd(q, k, v, scale))
    del ref_o, ref_lse
    torch.cuda.empty_cache()
    oracle = fa_oracle_reading({"flash_attention_fwd": FA.flash_attention_fwd})
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
    ref_g = FA.flash_attention_bwd_plain(q, k, v, do, scale)
    e_g, r_g = zip(*(_fa_reading("flash_attention_bwd", n, g, r, "bwd")
                     for n, g, r in zip(("dq", "dk", "dv"), grads, ref_g)))
    r_bwd = max(r_g)
    log(f"flash_attention_bwd: gate ratio {r_bwd:.4f}")
    check(all(torch.isfinite(g).all() for g in grads),
          "flash_attention_bwd: non-finite grads")
    check(r_bwd <= 1.0, f"flash_attention_bwd: max |kernel - plain| "
          f"{max(e_g)} (gate ratio {r_bwd:.3f})")
    _twice_equal("flash_attention_bwd", lambda: FA.flash_attention_bwd(
        q, k, v, o, lse, do, scale))
    del grads, ref_g
    torch.cuda.empty_cache()

    it = iter(range(10 ** 9))
    cyc = lambda: sets[next(it) % len(sets)]
    saved = [(*s[:3], *FA.flash_attention_fwd(*s[:3], scale), s[3])
             for s in sets]
    fwd_ms = time_ms(lambda: FA.flash_attention_fwd(*cyc()[:3], scale))
    bwd_ms = time_ms(lambda: FA.flash_attention_bwd(
        *saved[next(it) % len(saved)], scale))
    fwd_plain = time_ms(lambda: FA.attention_plain_lse(*cyc()[:3], scale),
                        iters=3, warmup=1)
    bwd_plain = time_ms(lambda: FA.flash_attention_bwd_plain(*cyc(), scale),
                        iters=3, warmup=1)
    # SDPA over K/V repeated to the query heads outside the timed region;
    # its backward timed alone on a retained graph
    rep = nq // nkv
    sd = []
    for q_, k_, v_, do_ in sets:
        args = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in
                (q_, k_.repeat_interleave(rep, 2), v_.repeat_interleave(rep,
                                                                       2))]
        out = torch.nn.functional.scaled_dot_product_attention(
            *args, is_causal=True, scale=scale)
        sd.append((args, out, do_.transpose(1, 2).contiguous()))
    fwd_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *[a.detach() for a in sd[next(it) % 3][0]], is_causal=True,
        scale=scale))

    def sdpa_bwd():
        args, out, g = sd[next(it) % 3]
        return torch.autograd.grad(out, args, g, retain_graph=True)

    bwd_lib = time_ms(sdpa_bwd)
    del sd, saved, sets
    torch.cuda.empty_cache()

    item = 2
    io = (2 * B * S * nq * hd + 2 * B * S * nkv * hd) * item   # q, o; k, v
    f_flops = 2.0 * B * nq * S * S * hd   # causal QK and PV
    fb, fby = bound(io + B * nq * S * 4, f_flops)
    # backward: q, k, v, o, dO read, dq, dk, dv written, lse read
    bb, bby = bound(io + B * S * nq * hd * item * 2
                    + 2 * B * S * nkv * hd * item + B * nq * S * 4,
                    2.5 * f_flops)
    log(f"flash_attention_fwd: kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f}"
        f" ms, SDPA {fwd_lib:.4f} ms, bound {fb:.4f} ms by {fby} "
        f"({f_flops / 1e12:.3f} TFLOP)")
    log(f"flash_attention_bwd: kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f}"
        f" ms, SDPA backward {bwd_lib:.4f} ms, bound {bb:.4f} ms by {bby}")
    replaces = ("distributed_training_sandbox_tpu/models/transformer.py:382 "
                "(_attention_flash, splash attention {})")
    return [
        dict(_entry("flash_attention_fwd", "flash_attention.cu",
                    replaces.format("forward"), max(e_o, e_lse), r_fwd,
                    fwd_ms, fwd_plain, fwd_lib, fb, fby),
             oracle_ratio=oracle["oracle_ratio"]["flash_attention_fwd"]),
        _entry("flash_attention_bwd", "flash_attention.cu",
               replaces.format("dq / dkv backward"), max(e_g), r_bwd,
               bwd_ms, bwd_plain, bwd_lib, bb, bby)]


def ag_matmul_phase() -> dict:
    """K7 at one layer's seven projections at one rank (M = 8192, the
    whole weight a chunk) and at a rank's K-chunk of a four-rank ring
    (Kc 512 and 2752, the activation's chunk a strided view): each
    against the plain version and launched twice bit for bit; then
    CUDA-event times of K7, the plain version and ``torch.matmul`` on
    the same bf16 operands (the yardstick), summed over the seven.
    Operands cycle through 3 copies so that no launch finds the last
    one's in L2."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    M = FSDP_TRAIN["seq"] * FSDP_TRAIN["bs"]
    atol, rtol = C.TOLERANCE[torch.bfloat16]
    tot = dict(k=0.0, p=0.0, l=0.0, nbytes=0.0, flops=0.0)
    err = ratio = 0.0
    times, chunks = {}, {}
    shapes = [(n, K, K, N) for n, K, N in PROJECTIONS] + AG_CHUNKS
    for name, K, Kc, N in shapes:
        key = (K, Kc, N)
        if key not in times:
            ops = []
            for i in range(3):
                a = torch.randn((M, K), generator=gen, device="cuda").to(
                    torch.bfloat16)
                w = (torch.randn((Kc, N), generator=gen, device="cuda")
                     * 0.02).to(torch.bfloat16)
                c0 = (i + 1) % (K // Kc) * Kc   # a chunk off the start
                ops.append((a[:, c0:c0 + Kc], w))
            a2, w = ops[0]
            got = C.ag_matmul_kernel(a2, w)
            ref = C.ag_matmul_plain(a2, w)
            e = float((got.float() - ref.float()).abs().max())
            r = gate_ratio(got, ref, atol, rtol)
            n_diff = int((got != ref).sum())
            small = ref.float().abs() < 2 ** -10
            e_small = float((got.float() - ref.float()).abs()[small].max())
            shape = f"({M}, {Kc}) x ({Kc}, {N})" + (
                f", a strided (row stride {K})" if Kc < K else "")
            log(f"ag_matmul {shape}: max_abs_err {e:.3e} ({e_small:.3e} "
                f"where |plain| < 2^-10), gate ratio {r:.4f} (atol {atol}, "
                f"rtol {rtol}); {n_diff} of {got.numel()} outputs differ "
                f"from the plain version")
            check(torch.isfinite(got).all(), "ag_matmul: non-finite output")
            check(r <= 1.0, f"ag_matmul: {shape} max |kernel - plain| = {e}"
                  f" over atol {atol} rtol {rtol} (gate ratio {r:.3f})")
            _twice_equal("ag_matmul", lambda: C.ag_matmul_kernel(a2, w))
            it = iter(range(10 ** 9))
            cyc = lambda: ops[next(it) % len(ops)]  # noqa: E731
            k_ms = time_ms(lambda: C.ag_matmul_kernel(*cyc()))
            p_ms = time_ms(lambda: C.ag_matmul_plain(*cyc()), iters=5)
            l_ms = time_ms(lambda: torch.matmul(*cyc()))
            del ops, got, ref
            times[key] = (k_ms, p_ms, l_ms, e, r)
            log(f"ag_matmul {shape}: kernel {k_ms:.4f} ms, plain "
                f"{p_ms:.4f} ms, torch.matmul {l_ms:.4f} ms")
        k_ms, p_ms, l_ms, e, r = times[key]
        err, ratio = max(err, e), max(ratio, r)
        # bf16 operands read once (the chunk of a in place), bf16 out
        nbytes = 2 * (M * Kc + Kc * N + M * N)
        flops = 2 * M * Kc * N
        if Kc < K:
            b_ms, b_by = bound(nbytes, flops)
            chunks[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                bound_ms=b_ms, bound_by=b_by)
            log(f"ag_matmul {name}: bound {b_ms:.4f} ms by {b_by}")
            continue
        tot["k"] += k_ms
        tot["p"] += p_ms
        tot["l"] += l_ms
        tot["nbytes"] += nbytes
        tot["flops"] += flops
    b_ms, b_by = bound(tot["nbytes"], tot["flops"])
    log(f"ag_matmul, one layer's 7 projections at one rank: kernel "
        f"{tot['k']:.4f} ms, plain {tot['p']:.4f} ms, torch.matmul "
        f"{tot['l']:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"({tot['nbytes'] / 1e6:.1f} MB, {tot['flops'] / 1e12:.3f} TFLOP)")
    torch.cuda.empty_cache()
    entry = _entry("ag_matmul", "ag_matmul.cu",
                   "distributed_training_sandbox_tpu/ops/collectives.py:391 "
                   "(all_gather_matmul_pallas, pallas_call :350, "
                   "_agmm_chunk_kernel :333)", err, ratio, tot["k"],
                   tot["p"], tot["l"], b_ms, b_by)
    entry["four_rank_chunks"] = chunks
    return entry


# ------------------------------------------------------------ train phases

def _first_batch():
    """run_leg's first batch."""
    ib, lb = next(flagship.leg_batches(TRAIN_CFG.vocab_size, TRAIN["seq"],
                                       TRAIN["bs"], TRAIN["num_steps"],
                                       TRAIN["seed"]))
    return (torch.as_tensor(ib, device="cuda"),
            torch.as_tensor(lb, device="cuda"))


def train_parity_phase() -> float:
    """Step-0 loss and grads on run_leg's params and first batch: the
    kernel path (K6 forward, flash attention) against the plain path
    (plain fp8 forward, plain attention at S = 8192, which fits under
    per-layer checkpointing).  Returns the kernel path's loss."""
    gen = torch.Generator(device="cuda").manual_seed(TRAIN["seed"])
    params = T.init_params(TRAIN_CFG, gen, "cuda")
    batch = _first_batch()
    plain_cfg = dataclasses.replace(TRAIN_CFG, matmul_precision="fp8",
                                    attention_impl="xla")
    # without fp8: bf16 projections, the flash kernels against the plain
    # attention
    bf16_cfg = dataclasses.replace(TRAIN_CFG, matmul_precision="bf16")
    bf16_plain = dataclasses.replace(bf16_cfg, attention_impl="xla")
    out = {}
    for name, cfg in (("kernel", TRAIN_CFG), ("plain", plain_cfg),
                      ("bf16 flash", bf16_cfg), ("bf16 plain", bf16_plain)):
        t = time.perf_counter()
        loss, grads = fsdp.microbatch_value_and_grad(
            lambda p, b, cfg=cfg: T.lm_loss(p, b, cfg), params, batch, 1)
        out[name] = (float(loss), grads)
        log(f"train parity: {name} path loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s)")
    def rel_l2(ga, gb):
        return {"/".join(path): float(
            torch.linalg.vector_norm(a.float() - fsdp.optim.tree_get(gb, path)
                                     .float())
            / torch.linalg.vector_norm(fsdp.optim.tree_get(gb, path).float()))
            for path, a in fsdp.optim.tree_leaves(ga)}

    (lb, gb), (lbp, gbp) = out.pop("bf16 flash"), out.pop("bf16 plain")
    rel_b = rel_l2(gb, gbp)
    worst_b = max(rel_b, key=rel_b.get)
    log(f"train parity without fp8: |loss flash - plain| "
        f"{abs(lb - lbp):.6f}; grad relative L2, worst leaf {worst_b} "
        f"{rel_b[worst_b]:.5f} (limit {BF16_GRAD_REL_L2})")
    del gb, gbp
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    rel = rel_l2(gk, gp)
    worst = max(rel, key=rel.get)
    log(f"train parity: |loss kernel - plain| {abs(lk - lp):.6f} (atol "
        f"{LOSS_ATOL}); grad relative L2, worst leaf {worst} "
        f"{rel[worst]:.5f} (limit {GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}")
    failures = []
    if not (np.isfinite(lk) and np.isfinite(lp)):
        failures.append("step-0 loss: non-finite")
    if abs(lk - lp) > LOSS_ATOL:
        failures.append(f"step-0 loss: |kernel - plain| {abs(lk - lp)} over "
                        f"{LOSS_ATOL}")
    if not rel[worst] <= GRAD_REL_L2:
        failures.append(f"step-0 grads: {worst} relative L2 {rel[worst]} "
                        f"over {GRAD_REL_L2}")
    if not (np.isfinite(lb) and rel_b[worst_b] <= BF16_GRAD_REL_L2):
        failures.append(f"step-0 bf16 grads: {worst_b} relative L2 "
                        f"{rel_b[worst_b]} over {BF16_GRAD_REL_L2}")
    del params, out, gk, gp
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def _step_profile(prof, wall_us, label, step) -> None:
    """Log one profiled step: the device's busy and idle share of its
    wall time and the kernels that take the most device time."""
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(d for _, _, d in dev)
    if not dev:
        log(f"{label} profile: torch.profiler recorded no device time (not "
            f"measured)")
        return
    log(f"{label} profile (step {step}): device busy {busy_us / 1e3:.1f} ms "
        f"of {wall_us / 1e3:.1f} ms wall, idle share "
        f"{1 - busy_us / wall_us:.3f}")
    for key, cnt, d in sorted(dev, key=lambda e: -e[2])[:10]:
        log(f"{label} profile: {d / busy_us:.3f} of device time, {cnt} "
            f"calls, {d / 1e3:.1f} ms: {key[:90]}")


def train_phase(card: str, loss0: float, train=None, cfg=None,
                expect=None, label="train") -> dict:
    """``train["num_steps"]`` steps of run_leg on the card (default: the
    fp8 leg, ``TRAIN``); ``expect`` maps each kernel's name to (its
    counter, launches per step).  Returns the launch counts."""
    from torch.profiler import ProfilerActivity, profile
    train, cfg = train or TRAIN, cfg or TRAIN_CFG
    L = cfg.num_hidden_layers
    if expect is None:   # the fp8 path: K6 forward, the flash attention
        expect = {"fp8_matmul": (Q.COUNTS, L * len(PROJECTIONS) * 2),
                  "flash_attention_fwd": (FA.FWD_COUNTS, L * 2),
                  "flash_attention_bwd": (FA.BWD_COUNTS, L)}
    for c in (Q.COUNTS, Q.BWD_COUNTS, Q.INT8_COUNTS, Q.INT8_FUSED_COUNTS,
              FA.FWD_COUNTS, FA.BWD_COUNTS):
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = train["num_steps"]
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, loss):
        log(f"{label} step {i}: loss {loss!r}")
        if i == n - 2:   # trace the last step: device activity only
            prof.start()
            marks["t"] = time.perf_counter()
        elif i == n - 1:
            marks["wall_us"] = (time.perf_counter() - marks["t"]) * 1e6
            prof.stop()

    res = flagship.run_leg(train["model"], train["precision"], train["seq"],
                           train["bs"], n, train["warmup_steps"],
                           train["peak_lr"], seed=train["seed"],
                           device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = {name: (c.launches, c.plain_calls)
              for name, (c, _) in expect.items()}
    want = {name: n * per for name, (_, per) in expect.items()}
    losses = res["losses"]
    times = res["step_times_s"]
    steps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    step_s = statistics.median(steps[1:n - 1])   # unprofiled, after step 0
    tok_s = train["seq"] * train["bs"] / step_s
    flops_tok = T.model_flops_per_token(cfg, train["seq"])
    log(f"{label} on {card}: losses {losses}; lrs {res['lrs']}")
    log(f"{label}: step times (s, host clock, each ending in a sync) "
        f"{steps}; median of steps 1-{n - 2} {step_s * 1e3:.1f} ms, "
        f"{tok_s:.1f} tokens/s, MFU {flops_tok * tok_s / PEAK_BF16_FLOPS:.4f}"
        f" ({flops_tok:.4e} model FLOP/token over the 989 TFLOP/s bf16 "
        f"dense peak); run_leg tokens_per_second "
        f"{res['tokens_per_second']:.1f}; peak memory {peak / 2 ** 30:.2f} "
        f"GiB")
    log(f"{label} launches (kernel, plain): {json.dumps(counts)}; expected "
        f"kernel launches {json.dumps(want)}; the fp8 backward's plain "
        f"products {Q.BWD_COUNTS.plain_calls}")
    log(f"{label}: step-0 loss {losses[0]!r}, the parity phase's kernel "
        f"path {loss0!r}, bit-equal {losses[0] == loss0}")
    check(losses[0] == loss0, f"{label}: step-0 loss {losses[0]!r} of the "
          f"run is not the parity phase's {loss0!r} (same params and batch)")
    _step_profile(prof, marks["wall_us"], label, n - 1)
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"{label}: {name} (launches, plain) {(launches, plain)} != "
              f"({want[name]}, 0)")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"{label}: step-{n - 1} loss {losses[-1]} "
          f"is not below step-0 loss {losses[0]}")
    return {k: v[0] for k, v in counts.items()}


def int8_train_parity_phase() -> float:
    """Step-0 loss and grads at ``int8_pallas_bwd`` on run_leg's params
    and first batch, the flash attention on both sides: the kernel path
    (K5 forward, K4 dX and dW) against the plain int8 products
    (``quant.plain_int8_products``).  Every int8 product is exact and
    both sides round at the same points, so the loss and every grad leaf
    must be bit-equal.  Returns the kernel path's loss."""
    gen = torch.Generator(device="cuda").manual_seed(INT8_TRAIN["seed"])
    params = T.init_params(INT8_TRAIN_CFG, gen, "cuda")
    batch = _first_batch()
    out = {}
    for name in ("kernel", "plain"):
        t = time.perf_counter()
        with (Q.plain_int8_products() if name == "plain"
              else contextlib.nullcontext()):
            loss, grads = fsdp.microbatch_value_and_grad(
                lambda p, b: T.lm_loss(p, b, INT8_TRAIN_CFG), params, batch, 1)
        torch.cuda.synchronize()
        out[name] = (float(loss), grads)
        log(f"int8 train parity: {name} path loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s)")
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    unequal = {}
    for path, a in fsdp.optim.tree_leaves(gk):
        b = fsdp.optim.tree_get(gp, path)
        if not torch.equal(a, b):
            unequal["/".join(path)] = float((a.float() - b.float()).abs().max())
    log(f"int8 train parity: loss kernel {lk!r} plain {lp!r} (bit-equal "
        f"{lk == lp}); grad leaves not bit-equal: {json.dumps(unequal)}")
    failures = []
    if not (np.isfinite(lk) and np.isfinite(lp)):
        failures.append("int8 step-0 loss: non-finite")
    if lk != lp:
        failures.append(f"int8 step-0 loss: kernel {lk!r} != plain {lp!r}")
    if unequal:
        failures.append(f"int8 step-0 grads: {len(unequal)} leaves not "
                        f"bit-equal, max |kernel - plain| "
                        f"{max(unequal.values())}")
    del params, out, gk, gp
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def _fsdp_inputs():
    """train_fsdp.run's shards (seeded init, this rank's rows) and first
    global batch."""
    gen = torch.Generator(device="cuda").manual_seed(FSDP_TRAIN["seed"])
    shards = fsdp.shard_params_fsdp(T.init_params(FSDP_CFG, gen, "cuda"))
    ib, lb = next(train_fsdp.fsdp_batches(
        FSDP_CFG.vocab_size, FSDP_TRAIN["seq"], FSDP_TRAIN["bs"],
        FSDP_TRAIN["num_steps"], FSDP_TRAIN["seed"]))
    return shards, (torch.as_tensor(ib, device="cuda"),
                    torch.as_tensor(lb, device="cuda"))


def fsdp_train_parity_phase() -> float:
    """On a one-rank NCCL group (made here, as torchrun would give it):
    the FSDP step's step-0 loss and grads at ``ring_fused_pallas`` (every
    projection through K7; the backward plain bf16 products) against
    ``none`` (the gathers, then plain bf16 products), on train_fsdp.run's
    shards and first batch.  Returns the K7 path's loss."""
    mesh.init_process_group("cuda")
    log(f"fsdp: process group of {mesh.axis_size()} rank(s), backend "
        f"{torch.distributed.get_backend()}")
    shards, batch = _fsdp_inputs()
    L = FSDP_CFG.num_hidden_layers
    out = {}
    for overlap in ("ring_fused_pallas", "none"):
        C.COUNTS.reset()
        C.COLLECTIVES.reset()
        t = time.perf_counter()
        vg = fsdp.make_fsdp_value_and_grad(shards, FSDP_CFG, overlap=overlap)
        loss, grads = vg(shards, batch)
        torch.cuda.synchronize()
        out[overlap] = (float(loss), grads)
        log(f"fsdp train parity: {overlap} loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s); K7 (launches, plain) "
            f"({C.COUNTS.launches}, {C.COUNTS.plain_calls}); collectives "
            f"{json.dumps(C.COLLECTIVES.read())}")
        want = (len(PROJECTIONS) * L * 2 if overlap != "none" else 0, 0)
        check((C.COUNTS.launches, C.COUNTS.plain_calls) == want,
              f"fsdp train parity: {overlap} K7 (launches, plain) "
              f"{(C.COUNTS.launches, C.COUNTS.plain_calls)} != {want}")
    (lk, gk), (lp, gp) = out["ring_fused_pallas"], out["none"]
    rel = {}
    for path, a in fsdp.optim.tree_leaves(gk):
        b = fsdp.optim.tree_get(gp, path).float()
        rel["/".join(path)] = float(torch.linalg.vector_norm(a.float() - b)
                                    / torch.linalg.vector_norm(b))
    worst = max(rel, key=rel.get)
    equal = lk == lp and all(torch.equal(a, fsdp.optim.tree_get(gp, path))
                             for path, a in fsdp.optim.tree_leaves(gk))
    log(f"fsdp train parity: loss and grads bit-equal {equal}; |loss K7 - "
        f"plain| {abs(lk - lp):.6f} (atol {FSDP_LOSS_ATOL}); grad relative "
        f"L2, worst leaf {worst} "
        f"{rel[worst]:.5f} (limit {FSDP_GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}")
    failures = []
    if not (np.isfinite(lk) and np.isfinite(lp)):
        failures.append("fsdp step-0 loss: non-finite")
    if abs(lk - lp) > FSDP_LOSS_ATOL:
        failures.append(f"fsdp step-0 loss: |K7 - plain| {abs(lk - lp)} "
                        f"over {FSDP_LOSS_ATOL}")
    if not rel[worst] <= FSDP_GRAD_REL_L2:
        failures.append(f"fsdp step-0 grads: {worst} relative L2 "
                        f"{rel[worst]} over {FSDP_GRAD_REL_L2}")
    del shards, out, gk, gp
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def fsdp_train_phase(card: str, loss0: float) -> dict:
    """``FSDP_TRAIN["num_steps"]`` steps of ``train_fsdp.run`` at
    ring_fused_pallas on the parity phase's process group: K7 and the
    flash attention's launch counts exact, plain counts 0, the losses
    finite and falling, step 0's loss bit-equal to the parity's K7 path;
    the last step profiled.  Returns the launch counts."""
    from torch.profiler import ProfilerActivity, profile
    L, n = FSDP_CFG.num_hidden_layers, FSDP_TRAIN["num_steps"]
    expect = {"ag_matmul": (C.COUNTS, L * len(PROJECTIONS) * 2),
              "flash_attention_fwd": (FA.FWD_COUNTS, L * 2),
              "flash_attention_bwd": (FA.BWD_COUNTS, L)}
    for c, _ in expect.values():
        c.reset()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, loss):
        if i == n - 2:   # trace the last step: device activity only
            prof.start()
            marks["t"] = time.perf_counter()
        elif i == n - 1:
            marks["wall_us"] = (time.perf_counter() - marks["t"]) * 1e6
            prof.stop()

    res = train_fsdp.run(FSDP_TRAIN["model"], overlap=FSDP_TRAIN["overlap"],
                         batch_size=FSDP_TRAIN["bs"], seq=FSDP_TRAIN["seq"],
                         num_steps=n, device="cuda", seed=FSDP_TRAIN["seed"],
                         on_step=on_step, log=log)
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    want = {k: n * per for k, (_, per) in expect.items()}
    losses, times = res["losses"], res["step_times_s"]
    steps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    step_s = statistics.median(steps[1:n - 1])   # unprofiled, after step 0
    tok_s = FSDP_TRAIN["seq"] * FSDP_TRAIN["bs"] / step_s
    flops_tok = res["model_flops_per_token"]
    log(f"fsdp train on {card}: losses {losses}; collectives a step "
        f"{json.dumps(res['collectives'][-1])}")
    log(f"fsdp train: step times (s, host clock, each ending in a sync) "
        f"{steps}; median of steps 1-{n - 2} {step_s * 1e3:.1f} ms, "
        f"{tok_s:.1f} tokens/s, MFU {flops_tok * tok_s / PEAK_BF16_FLOPS:.4f}"
        f" ({flops_tok:.4e} model FLOP/token over the 989 TFLOP/s bf16 "
        f"dense peak); run tokens_per_second {res['tokens_per_second']:.1f};"
        f" peak memory {res['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    log(f"fsdp train launches (kernel, plain): {json.dumps(counts)}; "
        f"expected kernel launches {json.dumps(want)}")
    log(f"fsdp train: step-0 loss {losses[0]!r}, the parity phase's K7 "
        f"path {loss0!r}, bit-equal {losses[0] == loss0}")
    _step_profile(prof, marks["wall_us"], "fsdp train", n - 1)
    check(losses[0] == loss0, f"fsdp train: step-0 loss {losses[0]!r} of "
          f"the run is not the parity phase's {loss0!r} (same shards and "
          f"batch)")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"fsdp train: {name} (launches, plain) {(launches, plain)} != "
              f"({want[name]}, 0)")
    check(all(np.isfinite(losses)), f"fsdp train: non-finite loss in "
          f"{losses}")
    check(losses[-1] < losses[0], f"fsdp train: step-{n - 1} loss "
          f"{losses[-1]} is not below step-0 loss {losses[0]}")
    return {k: v[0] for k, v in counts.items()}


def _step_ms(step_s: list) -> float:
    """The median of the steps between the first and the last (which
    phase 10 may profile), in ms."""
    return statistics.median(step_s[1:-1]) * 1e3


def _last_step_profiler(n: int, label: str):
    """An ``on_step`` hook for the twins (``(i, loss)`` or ``(leg, i,
    loss)``) that profiles each leg's step n - 1, device activity only,
    and logs its breakdown (``_step_profile``)."""
    from torch.profiler import ProfilerActivity, profile
    held = {}

    def hook(*args):
        *leg, i, _ = args
        if i == n - 2:
            held["prof"] = profile(activities=[ProfilerActivity.CUDA])
            held["prof"].start()
            held["t"] = time.perf_counter()
        elif i == n - 1:
            wall_us = (time.perf_counter() - held["t"]) * 1e6
            held["prof"].stop()
            _step_profile(held["prof"], wall_us, " ".join([label, *leg]), i)
    return hook


def ddp_zero_phase(card: str) -> dict:
    """Phase 10 on the FSDP phases' one-rank NCCL group: ``train.ddp.run``
    (``DDP_ZERO["num_steps"]`` SGD steps, per-leaf sync) and
    ``train.zero.run`` for ZeRO-1 (both rebuilds), -2 and -3 at full
    width.  Gates: the sync check; the shim's counts a step (DDP n + 2
    all_reduces, its init 12 broadcasts; each ZeRO leg its contract's);
    losses finite and falling (DDP: the first batch's loss under the
    final params below step 0's, since each step draws a new batch);
    every sharded leg equal to its baseline Adam leg in losses and final
    params, bit for bit (at one rank every collective is a copy and a
    chunk the whole flat param, so each sharded leg does the baseline's
    arithmetic on the same values); ZeRO-1's broadcast rebuild
    bit-equal to its all_gather rebuild.  The last step of DDP and of
    both legs of ZeRO-1 (broadcast) and ZeRO-3 is profiled.  Returns the
    readings: step ms (host clock, the median of the steps between the
    first and the profiled last) beside each step's byte bound,
    optimizer MB, memory, collectives a step."""
    torch.cuda.empty_cache()
    cfg = DDP_ZERO
    out = {}
    n_steps = cfg["num_steps"]
    r = ddp_run.run(scale=cfg["scale"], num_steps=n_steps,
                    batch_size=cfg["ddp_batch"], seed=cfg["seed"],
                    device="cuda", on_step=_last_step_profiler(n_steps, "ddp"),
                    log=log)
    n = r["n_leaves"]
    sizes = [w // cfg["scale"] for w in MLP.ZERO_TOY_SIZES]
    p_bytes = 4 * sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))
    bound = lambda k: STEP_BYTES_OVER_P[k] * p_bytes / HBM_BYTES_PER_S * 1e3
    steps = r["step_s"]
    out["ddp"] = {"step_ms": _step_ms(steps), "bound_ms": bound("ddp"),
                  "peak_gib": r["peak_memory_bytes"] / 2 ** 30,
                  "collectives": r["collectives"][-1],
                  "losses": r["losses"],
                  "final_loss_batch0": r["final_loss_batch0"]}
    log(f"ddp on {card}: params {p_bytes / 1e9:.3f} GB ({n} leaves); step "
        f"{out['ddp']['step_ms']:.3f} ms (host clock, median of steps 1-"
        f"{n_steps - 2}; steps {[round(t * 1e3, 3) for t in steps]})"
        f" against a byte bound of {out['ddp']['bound_ms']:.3f} ms; peak "
        f"memory {out['ddp']['peak_gib']:.3f} GiB; collectives a step "
        f"{json.dumps(C.COLLECTIVES.nonzero(r['collectives'][-1]))}")
    check(r["sync_error"] == 0.0, f"ddp: sync check read {r['sync_error']}")
    broadcasts = {**dict.fromkeys(C.CollectiveCounts.KINDS, 0),
                  "broadcast": n}
    check(r["init_collectives"] == broadcasts,
          f"ddp: init broadcast {r['init_collectives']}")
    want = step_collectives("ddp", n)
    check(all(c == want for c in r["collectives"]),
          f"ddp: collectives a step {r['collectives']} != {want}")
    check(all(np.isfinite(r["losses"] + [r["final_loss_batch0"]])),
          f"ddp: non-finite loss in {r['losses']}")
    check(r["final_loss_batch0"] < r["losses"][0],
          f"ddp: the first batch's loss under the final params "
          f"{r['final_loss_batch0']!r} is not below step 0's "
          f"{r['losses'][0]!r}")
    del r
    for stage, rebuild in ((1, "broadcast"), (1, "all_gather"),
                           (2, "broadcast"), (3, "all_gather")):
        name = f"zero{stage}" + ("_all_gather" if (stage, rebuild) == (
            1, "all_gather") else "")
        torch.cuda.empty_cache()
        profiled = (stage, rebuild) in ((1, "broadcast"), (3, "all_gather"))
        z = zero_run.run(stage, rebuild=rebuild, scale=cfg["scale"],
                         num_steps=n_steps, batch_size=cfg["zero_batch"],
                         seed=cfg["seed"], device="cuda",
                         keep_params=stage == 1,
                         on_step=_last_step_profiler(n_steps, name)
                         if profiled else None, log=log)
        bits = z["params_bit_equal"] and z["base_losses"] == z["shard_losses"]
        rd = {"base_ms": _step_ms(z["base_step_s"]),
              "shard_ms": _step_ms(z["shard_step_s"]),
              "base_bound_ms": bound("adam"),
              "shard_bound_ms": bound(f"zero{stage}"),
              "base_opt_mb": z["base_opt_mb"],
              "shard_opt_mb": z["shard_opt_mb"],
              "shard_param_mb": z["shard_param_mb"],
              "base_gib": {k: v / 2 ** 30
                           for k, v in z["base_memory_bytes"].items()},
              "shard_gib": {k: v / 2 ** 30
                            for k, v in z["shard_memory_bytes"].items()},
              "base_collectives": z["base_counts"][-1],
              "shard_collectives": z["shard_counts"][-1],
              "loss_drift": z["loss_drift"],
              "param_max_abs_diff": z["param_max_abs_diff"]}
        out[name] = rd
        log(f"{name} on {card}: step baseline {rd['base_ms']:.3f} ms "
            f"(bound {rd['base_bound_ms']:.3f}), sharded "
            f"{rd['shard_ms']:.3f} ms (bound {rd['shard_bound_ms']:.3f}); "
            f"optimizer {rd['base_opt_mb']:.1f} -> {rd['shard_opt_mb']:.1f} "
            f"MB" + (f", params {z['param_mb']:.1f} -> "
                     f"{rd['shard_param_mb']:.1f} MB" if stage == 3 else "")
            + f"; memory at start and peak (GiB) baseline "
            f"{rd['base_gib']['start']:.3f}, {rd['base_gib']['peak']:.3f}, "
            f"sharded {rd['shard_gib']['start']:.3f}, "
            f"{rd['shard_gib']['peak']:.3f}; loss drift "
            f"{rd['loss_drift']!r}, params max |diff| "
            f"{rd['param_max_abs_diff']!r}, bit-equal {bits}")
        check(bits, f"{name}: sharded leg not bit-equal to baseline Adam: "
              f"losses baseline {z['base_losses']} sharded "
              f"{z['shard_losses']}, params max |diff| "
              f"{z['param_max_abs_diff']}")
        want = step_collectives(f"zero{stage}", n, rebuild=rebuild)
        check(all(c == want for c in z["shard_counts"]),
              f"{name}: collectives a step {z['shard_counts'][-1]} != {want}")
        check(all(c == step_collectives("ddp", n)
                  for c in z["base_counts"]),
              f"{name}: baseline collectives a step {z['base_counts'][-1]}")
        losses = z["base_losses"] + z["shard_losses"]
        check(all(np.isfinite(losses)), f"{name}: non-finite loss")
        check(z["shard_losses"][-1] < z["shard_losses"][0],
              f"{name}: losses not falling {z['shard_losses']}")
        if name == "zero1":   # the broadcast rebuild, kept for the next
            kept = z["shard_losses"], z["shard_params"]
        elif name == "zero1_all_gather":
            same = kept[0] == z["shard_losses"] and all(
                torch.equal(a, fsdp.optim.tree_get(z["shard_params"], path))
                for path, a in fsdp.optim.tree_leaves(kept[1]))
            log(f"zero1: rebuild broadcast bit-equal to all_gather {same}")
            check(same, "zero1: rebuild broadcast is not bit-equal to "
                  "all_gather")
            kept = None
        del z
    torch.cuda.empty_cache()
    return out

# ------------------------------------------------------- the pipeline

def _toy_monolithic(params, batch, lr):
    """One full-batch Adam step of the toy MLP on a copy of ``params``:
    ``(loss, grads, params after the step)``."""
    p = fsdp.optim.tree_map(lambda t: t.detach().clone(), params)
    loss, grads = fsdp.microbatch_value_and_grad(MLP.mse_loss, p, batch, 1)
    p, _ = fsdp.optim.adam_update(grads, fsdp.optim.adam_init(p), p, lr=lr)
    return float(loss), grads, p


def _rel_l2(a, b) -> float:
    b = b.float()
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b))


def _schedule(name):
    return {"gpipe": PP.run_gpipe, "1f1b": PP.run_1f1b,
            "interleaved": PP.run_interleaved_1f1b}[name]


def pipeline_toy_phase(card: str) -> dict:
    """Phase 11a: the PP toy through ``train.pipeline.run``, a leg each
    of ``PIPE_TOY_LEGS``.  Gates: each leg's step 0 (the schedule on the
    run's params and first batch) against one monolithic Adam step (loss,
    grads, params after it); its 16-epoch run's step-0 loss that step's;
    GPipe's first losses 1F1B's;
    the 1F1B clock ``PIPE_1F1B_TRACE``; the high-water marks (GPipe
    n_micro a stage, 1F1B at most n_stages); no collective; losses
    finite and the first batch's loss lower under the final params.
    Returns each leg's epoch ms and schedule statistics."""
    cfg, dev = PIPE_TOY, torch.device("cuda")
    params = MLP.pp_toy_mlp(torch.Generator(device=dev).manual_seed(
        cfg["seed"]), device=dev)
    batch = next(pp_run.epoch_batches(None, cfg["batch"], 0, cfg["seed"],
                                      dev))
    mono_loss, mono_grads, mono = _toy_monolithic(params, batch, cfg["lr"])
    out, losses = {}, {}
    for schedule, n in PIPE_TOY_LEGS:
        stages, _ = pp_run.build_stages("mlp", schedule, n, 2, cfg["seed"],
                                        "cuda")
        trace = []
        loss0 = _schedule(schedule)(
            stages, *batch, n_micro=cfg["n_micro"], lr=cfg["lr"],
            **({} if schedule == "gpipe" else {"schedule_trace": trace}))
        got = [layer for s in stages for layer in s.params]
        diff = max(float((a[k] - b[k]).abs().max())
                   for a, b in zip(got, mono, strict=True) for k in a)
        grads = [layer for s in stages for layer in s.grad_acc]
        rel = max(_rel_l2(a[k], b[k])
                  for a, b in zip(grads, mono_grads, strict=True) for k in a)
        del stages, grads
        full = []
        r = pp_run.run(schedule, model="mlp", n_stages=n,
                       n_micro=cfg["n_micro"], lr=cfg["lr"],
                       num_epochs=cfg["epochs"], batch_size=cfg["batch"],
                       seed=cfg["seed"], device="cuda",
                       on_step=lambda e, l: full.append(l), log=log)
        losses[schedule] = full
        ms = statistics.median(r["step_ms"][1:])
        out[schedule] = {"epoch_ms": ms, "stats": r["schedule_stats"],
                         "max_stored": r["max_stored_activations"]}
        log(f"pipeline toy {schedule} on {card}: {len(r['devices'])} stages"
            f" on {r['devices']}; step 0 loss {loss0!r} against the "
            f"monolithic step's {mono_loss!r} (rel "
            f"{abs(loss0 - mono_loss) / abs(mono_loss):.3e}, limit "
            f"{PIPE_TOY_LOSS_RTOL}), grads' worst relative L2 {rel:.3e} "
            f"(limit {PIPE_TOY_GRAD_REL_L2}), params max |diff| {diff:.3e} "
            f"(atol {PIPE_TOY_PARAM_ATOL}); losses {full}; the first batch's "
            f"loss under the final params {r['final_loss_batch0']!r}; "
            f"epoch ms (host clock, median of epochs 1-"
            f"{cfg['epochs'] - 1}) {ms:.3f}; max stored "
            f"{r['max_stored_activations']}; schedule stats "
            f"{json.dumps(r['schedule_stats'])}; MB a card at the start "
            f"{json.dumps(r['start_memory_mb'])}, peak "
            f"{json.dumps(r['peak_memory_mb'])}")
        check(abs(loss0 - mono_loss) <= PIPE_TOY_LOSS_RTOL * abs(mono_loss),
              f"pipeline toy {schedule}: step-0 loss {loss0!r} against the "
              f"monolithic {mono_loss!r}")
        check(rel <= PIPE_TOY_GRAD_REL_L2, f"pipeline toy {schedule}: "
              f"step-0 grads off the monolithic step's by relative L2 {rel}")
        check(diff <= PIPE_TOY_PARAM_ATOL, f"pipeline toy {schedule}: "
              f"params after step 0 off the monolithic step by {diff}")
        check(full[0] == loss0, f"pipeline toy {schedule}: the run's step-0 "
              f"loss {full[0]!r} is not the schedule's {loss0!r}")
        check(r["contract"]["holds"], f"pipeline toy {schedule}: "
              f"collectives {r['contract']['collectives'][-1]}")
        check(all(np.isfinite(full)), f"pipeline toy {schedule}: non-finite "
              f"loss in {full}")
        check(r["final_loss_batch0"] < full[0], f"pipeline toy {schedule}: "
              f"the first batch's loss under the final params "
              f"{r['final_loss_batch0']!r} is not below step 0's {full[0]!r}")
        stored = list(r["max_stored_activations"].values())
        if schedule == "gpipe":
            check(stored == [cfg["n_micro"]] * n, f"pipeline toy gpipe: "
                  f"max stored {stored}")
        elif schedule == "1f1b":
            check(trace == PIPE_1F1B_TRACE, f"pipeline toy 1f1b: tick trace "
                  f"{trace} is not the pinned one")
            check(max(stored) <= n, f"pipeline toy 1f1b: max stored {stored}")
    rels = [abs(a - b) / abs(b)
            for a, b in zip(losses["gpipe"], losses["1f1b"], strict=True)]
    k = PIPE_GPIPE_1F1B_EPOCHS
    log(f"pipeline toy: GPipe against 1F1B, relative loss difference of "
        f"each epoch {[float(f'{r:.3e}') for r in rels]} (limit "
        f"{PIPE_GPIPE_1F1B_RTOL} over the first {k})")
    check(max(rels[:k]) <= PIPE_GPIPE_1F1B_RTOL, f"pipeline toy: GPipe and "
          f"1F1B losses differ by rel {max(rels[:k])} in the first {k} "
          f"epochs")
    return out


def _stage_rel_l2(stage_grads, ref) -> dict:
    """Every grad leaf's relative L2 error of a pipeline's stages (their
    ``grad_acc`` trees) against ``ref(s, path)``, the reference leaf."""
    return {f"stage{s}/" + "/".join(path): _rel_l2(a, ref(s, path))
            for s, g in enumerate(stage_grads)
            for path, a in fsdp.optim.tree_leaves(g)}


def pipeline_lm_parity_phase() -> float:
    """Phase 11b's gates at step 0: the GPipe pipeline of
    ``PIPE_LM_CFG`` (4 stages on the card, the run's params and first
    batch) through the flash kernels against (i) one monolithic
    ``lm_loss`` step on the same untied params and batch, through the
    same kernels, and (ii) the same pipeline with plain attention; the
    flash step's FA launches exact (forward 2 · L · n_micro: each stage
    layer's forward and its remat recompute; backward L · n_micro) and
    plain calls 0.  Returns the flash pipeline's loss."""
    cfg, pl, dev = PIPE_LM_CFG, PIPE_LM, torch.device("cuda")
    L, nm = cfg.num_hidden_layers, pl["n_micro"]
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        pl["seed"]), dev)
    batch = next(pp_run.epoch_batches(cfg, pl["batch"], pl["seq"],
                                      pl["seed"], dev))
    ucfg = dataclasses.replace(cfg, tie_word_embeddings=False)
    t = time.perf_counter()
    mono_loss, mono = fsdp.microbatch_value_and_grad(
        lambda p, b: T.lm_loss(p, b, ucfg),
        dict(params, lm_head=params["embed"].T.contiguous()), batch, 1)
    mono_loss = float(mono_loss)
    log(f"pipeline parity: monolithic lm_loss {mono_loss!r} "
        f"({time.perf_counter() - t:.1f} s)")
    ranges = [(i[0], i[-1] + 1) for i in PP.split_stages(list(range(L)),
                                                          pl["n_stages"])]
    out = {}
    for name, c in (("flash", cfg),
                    ("plain", dataclasses.replace(cfg, attention_impl="xla"))):
        FA.FWD_COUNTS.reset()
        FA.BWD_COUNTS.reset()
        t = time.perf_counter()
        stages = PP.build_transformer_pipeline(params, c, pl["n_stages"],
                                               devices=[dev])
        loss = PP.run_gpipe(stages, *batch, n_micro=nm, lr=pl["lr"])
        torch.cuda.synchronize()
        counts = (FA.FWD_COUNTS.launches, FA.FWD_COUNTS.plain_calls,
                  FA.BWD_COUNTS.launches, FA.BWD_COUNTS.plain_calls)
        out[name] = (loss, [s.grad_acc for s in stages])
        del stages
        log(f"pipeline parity: {name} attention, GPipe step 0 loss "
            f"{loss!r} ({time.perf_counter() - t:.1f} s); FA (forward "
            f"launches, plain, backward launches, plain) {counts}")
        if name == "flash":
            want = (2 * L * nm, 0, L * nm, 0)
            check(counts == want, f"pipeline parity: FA counts {counts} != "
                  f"{want}")
    (lf, gf), (lp, gp) = out["flash"], out["plain"]

    def mono_leaf(s, path):   # the stage's layer slice of the full grads
        b = fsdp.optim.tree_get(mono, path)
        return b[slice(*ranges[s])] if path[0] == "layers" else b

    rel_m = _stage_rel_l2(gf, mono_leaf)
    rel_p = _stage_rel_l2(gf, lambda s, path: fsdp.optim.tree_get(gp[s],
                                                                  path))
    wm, wp = max(rel_m, key=rel_m.get), max(rel_p, key=rel_p.get)
    log(f"pipeline step-0 against the monolithic step: |loss difference| "
        f"{abs(lf - mono_loss):.6f} (atol {PIPE_MONO_LOSS_ATOL}); grad "
        f"relative L2, worst leaf {wm} {rel_m[wm]:.5f} (limit "
        f"{PIPE_MONO_GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel_m.items()})}")
    log(f"pipeline plain: flash against plain attention: |loss "
        f"difference| {abs(lf - lp):.6f} (atol {PIPE_PLAIN_LOSS_ATOL}); "
        f"grad relative L2, worst leaf {wp} {rel_p[wp]:.5f} (limit "
        f"{PIPE_PLAIN_GRAD_REL_L2}); all leaves "
        f"{json.dumps({k: round(v, 6) for k, v in rel_p.items()})}")
    failures = []
    if not all(np.isfinite([lf, lp, mono_loss])):
        failures.append("pipeline step-0 loss: non-finite")
    if abs(lf - mono_loss) > PIPE_MONO_LOSS_ATOL:
        failures.append(f"pipeline step-0 loss: |pipeline - monolithic| "
                        f"{abs(lf - mono_loss)} over {PIPE_MONO_LOSS_ATOL}")
    if not rel_m[wm] <= PIPE_MONO_GRAD_REL_L2:
        failures.append(f"pipeline step-0 grads: {wm} relative L2 "
                        f"{rel_m[wm]} over {PIPE_MONO_GRAD_REL_L2}")
    if abs(lf - lp) > PIPE_PLAIN_LOSS_ATOL:
        failures.append(f"pipeline plain loss: |flash - plain| {abs(lf - lp)}"
                        f" over {PIPE_PLAIN_LOSS_ATOL}")
    if not rel_p[wp] <= PIPE_PLAIN_GRAD_REL_L2:
        failures.append(f"pipeline plain grads: {wp} relative L2 "
                        f"{rel_p[wp]} over {PIPE_PLAIN_GRAD_REL_L2}")
    del params, mono, out, gf, gp
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lf


def fa_bwd_oracle_gate() -> dict:
    """The FA backward at a pipeline stage's microbatch over
    ``FA_BWD_PIPE_SEEDS``, on the forward kernel's O and logsumexp.
    Gates each grad's L2 distance from the exact f64 gradient
    (``FA.attention_bwd_oracle``) over the plain path's at
    ``FA.BWD_ORACLE_L2_RATIO``.  Logs each grad's relative L2 from the
    exact gradient for the kernel and the plain path, its elementwise
    ratio against plain (``FA.TOLERANCE["bwd"]``) and its block relative
    L2, and at the element where the kernel and plain differ most
    against the tolerance, |kernel - exact| and |plain - exact| in bf16
    ulps of the exact value."""
    cfg = PIPE_LM_CFG
    B = PIPE_LM["batch"] // PIPE_LM["n_micro"]
    S, hd = PIPE_LM["seq"], cfg.resolved_head_dim
    nq, nkv, scale = cfg.num_attention_heads, cfg.num_key_value_heads, \
        hd ** -0.5
    atol, rtol = FA.TOLERANCE["bwd"]
    out = {}
    for seed in FA_BWD_PIPE_SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v, do = (torch.randn((B, S, n, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for n in (nq, nkv, nkv, nq))
        o, lse = FA.flash_attention_fwd(q, k, v, scale)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
        ref = FA.flash_attention_bwd_plain(q, k, v, do, scale)
        exact = FA.attention_bwd_oracle(q, k, v, do, scale)
        for name, a, b, e in zip(("dq", "dk", "dv"), got, ref, exact):
            a64, b64 = a.double(), b.double()
            i = int(((a64 - b64).abs() / (atol + rtol * b64.abs())).argmax())
            ei = float(e.flatten()[i])
            ulp = 2.0 ** (math.frexp(ei)[1] - 8) if ei else 2.0 ** -133
            out[f"{seed}/{name}"] = {
                "ratio": round(FA.oracle_l2_ratio(a, b, e), 4),
                "kernel": round(float(torch.linalg.vector_norm(a64 - e)
                                      / torch.linalg.vector_norm(e)), 6),
                "plain": round(float(torch.linalg.vector_norm(b64 - e)
                                     / torch.linalg.vector_norm(e)), 6),
                "vs_plain": round(gate_ratio(a, b, atol, rtol), 4),
                "block": round(FA.block_rel_l2(a, b), 5),
                "worst_ulps": (round(abs(float(a64.flatten()[i]) - ei) / ulp,
                                     2),
                               round(abs(float(b64.flatten()[i]) - ei) / ulp,
                                     2))}
        del q, k, v, do, o, lse, got, ref, exact
    worst = max(out, key=lambda n: out[n]["ratio"])
    over = [n for n, r in out.items() if r["vs_plain"] > 1]
    log(f"flash_attention_bwd at B {B}, S {S} over seeds "
        f"{list(FA_BWD_PIPE_SEEDS)}: {json.dumps(out)}; worst L2 ratio "
        f"{out[worst]['ratio']} at {worst} (limit {FA.BWD_ORACLE_L2_RATIO});"
        f" elementwise ratio against plain over 1 at {over}")
    check(out[worst]["ratio"] <= FA.BWD_ORACLE_L2_RATIO,
          f"flash_attention_bwd oracle: {worst} L2 distance from the exact "
          f"gradient {out[worst]['ratio']} times the plain path's, above "
          f"{FA.BWD_ORACLE_L2_RATIO}")
    torch.cuda.empty_cache()
    return out


def pipeline_lm_phase(card: str, loss0: float) -> dict:
    """Phase 11b's runs: ``train.pipeline.run`` on ``PIPE_LM`` for GPipe
    and 1F1B, ``PIPE_LM["epochs"]`` epochs each, the last profiled.
    Gates: FA's launches exact (the steps' and the run's closing forward
    of the first batch) and plain calls 0, GPipe's step-0 loss
    bit-equal to the parity phase's flash pipeline, 1F1B's within
    ``PIPE_GPIPE_1F1B_RTOL`` of it, losses finite, no collective, the
    high-water marks.  Returns FA's launches over both runs."""
    cfg, pl = PIPE_LM_CFG, PIPE_LM
    L, n = cfg.num_hidden_layers, pl["epochs"]
    tokens = pl["batch"] * pl["seq"]
    flops_tok = T.model_flops_per_token(cfg, pl["seq"])
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}
    for schedule in ("gpipe", "1f1b"):
        FA.FWD_COUNTS.reset()
        FA.BWD_COUNTS.reset()
        torch.cuda.empty_cache()
        full, prof = [], _last_step_profiler(n, f"pipeline {schedule}")

        def on_step(e, loss):
            full.append(loss)
            prof(e, loss)

        r = pp_run.run(schedule, model=pl["model"], n_stages=pl["n_stages"],
                       n_micro=pl["n_micro"], lr=pl["lr"],
                       warmup_epochs=pl["warmup"], num_epochs=n,
                       batch_size=pl["batch"], seq=pl["seq"],
                       seed=pl["seed"], device="cuda", on_step=on_step,
                       log=log)
        torch.cuda.synchronize()
        counts = (FA.FWD_COUNTS.launches, FA.FWD_COUNTS.plain_calls,
                  FA.BWD_COUNTS.launches, FA.BWD_COUNTS.plain_calls)
        launches["flash_attention_fwd"] += counts[0]
        launches["flash_attention_bwd"] += counts[2]
        step_s = statistics.median(r["step_ms"][1:-1]) / 1e3
        tok_s = tokens / step_s
        mem = (r["start_memory_mb"]["cuda:0"] / 1024,
               r["peak_memory_mb"]["cuda:0"] / 1024)
        log(f"pipeline {schedule} on {card}: {pl['model']}, "
            f"{pl['n_stages']} stages on {r['devices']}, batch "
            f"{pl['batch']} x seq {pl['seq']} in {pl['n_micro']} "
            f"microbatches; losses {full}; step ms (host clock) "
            f"{r['step_ms']}; step {step_s * 1e3:.1f} ms (median of epochs "
            f"1-{n - 2}), {tok_s:.1f} tokens/s, MFU "
            f"{flops_tok * tok_s / PEAK_BF16_FLOPS:.4f} ({flops_tok:.4e} "
            f"model FLOP/token at seq {pl['seq']} over the 989 TFLOP/s bf16 "
            f"dense peak); the card's memory at the start and the peak "
            f"{mem[0]:.3f}, {mem[1]:.3f} GiB; "
            f"accounted MB a stage {json.dumps(r['memory_plan_mb'])}; "
            f"stored inputs {json.dumps(r['max_stored_activations'])} of "
            f"{json.dumps(r['activation_mb_per_microbatch'])} MB; FA "
            f"(forward launches, plain, backward launches, plain) {counts}")
        # a step: each stage layer's forward and its remat recompute a
        # microbatch, one backward; then the run's one forward of the
        # first batch under the final params (final_loss_batch0)
        want = (2 * L * pl["n_micro"] * n + L, 0, L * pl["n_micro"] * n, 0)
        check(counts == want, f"pipeline {schedule}: FA counts {counts} != "
              f"{want}")
        check(all(np.isfinite(full)), f"pipeline {schedule}: non-finite loss "
              f"in {full}")
        check(r["contract"]["holds"], f"pipeline {schedule}: collectives "
              f"{r['contract']['collectives'][-1]}")
        stored = list(r["max_stored_activations"].values())
        if schedule == "gpipe":
            check(full[0] == loss0, f"pipeline gpipe: step-0 loss {full[0]!r}"
                  f" of the run is not the parity phase's {loss0!r}")
            check(stored == [pl["n_micro"]] * pl["n_stages"],
                  f"pipeline gpipe: max stored {stored}")
        else:
            check(abs(full[0] - loss0) <= PIPE_GPIPE_1F1B_RTOL * abs(loss0),
                  f"pipeline 1f1b: step-0 loss {full[0]!r} against GPipe's "
                  f"{loss0!r}")
            check(max(stored) <= pl["n_stages"], f"pipeline 1f1b: max "
                  f"stored {stored}")
    torch.cuda.empty_cache()
    return launches


def busbench_phase(card: str) -> list[dict]:
    """Phase 12: ``train.busbench.run`` on the one-rank NCCL group, every
    collective at ``BUSBENCH_MB``, bf16.  Gates: the reference's schema,
    each payload the reference's sizing, and each collective's output
    its input (at one rank a copy: no link is measured)."""
    doc = bb_run.run(payloads_mb=BUSBENCH_MB, out_dir="build/busbench",
                     device="cuda", log=log)
    fields = [f.name for f in dataclasses.fields(BB.BusResult)]
    n = doc["devices"]
    check(len(doc["rows"]) == len(BB.COLLECTIVE_NAMES) * len(BUSBENCH_MB),
          f"busbench: {len(doc['rows'])} rows")
    for row in doc["rows"]:
        check(list(row) == fields, f"busbench: row keys {list(row)}")
    want = {BB.payload_elems(mb * 2 ** 20, n, 2) * 2 for mb in BUSBENCH_MB}
    check({r["payload_bytes"] for r in doc["rows"]} == want,
          f"busbench: payloads {doc['payload_bytes']} != {sorted(want)}")
    for name in BB.COLLECTIVE_NAMES:
        x = BB.make_input(name, 2 ** 20, 0, n, torch.bfloat16, "cuda")
        check(torch.equal(BB.collective_fn(name)(x), x),
              f"busbench: {name} at one rank is not a copy of its input")
    log(f"busbench on {card}: {n} NCCL rank(s), every collective a copy of "
        f"its buffer (ppermute returns it without a call): these times "
        f"measure no link")
    return doc["rows"]


# ------------------------------------------------ phase 13: the precision tier

def _prec_inputs(cfg, seed, seq, bs, num_steps):
    """train_fsdp.run's shards (seeded init, this rank's rows) and first
    global batch for ``cfg``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shards = fsdp.shard_params_fsdp(T.init_params(cfg, gen, "cuda"))
    ib, lb = next(train_fsdp.fsdp_batches(cfg.vocab_size, seq, bs,
                                          num_steps, seed))
    return shards, (torch.as_tensor(ib, device="cuda"),
                    torch.as_tensor(lb, device="cuda"))


def _prec_expect(L: int) -> dict:
    """The kernels one int8_pallas_bwd FSDP step launches (remat
    "full"): K5 each projection's forward and its recompute, K4 its dX
    and dW, the flash forward twice a layer and its backward once."""
    return {"int8_matmul_fused": (Q.INT8_FUSED_COUNTS,
                                  L * len(PROJECTIONS) * 2),
            "int8_matmul": (Q.INT8_COUNTS, L * len(PROJECTIONS) * 2),
            "flash_attention_fwd": (FA.FWD_COUNTS, L * 2),
            "flash_attention_bwd": (FA.BWD_COUNTS, L)}


def _reset_kernel_counts():
    for c in (Q.COUNTS, Q.BWD_COUNTS, Q.INT8_COUNTS, Q.INT8_FUSED_COUNTS,
              FA.FWD_COUNTS, FA.BWD_COUNTS, C.COUNTS):
        c.reset()
    C.COLLECTIVES.reset()


def _first_layer(tree):
    """Layer 0 of every stacked leaf (``Q8`` moments field by field) and
    the final norm: rows the int8 update treats alone, small enough for
    the CPU."""
    def cut(v):
        if isinstance(v, optim8.Q8):
            return optim8.Q8(v.q[:1], v.scale[:1])
        return v[:1]
    return {"layers": {k: cut(v) for k, v in tree["layers"].items()},
            "final_norm": tree["final_norm"]}


def _to(tree, device):
    """A copy of a tree of tensors and ``Q8`` moments on ``device``."""
    def leaf(t):
        if isinstance(t, optim8.Q8):
            return optim8.Q8(*(leaf(x) for x in t))
        return t.detach().to(device, copy=True)
    return fsdp.optim.tree_map(leaf, tree)


def _adam8_readings(shards, grads) -> dict:
    """The int8 moments on the card against ``optim8.adam8_update`` on a
    CPU copy of the same params, grads and state, two updates (the second
    dequantises the first's codes), compared on layer 0 of every stacked
    leaf and the final norm; and the update's CUDA-event time on the
    whole tree beside its byte bound and full-precision Adam's."""
    params = _to(shards, "cuda")
    state = fsdp.init_fsdp_opt_state8(params)
    cpu_p = _to(_first_layer(params), "cpu")
    cpu_g = _to(_first_layer(grads), "cpu")
    cpu_s = optim8.adam8_init(cpu_p)
    for _ in range(2):
        optim8.adam8_update(grads, state, params, **PREC_ADAM)
        optim8.adam8_update(cpu_g, cpu_s, cpu_p, **PREC_ADAM)
    torch.cuda.synchronize()
    card = _to({"p": _first_layer(params), "mu": _first_layer(state.mu),
                "nu": _first_layer(state.nu)}, "cpu")
    unequal = {}
    for key, want in (("p", cpu_p), ("mu", cpu_s.mu), ("nu", cpu_s.nu)):
        for path, a in fsdp.optim.tree_leaves(card[key]):
            b = fsdp.optim.tree_get(want, path)
            pairs = (zip(("q", "scale"), a, b) if isinstance(a, optim8.Q8)
                     else (("", a, b),))
            for field, x, y in pairs:
                if not torch.equal(x, y):
                    unequal["/".join((key, *path, field))] = int(
                        (x != y).sum())
    n_params = sum(t.numel() for _, t in fsdp.optim.tree_leaves(params))
    # bytes: each param read and written (bf16), its grad read (bf16),
    # each moment's code read and written and its row scale likewise
    rows = sum(t.q.numel() // t.q.shape[-1] if isinstance(t, optim8.Q8)
               else 0 for _, t in fsdp.optim.tree_leaves(state.mu))
    b8 = n_params * (2 + 2 + 2 + 2 * 2) + rows * 2 * 2 * 4
    full = fsdp.init_fsdp_opt_state(params)
    bfull = n_params * (2 + 2 + 2 + 2 * 2 * 2)
    ms8 = time_ms(lambda: optim8.adam8_update(grads, state, params,
                                              **PREC_ADAM), iters=3, warmup=1)
    msf = time_ms(lambda: fsdp.optim.adam_update(grads, full, params,
                                                 **PREC_ADAM),
                  iters=3, warmup=1)
    del full
    # why the update takes its square roots through optim8._sqrt: the
    # CPU's vectorised torch.sqrt against the card's (correctly rounded)
    gen = torch.Generator().manual_seed(SEED)
    v = torch.rand(4_000_000, generator=gen) * 10.0 ** (
        torch.rand(4_000_000, generator=gen) * 12 - 14)
    card_root = torch.sqrt(v.cuda()).cpu()
    sqrt_off = (int((torch.sqrt(v) != card_root).sum()),
                int((optim8._sqrt(v) != card_root).sum()))
    return {"unequal": unequal, "n_params": n_params, "sqrt_off": sqrt_off,
            "adam8_ms": ms8, "adam8_bound_ms": b8 / HBM_BYTES_PER_S * 1e3,
            "adam_ms": msf, "adam_bound_ms": bfull / HBM_BYTES_PER_S * 1e3,
            "state8_bytes": optim8.state_bytes(state),
            "state_full_bytes": 2 * 2 * n_params}


def _prec_attention_reading(cap: dict) -> float:
    """The flash forward and backward on a step's captured attention
    inputs and output grad against the plain versions, at FA's limits
    (``_fa_reading``): the largest gate ratio (<= 1 passes)."""
    q, k, v, scale, do = (cap[n] for n in ("q", "k", "v", "scale", "do"))
    o, lse = FA.flash_attention_fwd(q, k, v, scale)
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    _, r_o = _fa_reading("precision attention fwd", "O", o, ref_o, "fwd")
    e_lse = float((lse - ref_lse).abs().max())
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
    refs = FA.flash_attention_bwd_plain(q, k, v, do, scale)
    r_g = [_fa_reading("precision attention bwd", n, g, r, "bwd")[1]
           for n, g, r in zip(("dq", "dk", "dv"), grads, refs)]
    ratio = max(r_o, e_lse / FA.LSE_ATOL, *r_g)
    log(f"precision attention: layer 0 of the step (q {tuple(q.shape)}), "
        f"logsumexp max_abs_err {e_lse:.3e} (atol {FA.LSE_ATOL}); gate "
        f"ratio {ratio:.4f}")
    return ratio


def precision_parity_phase() -> float:
    """Phase 13a's step-0 parity on the one-rank NCCL group (made here if
    there is none, as torchrun would give it): the FSDP step with
    quantised gathers and grads at int8_pallas_bwd through K5, K4 and the
    flash kernels, against the same step with the plain int8 products
    (bit-equal) and against the plain int8 products with plain attention
    (``PREC_PLAIN_*``); the flash kernels on the step's own layer-0
    attention inputs at FA's limits; the gathered weights bit for bit
    the int8 round-trip; the launches and the collectives of the kernel
    path; the int8 moments on the card against the CPU's.  Returns the
    kernel path's loss."""
    mesh.init_process_group("cuda")
    p = PREC_TRAIN
    L = PREC_CFG.num_hidden_layers
    shards, batch = _prec_inputs(PREC_CFG, p["seed"], p["seq"], p["bs"],
                                 p["num_steps"])
    failures = []
    for name, x in (("layers/wq[0]", shards["layers"]["wq"][0]),
                    ("layers/w_down[0]", shards["layers"]["w_down"][0]),
                    ("embed", shards["embed"])):
        got = fsdp._gather_leaf(x, ("dp",), "dp", True)
        want = Q.dequantize(*Q.quantize_int8(x, axis=-1), x.dtype)
        if not torch.equal(got, want):
            failures.append(f"precision gather: {name} is not the int8 "
                            f"round-trip")
    log(f"precision gather: layer and root leaves are the int8 round-trip "
        f"bit for bit: {not failures}")
    # the kernel path's first attention call (layer 0's forward): its
    # inputs, and the grad its output receives in the backward
    captured, flash = {}, T.flash_attention

    def capture(q, k, v, scale):
        o = flash(q, k, v, scale)
        if "q" not in captured:
            captured.update(q=q.detach().clone(), k=k.detach().clone(),
                            v=v.detach().clone(), scale=scale)
            o.register_hook(lambda g: captured.setdefault(
                "do", g.detach().clone()))
        return o
    plain_cfg = dataclasses.replace(PREC_CFG, attention_impl="xla")
    want_coll = fsdp_quantized_step_collectives(
        shards, remat=PREC_CFG.remat, quantized_grads=True)
    out = {}
    for name, cfg, plain in (("kernel", PREC_CFG, False),
                             ("plain int8", PREC_CFG, True),
                             ("plain", plain_cfg, True)):
        _reset_kernel_counts()
        t = time.perf_counter()
        vg = fsdp.make_fsdp_value_and_grad(shards, cfg, quantized_gather=True,
                                           quantized_grads=True)
        T.flash_attention = capture if name == "kernel" else flash
        try:
            with (Q.plain_int8_products() if plain
                  else contextlib.nullcontext()):
                loss, grads = vg(shards, batch)
        finally:
            T.flash_attention = flash
        torch.cuda.synchronize()
        counts = {k: (c.launches, c.plain_calls)
                  for k, (c, _) in _prec_expect(L).items()}
        coll = C.COLLECTIVES.read()
        out[name] = (float(loss), grads)
        log(f"precision parity: {name} loss {float(loss)!r} "
            f"({time.perf_counter() - t:.1f} s); (launches, plain) "
            f"{json.dumps(counts)}; collectives {json.dumps(coll)}")
        if name == "kernel":
            for k, (_, per) in _prec_expect(L).items():
                if counts[k] != (per, 0):
                    failures.append(f"precision parity: {k} (launches, "
                                    f"plain) {counts[k]} != ({per}, 0)")
            if coll != want_coll:
                failures.append(f"precision parity: collectives {coll} != "
                                f"the contract's {want_coll}")
    (lk, gk), (lp, gp), (lx, gx) = out["kernel"], out["plain int8"], \
        out["plain"]
    unequal = {}
    for path, a in fsdp.optim.tree_leaves(gk):
        b = fsdp.optim.tree_get(gp, path)
        if not torch.equal(a, b):
            unequal["/".join(path)] = float((a.float() - b.float()).abs()
                                            .max())
    rel = {}
    for path, a in fsdp.optim.tree_leaves(gp):
        b = fsdp.optim.tree_get(gx, path).float()
        rel["/".join(path)] = float(torch.linalg.vector_norm(a.float() - b)
                                    / torch.linalg.vector_norm(b))
    worst = max(rel, key=rel.get)
    log(f"precision step-0: loss kernel {lk!r} plain int8 {lp!r} (bit-equal "
        f"{lk == lp}); grad leaves not bit-equal: {json.dumps(unequal)}")
    log(f"precision plain: |loss flash - plain attention| {abs(lp - lx):.6f} "
        f"(atol {PREC_PLAIN_LOSS_ATOL}); grad relative L2, worst leaf "
        f"{worst} {rel[worst]:.5f} (limit {PREC_PLAIN_GRAD_REL_L2}); all "
        f"leaves {json.dumps({k: round(v, 6) for k, v in rel.items()})}")
    if not all(np.isfinite((lk, lp, lx))):
        failures.append("precision step-0: non-finite loss")
    if lk != lp or unequal:
        failures.append(f"precision step-0: loss kernel {lk!r} vs plain int8 "
                        f"{lp!r}, {len(unequal)} grad leaves not bit-equal")
    if abs(lp - lx) > PREC_PLAIN_LOSS_ATOL:
        failures.append(f"precision plain: |loss| {abs(lp - lx)} over "
                        f"{PREC_PLAIN_LOSS_ATOL}")
    if not rel[worst] <= PREC_PLAIN_GRAD_REL_L2:
        failures.append(f"precision plain: {worst} relative L2 {rel[worst]} "
                        f"over {PREC_PLAIN_GRAD_REL_L2}")
    del out, gp, gx
    torch.cuda.empty_cache()
    ratio = _prec_attention_reading(captured)
    if not ratio <= 1.0:
        failures.append(f"precision attention: the flash kernels on the "
                        f"step's layer-0 inputs against plain attention, "
                        f"gate ratio {ratio:.3f}")
    r = _adam8_readings(shards, gk)
    log(f"precision adam8: card against the CPU after two updates, leaves "
        f"not bit-equal (elements): {json.dumps(r['unequal'])}; square roots "
        f"of 4 000 000 f32 draws off the card's: torch.sqrt on the CPU "
        f"{r['sqrt_off'][0]}, optim8._sqrt {r['sqrt_off'][1]}")
    log(f"precision adam8: {r['n_params']} params a rank; moments at rest "
        f"int8 {r['state8_bytes']} bytes against bf16 "
        f"{r['state_full_bytes']} ({r['state8_bytes'] / r['state_full_bytes']:.4f}); "
        f"adam8_update {r['adam8_ms']:.3f} ms (byte bound "
        f"{r['adam8_bound_ms']:.3f}, {r['adam8_ms'] / r['adam8_bound_ms']:.1f}x), "
        f"adam_update {r['adam_ms']:.3f} ms (bound {r['adam_bound_ms']:.3f}, "
        f"{r['adam_ms'] / r['adam_bound_ms']:.1f}x)")
    if r["unequal"]:
        failures.append(f"precision adam8: {len(r['unequal'])} leaves of the "
                        f"card's update differ from the CPU's")
    del shards, gk
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return lk


def precision_train_phase(card: str, loss0: float) -> dict:
    """Phase 13a's run: ``PREC_TRAIN["num_steps"]`` steps of
    ``train_fsdp.run`` with quantised gathers and grads and int8 state:
    launches exact, plain calls 0, every step's collectives the
    contract's, the step-0 loss bit-equal to the parity's kernel path,
    losses finite and falling; the state's bytes at rest, step time,
    tokens/s, MFU, peak memory, and a profile of the last step.
    Returns the launch counts."""
    from torch.profiler import ProfilerActivity, profile
    p = PREC_TRAIN
    L, n = PREC_CFG.num_hidden_layers, p["num_steps"]
    expect = _prec_expect(L)
    _reset_kernel_counts()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, loss):
        if i == n - 2:
            prof.start()
            marks["t"] = time.perf_counter()
        elif i == n - 1:
            marks["wall_us"] = (time.perf_counter() - marks["t"]) * 1e6
            prof.stop()

    res = train_fsdp.run(p["model"], precision=p["precision"],
                         attention=p["attention"], batch_size=p["bs"],
                         seq=p["seq"], num_steps=n, device="cuda",
                         seed=p["seed"], quantized_gather=True,
                         quantized_grads=True, state_precision="int8",
                         on_step=on_step, log=log)
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    want = {k: n * per for k, (_, per) in expect.items()}
    losses, times = res["losses"], res["step_times_s"]
    steps = [b - a for a, b in zip([0.0] + times[:-1], times)]
    step_s = statistics.median(steps[1:n - 1])
    tok_s = p["seq"] * p["bs"] / step_s
    flops_tok = res["model_flops_per_token"]
    # the tree's shapes (drawn on the card, kept on the meta device)
    shapes = T.init_params(PREC_CFG, torch.Generator(device="cuda"), "meta")
    n_params = sum(t.numel() for _, t in fsdp.optim.tree_leaves(shapes))
    full_bytes = 2 * 2 * n_params   # two bf16 moments
    want_coll = fsdp_quantized_step_collectives(
        shapes, remat=PREC_CFG.remat, quantized_grads=True)
    log(f"precision train on {card}: losses {losses}; collectives a step "
        f"{json.dumps(res['collectives'][-1])}")
    log(f"precision train: step times (s, host clock, each ending in a "
        f"sync) {steps}; median of steps 1-{n - 2} {step_s * 1e3:.1f} ms, "
        f"{tok_s:.1f} tokens/s, MFU {flops_tok * tok_s / PEAK_BF16_FLOPS:.4f}"
        f"; peak memory {res['peak_memory_bytes'] / 2 ** 30:.3f} GiB; Adam "
        f"moments at rest {res['opt_state_bytes']} bytes (int8) against "
        f"{full_bytes} (bf16), ratio {res['opt_state_bytes'] / full_bytes:.4f}")
    log(f"precision train launches (kernel, plain): {json.dumps(counts)}; "
        f"expected kernel launches {json.dumps(want)}")
    log(f"precision train: step-0 loss {losses[0]!r}, the parity phase's "
        f"kernel path {loss0!r}, bit-equal {losses[0] == loss0}")
    _step_profile(prof, marks["wall_us"], "precision train", n - 1)
    check(losses[0] == loss0, f"precision train: step-0 loss {losses[0]!r} "
          f"of the run is not the parity phase's {loss0!r}")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (want[name], 0),
              f"precision train: {name} (launches, plain) "
              f"{(launches, plain)} != ({want[name]}, 0)")
    for i, c in enumerate(res["collectives"]):
        check(c == want_coll, f"precision train: step {i} collectives {c} "
              f"!= the contract's {want_coll}")
    check(all(np.isfinite(losses)), f"precision train: non-finite loss in "
          f"{losses}")
    check(losses[-1] < losses[0], f"precision train: step-{n - 1} loss "
          f"{losses[-1]} is not below step-0 loss {losses[0]}")
    return {k: v[0] for k, v in counts.items()}


def remat_phase(card: str) -> dict:
    """Phase 13b: SMOLLM3_3B_L8 at bf16 with flash attention on the
    one-rank group, one FSDP value-and-grad after a warm-up under each
    remat policy.  Gates: the flash forward's launches a step (2·L under
    ``full``, ``save_dots`` and ``save_dots_q8``, whose policies keep only
    the projections; L under ``save_attn``) and the backward's L, plain
    calls 0; ``save_attn`` and ``save_dots`` bit-equal to ``full`` in loss
    and grads; ``save_dots_q8``'s loss within rel ``REMAT_Q8_LOSS_RTOL``
    of ``full``'s and not closer than ``REMAT_Q8_LOSS_MIN_RTOL``, and the
    bytes it keeps beyond ``full``'s at most ``REMAT_Q8_SAVED_RATIO`` of
    ``save_dots``'.  Logs each policy's step ms and its peak above the
    step's start."""
    cfg0 = train_fsdp.model_config(REMAT["model"])
    L = cfg0.num_hidden_layers
    shards, batch = _prec_inputs(cfg0, REMAT["seed"], REMAT["seq"],
                                 REMAT["bs"], REMAT["num_steps"])
    want_fwd = {"full": 2 * L, "save_attn": L, "save_dots": 2 * L,
                "save_dots_q8": 2 * L}
    rows, failures, ref = {}, [], None
    for policy in T.REMAT_POLICIES:
        cfg = dataclasses.replace(cfg0, remat_policy=policy)
        vg = fsdp.make_fsdp_value_and_grad(shards, cfg)
        vg(shards, batch)   # the warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        _reset_kernel_counts()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, grads = vg(shards, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() - start
        launches = {"flash_attention_fwd": (FA.FWD_COUNTS.launches,
                                            FA.FWD_COUNTS.plain_calls),
                    "flash_attention_bwd": (FA.BWD_COUNTS.launches,
                                            FA.BWD_COUNTS.plain_calls)}
        rows[policy] = {"loss": float(loss), "ms": round(ms, 1),
                        "peak_above_start_gib": round(peak / 2 ** 30, 3),
                        "peak_bytes": peak, "launches": launches}
        log(f"remat {policy} on {card}: loss {float(loss)!r}, step {ms:.1f} "
            f"ms (host clock, one fwd+bwd), peak above the start "
            f"{peak / 2 ** 30:.3f} GiB, FA (launches, plain) "
            f"{json.dumps(launches)}")
        if launches != {"flash_attention_fwd": (want_fwd[policy], 0),
                        "flash_attention_bwd": (L, 0)}:
            failures.append(f"remat {policy}: FA launches {launches} != "
                            f"forward {want_fwd[policy]}, backward {L}")
        if policy == "full":
            ref = (float(loss), grads)
            continue
        if policy == "save_dots_q8":
            rel = abs(float(loss) - ref[0]) / abs(ref[0])
            saved = {k: (rows[k]["peak_bytes"] - rows["full"]["peak_bytes"])
                     for k in ("save_dots", "save_dots_q8")}
            ratio = saved["save_dots_q8"] / saved["save_dots"]
            log(f"remat save_dots_q8: |loss - full| / full {rel:.3e} "
                f"(limits {REMAT_Q8_LOSS_MIN_RTOL}, {REMAT_Q8_LOSS_RTOL}); "
                f"bytes kept beyond full's {saved['save_dots_q8']} against "
                f"save_dots' {saved['save_dots']}, ratio {ratio:.4f} (limit "
                f"{REMAT_Q8_SAVED_RATIO})")
            if not REMAT_Q8_LOSS_MIN_RTOL <= rel <= REMAT_Q8_LOSS_RTOL:
                failures.append(f"remat save_dots_q8: loss rel {rel} "
                                f"outside [{REMAT_Q8_LOSS_MIN_RTOL}, "
                                f"{REMAT_Q8_LOSS_RTOL}]")
            if not ratio <= REMAT_Q8_SAVED_RATIO:
                failures.append(f"remat save_dots_q8: saved bytes ratio "
                                f"{ratio} over {REMAT_Q8_SAVED_RATIO}")
        else:
            unequal = [("/".join(path)) for path, a in
                       fsdp.optim.tree_leaves(grads)
                       if not torch.equal(a, fsdp.optim.tree_get(ref[1],
                                                                 path))]
            log(f"remat {policy}: loss bit-equal to full's "
                f"{float(loss) == ref[0]}; grad leaves not bit-equal "
                f"{unequal}")
            if float(loss) != ref[0] or unequal:
                failures.append(f"remat {policy}: not bit-equal to full "
                                f"({len(unequal)} grad leaves)")
        del grads
    del shards, ref
    torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return rows


def _grad_rel_l2(ga, gb) -> dict:
    """Each grad leaf's relative L2 distance of ``ga`` from ``gb``."""
    out = {}
    for path, a in fsdp.optim.tree_leaves(ga):
        b = fsdp.optim.tree_get(gb, path).float()
        out["/".join(path)] = float(torch.linalg.vector_norm(a.float() - b)
                                    / torch.linalg.vector_norm(b))
    return out


def _bench_step0(cfg, shards, batch, plain: bool):
    """One FSDP value-and-grad of a 13c row on its inputs: the kernel
    path with the first layer's attention inputs and output grad and
    K6's first operands at each projection shape captured, or (``plain``)
    with the int8 products plain (``int8*``) or the plain fp8 recipe
    (``fp8_pallas`` as ``fp8``).  Returns (loss, grads, captures)."""
    flash, k6 = T.flash_attention, Q.fp8_matmul_kernel
    att, ops = {}, {}

    def capture(q, k, v, scale):
        o = flash(q, k, v, scale)
        if "q" not in att:
            att.update(q=q.detach().clone(), k=k.detach().clone(),
                       v=v.detach().clone(), scale=scale)
            o.register_hook(lambda g: att.setdefault("do", g.detach()
                                                     .clone()))
        return o

    def k6_capture(aq, a_s, bt, b_s, out_dtype=torch.bfloat16):
        ops.setdefault((aq.shape[1], bt.shape[0]), tuple(
            t.detach().clone() for t in (aq, a_s, bt, b_s)))
        return k6(aq, a_s, bt, b_s, out_dtype)

    if plain and cfg.matmul_precision == "fp8_pallas":
        cfg = dataclasses.replace(cfg, matmul_precision="fp8")
    vg = fsdp.make_fsdp_value_and_grad(shards, cfg)
    if not plain:
        T.flash_attention, Q.fp8_matmul_kernel = capture, k6_capture
    try:
        with (Q.plain_int8_products() if plain
              else contextlib.nullcontext()):
            loss, grads = vg(shards, batch)
    finally:
        T.flash_attention, Q.fp8_matmul_kernel = flash, k6
    torch.cuda.synchronize()
    return float(loss), grads, att, ops


def precision_bench_parity_phase() -> dict:
    """Phase 13c's gates, on each row's own inputs
    (``prec_bench.row_inputs``) on the one-rank group, before the rows
    run and uncounted: step 0 through the kernels against the plain
    versions at the shapes the rows give them (``PREC_BENCH``'s
    comment).  Returns each precision's kernel-path step-0 loss."""
    b = PREC_BENCH
    dev = mesh.init_process_group("cuda")
    atol, rtol = Q.TOLERANCE[torch.bfloat16]
    failures, loss0 = [], {}
    for precision in b["precisions"]:
        cfg, shards, batch = prec_bench.row_inputs(b["model"], precision,
                                                   b["seq"], b["bs"], dev)
        lk, gk, att, ops = _bench_step0(cfg, shards, batch, plain=False)
        loss0[precision] = lk
        ratio = _prec_attention_reading(att)
        if not ratio <= 1.0:
            failures.append(f"precision bench attention: {precision} row's "
                            f"layer-0 inputs, gate ratio {ratio:.3f}")
        if not np.isfinite(lk):
            failures.append(f"precision bench {precision}: non-finite "
                            f"step-0 loss")
        for (K, N), (aq, a_s, bt, b_s) in sorted(ops.items()):
            got = Q.fp8_matmul_kernel(aq, a_s, bt, b_s)
            ref = Q.fp8_matmul(aq, a_s, bt.t(), b_s, torch.bfloat16)
            r = gate_ratio(got, ref, atol, rtol)
            log(f"precision bench fp8_matmul ({aq.shape[0]}, {K}) x ({K}, "
                f"{N}), the row's first operands: max_abs_err "
                f"{float((got.float() - ref.float()).abs().max()):.3e}, gate "
                f"ratio {r:.4f} (atol {atol}, rtol {rtol})")
            if not r <= 1.0:
                failures.append(f"precision bench fp8_matmul: ({K}, {N}) "
                                f"gate ratio {r:.3f}")
        if precision == "bf16":
            log(f"precision bench {precision}: step-0 loss {lk!r}")
            del gk, shards
            continue
        lp, gp, _, _ = _bench_step0(cfg, shards, batch, plain=True)
        rel = _grad_rel_l2(gk, gp)
        worst = max(rel, key=rel.get)
        unequal = [k for k, v in rel.items() if v != 0.0]
        log(f"precision bench {precision}: step-0 loss kernel {lk!r} plain "
            f"{lp!r}; grad relative L2, worst leaf {worst} "
            f"{rel[worst]:.5f}; all leaves "
            f"{json.dumps({k: round(v, 6) for k, v in rel.items()})}")
        if precision.startswith("int8"):
            if lk != lp or any(not torch.equal(
                    a, fsdp.optim.tree_get(gp, path))
                    for path, a in fsdp.optim.tree_leaves(gk)):
                failures.append(f"precision bench {precision} step-0: loss "
                                f"{lk!r} vs plain {lp!r}, grad leaves not "
                                f"bit-equal {unequal}")
        else:
            if ops.keys() != {(K, N) for _, K, N in PROJECTIONS}:
                failures.append(f"precision bench fp8_matmul: captured "
                                f"shapes {sorted(ops)}")
            if abs(lk - lp) > PREC_BENCH_FP8_LOSS_ATOL:
                failures.append(f"precision bench {precision} step-0: |loss "
                                f"kernel - plain| {abs(lk - lp)} over "
                                f"{PREC_BENCH_FP8_LOSS_ATOL}")
            if not rel[worst] <= PREC_BENCH_FP8_GRAD_REL_L2:
                failures.append(f"precision bench {precision} step-0: "
                                f"{worst} relative L2 {rel[worst]} over "
                                f"{PREC_BENCH_FP8_GRAD_REL_L2}")
        del gk, gp, shards, ops, att
        torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return loss0


def precision_bench_phase(card: str, loss0: dict) -> tuple[list, dict]:
    """Phase 13c: ``train.precision_benchmark.run_one`` at
    ``PREC_BENCH``'s shapes for each of its precisions on the one-rank
    group: the reference's row keys, no failure, finite losses, each
    row's step-0 loss bit-equal to its kernel path's in
    :func:`precision_bench_parity_phase` (``loss0``); the launches of K6
    (fp8_pallas), K5 and K4 (int8_pallas_bwd) and the flash kernels
    (every row) exact, plain calls 0.  Returns the rows and the launch
    counts."""
    b = PREC_BENCH
    L = T.SMOLLM3_3B_L8.num_hidden_layers
    per = len(PROJECTIONS) * L * 2 * b["num_steps"]
    n_rows = len(b["precisions"])
    expect = {"fp8_matmul": (Q.COUNTS, per),
              "int8_matmul_fused": (Q.INT8_FUSED_COUNTS, per),
              "int8_matmul": (Q.INT8_COUNTS, per),
              "flash_attention_fwd": (FA.FWD_COUNTS,
                                      2 * L * b["num_steps"] * n_rows),
              "flash_attention_bwd": (FA.BWD_COUNTS,
                                      L * b["num_steps"] * n_rows)}
    _reset_kernel_counts()
    rows = []
    for precision in b["precisions"]:
        first = {}
        row = prec_bench.run_one(b["model"], precision, b["seq"],
                                 b["num_steps"], b["bs"],
                                 Path("build/precision"), device="cuda",
                                 log=log, on_step=lambda i, loss, first=first:
                                 first.setdefault(i, loss))
        rows.append(row)
        check(set(row) == PREC_BENCH_KEYS and "failure" not in row,
              f"precision bench: row keys {sorted(row)}")
        check(np.isfinite(row["avg_loss"]) and row["tokens_per_second"] > 0,
              f"precision bench: {precision} row {row}")
        check(first[0] == loss0[precision], f"precision bench: {precision} "
              f"row's step-0 loss {first[0]!r} is not its parity's "
              f"{loss0[precision]!r}")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls) for k, (c, _) in expect.items()}
    log(f"precision bench on {card}: rows {json.dumps(rows)}")
    log(f"precision bench launches (kernel, plain): {json.dumps(counts)}; "
        f"expected {json.dumps({k: v for k, (_, v) in expect.items()})}")
    for name, (launches, plain) in counts.items():
        check((launches, plain) == (expect[name][1], 0),
              f"precision bench: {name} (launches, plain) "
              f"{(launches, plain)} != ({expect[name][1]}, 0)")
    return rows, {k: v[0] for k, v in counts.items()}


# ------------------------------------------- parent-versus-change timing

def _parent_libs(csrc: Path) -> dict:
    """K1's, K2's, K3's, K4/K5's, K6's, K7's and the flash attention's
    libraries built from another commit's ``csrc`` (one nvcc each, in
    parallel) into ``build/parent_kernels``, with that commit's C
    signatures (K1 then took a scratch buffer of
    ``paged_decode_scratch_floats``; K2's, four passes, a scratch of
    ``paged_decode_q8_scratch_floats`` always nonzero; K4 had no
    GEMV)."""
    out = loader.BUILD_DIR.parent / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("paged_decode", "paged_decode_q8", "flash_prefill",
                 "fp8_matmul", "flash_attention", "int8_matmul",
                 "ag_matmul"):
        so = out / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [loader._nvcc(), *loader.NVCC_FLAGS, f"-I{csrc}", "-o", str(so),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"parent {name}: nvcc failed:\n{text}")
        libs[name] = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs["flash_prefill"].flash_prefill_launch.argtypes = [P] * 6 + [I] * 8 \
        + [P]
    libs["fp8_matmul"].fp8_matmul_launch.argtypes = [P] * 7 + [I] * 3 + [P]
    libs["flash_attention"].flash_attn_bwd_launch.argtypes = [P] * 10 \
        + [I] * 5 + [F, P]
    libs["flash_attention"].flash_attn_fwd_launch.argtypes = [P] * 5 \
        + [I] * 5 + [F, P]
    libs["paged_decode"].paged_decode_launch.argtypes = [P] * 7 + [I] * 7 \
        + [P]
    libs["paged_decode"].paged_decode_scratch_floats.argtypes = [I] * 6
    libs["paged_decode"].paged_decode_scratch_floats.restype = \
        ctypes.c_int64
    libs["paged_decode_q8"].paged_decode_q8_launch.argtypes = [P] * 10 \
        + [I] * 6 + [P]
    libs["paged_decode_q8"].paged_decode_q8_scratch_floats.argtypes = \
        [I] * 6
    libs["paged_decode_q8"].paged_decode_q8_scratch_floats.restype = \
        ctypes.c_int64
    libs["int8_matmul"].int8_matmul_launch.argtypes = [P] * 5 + [I] * 4 \
        + [P]
    libs["int8_matmul"].int8_matmul_fused_launch.argtypes = [P] * 6 \
        + [I] * 3 + [P]
    libs["ag_matmul"].ag_matmul_launch.argtypes = [P] * 3 + [I] * 4 + [P]
    return libs


def _turns(old, new, timer=time_ms) -> tuple[list, list]:
    """CUDA-event times in turns: old, new, new, old."""
    a, b = timer(old), timer(new)
    c, d = timer(new), timer(old)
    return [a, d], [b, c]


def _compare_gemms(libs, ptr, stream, gen) -> dict:
    """--parent-csrc for K7 (one layer's seven projections at M = 8192
    and the four-rank chunks), K5 and K4's training products (the
    seven projections' forward, dX and dW at M = 8192; K5 in CUDA-graph
    replays) and K4 at decode (M = 8, the seven projections and the
    unembedding, CUDA-graph replays): each build gated against the plain
    version (K7 at its tolerance, K4 and K5 bit for bit) and timed in
    turns.  The parent's
    K4 takes each operand as its wrapper passed it: dW's A as a
    transposed copy of X's (M, K) codes, made in the timed call."""
    res, bf16 = {}, torch.bfloat16
    M = TRAIN["seq"] * TRAIN["bs"]

    def launched(name, rc):
        check(rc == 0, f"parent {name}: CUDA error {rc}")

    # K7: the same operands for both builds, the chunk a strided view
    atol, rtol = C.TOLERANCE[bf16]
    tot = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    chunks, seen = {}, {}
    for name, K, Kc, N in [(n, K, K, N) for n, K, N in PROJECTIONS] \
            + AG_CHUNKS:
        if (K, Kc, N) not in seen:
            ops = []
            for i in range(3):
                a = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
                w = (torch.randn((Kc, N), generator=gen, device="cuda")
                     * 0.02).to(bf16)
                c0 = (i + 1) % (K // Kc) * Kc
                ops.append((a[:, c0:c0 + Kc], w))
            o7 = torch.empty((M, N), device="cuda", dtype=bf16)

            def old_k7(a2, w, o7=o7, N=N, Kc=Kc):
                launched("ag_matmul", libs["ag_matmul"].ag_matmul_launch(
                    ptr(a2), ptr(w), ptr(o7), M, N, Kc, a2.stride(0),
                    stream()))
                return o7

            ref = C.ag_matmul_plain(*ops[0])
            ratios = {}
            for nm, fn in (("parent", old_k7), ("change", C.ag_matmul_kernel)):
                ratios[nm] = gate_ratio(fn(*ops[0]), ref, atol, rtol)
                check(ratios[nm] <= 1.0, f"compare ag_matmul {nm}: ({M}, "
                      f"{Kc}) x ({Kc}, {N}) gate ratio {ratios[nm]:.3f}")
            it = iter(range(10 ** 9))
            old, new = _turns(lambda: old_k7(*ops[next(it) % 3]),
                              lambda: C.ag_matmul_kernel(*ops[next(it) % 3]))
            seen[(K, Kc, N)] = (old, new)
            log(f"compare ag_matmul ({M}, {Kc}) x ({Kc}, {N})"
                f"{', a strided' if Kc < K else ''}: parent {old} ms, change "
                f"{new} ms; gate ratios {json.dumps(ratios)}")
            del ops, ref, o7
            torch.cuda.empty_cache()
        old, new = seen[(K, Kc, N)]
        if Kc < K:
            chunks[name] = {"parent_ms": old, "change_ms": new}
            continue
        tot["parent"] = [a + b for a, b in zip(tot["parent"], old)]
        tot["change"] = [a + b for a, b in zip(tot["change"], new)]
    res["ag_matmul"] = {"parent_ms": tot["parent"],
                        "change_ms": tot["change"],
                        "four_rank_chunks": chunks}
    log(f"compare ag_matmul, one layer's 7 projections: parent "
        f"{tot['parent']} ms, change {tot['change']} ms")

    # K5 and K4's training products
    lib8 = libs["int8_matmul"]
    t5 = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    t4 = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    for name, K, N in PROJECTIONS:
        sets = []
        for _ in range(3):
            x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 * 0.02).to(bf16)
            g = (torch.randn((M, N), generator=gen, device="cuda")
                 * 1e-3).to(bf16)
            wq_t, ws_t = Q.quantize_int8(w.t(), axis=-1)
            gq, gs = Q.quantize_int8(g, axis=-1)
            wq_n, ws_n = Q.quantize_int8(w, axis=1)
            xq_t, xs_t = Q.quantize_int8(x.t(), axis=-1)
            gq_t, gs_t = Q.quantize_int8(g.t(), axis=-1)
            sets.append(dict(
                x=x, wq_t=wq_t, ws_t=ws_t,
                dx=(gq, gs, wq_n, ws_n.T, (1, 1)),
                dw=(xq_t, xs_t, gq_t, gs_t.T, (1, 1)),
                # the parent's dW operands: X's and g's (M, ·) codes
                xq_m=xq_t.t().contiguous(), gq_m=gq_t.t().contiguous()))
            del w, g
        codes = torch.empty((M, K), dtype=torch.int8, device="cuda")
        xs5 = torch.empty((M,), device="cuda")
        out = {"x": torch.empty((M, N), device="cuda", dtype=bf16),
               "dx": torch.empty((M, K), device="cuda", dtype=bf16),
               "dw": torch.empty((K, N), device="cuda", dtype=bf16)}

        def old_k5(d):
            launched("int8_matmul_fused", lib8.int8_matmul_fused_launch(
                ptr(d["x"]), ptr(d["wq_t"]), ptr(codes), ptr(xs5),
                ptr(d["ws_t"]), ptr(out["x"]), M, N, K, stream()))
            return out["x"]

        def new_k5(d):
            return Q.int8_matmul_fused_kernel(d["x"], d["wq_t"], d["ws_t"],
                                              b_kmajor=True)

        def old_k4(d, prod):
            if prod == "dx":
                gq, gs, wq_n, ws_n, _ = d["dx"]
                a, b, sa, sb, Mo, No, Kc, kmaj = (gq, wq_n, gs, ws_n, M, K,
                                                  N, 1)
            else:   # the parent's wrapper copied X's codes transposed
                _, xs_t, _, gs_n, _ = d["dw"]
                a, b, sa, sb, Mo, No, Kc, kmaj = (
                    d["xq_m"].t().contiguous(), d["gq_m"], xs_t, gs_n, K, N,
                    M, 0)
            launched("int8_matmul", lib8.int8_matmul_launch(
                ptr(a), ptr(b), ptr(sa), ptr(sb), ptr(out[prod]), Mo, No, Kc,
                kmaj, stream()))
            return out[prod]

        s0 = sets[0]
        ref = Q.int8_matmul_fused(s0["x"], s0["wq_t"].t(), s0["ws_t"].T, bf16)
        for nm, fn in (("parent", old_k5), ("change", new_k5)):
            _gate_bitwise(f"compare int8_matmul_fused {nm}", name, fn(s0),
                          ref)
        # in graph replays: the change launches through its wrapper, the
        # parent straight into its C function, and the host work between
        # launches would otherwise count against the change
        it = iter(range(10 ** 9))
        old, new = _turns(lambda: old_k5(sets[next(it) % 3]),
                          lambda: new_k5(sets[next(it) % 3]), graph_ms)
        t5["parent"] = [a + b for a, b in zip(t5["parent"], old)]
        t5["change"] = [a + b for a, b in zip(t5["change"], new)]
        log(f"compare int8_matmul_fused {name} ({M}, {K}) x ({K}, {N}): "
            f"parent {old} ms, change {new} ms")
        for prod in ("dx", "dw"):
            ref = Q._int8_dot(*s0[prod], bf16, plain=True)
            for nm, fn in (("parent", lambda d: old_k4(d, prod)),
                           ("change", lambda d: Q._int8_dot(
                               *d[prod], bf16, plain=False))):
                _gate_bitwise(f"compare int8_matmul {nm}",
                              f"{name} {prod}", fn(s0), ref)
            it = iter(range(10 ** 9))
            old, new = _turns(
                lambda: old_k4(sets[next(it) % 3], prod),
                lambda: Q._int8_dot(*sets[next(it) % 3][prod], bf16,
                                    plain=False))
            t4["parent"] = [a + b for a, b in zip(t4["parent"], old)]
            t4["change"] = [a + b for a, b in zip(t4["change"], new)]
            log(f"compare int8_matmul {name} {prod}: parent {old} ms, change "
                f"{new} ms")
        del sets, ref, codes, out
        torch.cuda.empty_cache()
    res["int8_matmul_fused"] = {"parent_ms": t5["parent"],
                                "change_ms": t5["change"]}
    res["int8_matmul"] = {"parent_ms": t4["parent"],
                          "change_ms": t4["change"]}
    log(f"compare int8_matmul_fused, one layer's 7 projections: parent "
        f"{t5['parent']} ms, change {t5['change']} ms; int8_matmul, the 14 "
        f"backward products: parent {t4['parent']} ms, change "
        f"{t4['change']} ms")

    # K4 at decode, M = 8: the parent's mma.sync against the GEMV
    Md = ENGINE["max_batch"]
    td = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    for name, K, N in K4_DECODE_SHAPES:
        sets = _decode_operands(gen, Md, K, N)
        o4 = torch.empty((Md, N), device="cuda", dtype=bf16)

        def old_dec(xq, xs, wq, ws, o4=o4, N=N, K=K):
            launched("int8_matmul", lib8.int8_matmul_launch(
                ptr(xq), ptr(wq), ptr(xs), ptr(ws), ptr(o4), Md, N, K, 0,
                stream()))
            return o4

        ref = Q.int8_matmul(*sets[0], bf16)
        for nm, fn in (("parent", old_dec), ("change", Q.int8_matmul_kernel)):
            _gate_bitwise(f"compare int8_matmul decode {nm}", name,
                          fn(*sets[0]), ref)
        it = iter(range(10 ** 9))
        old, new = _turns(lambda: old_dec(*sets[next(it) % 3]),
                          lambda: Q.int8_matmul_kernel(*sets[next(it) % 3]),
                          graph_ms)
        log(f"compare int8_matmul decode {name} ({Md}, {K}) x ({K}, {N}): "
            f"parent {old} ms, change {new} ms (graph replays)")
        if name == "unembed":
            res["int8_matmul_unembed"] = {"parent_ms": old, "change_ms": new}
        else:
            td["parent"] = [a + b for a, b in zip(td["parent"], old)]
            td["change"] = [a + b for a, b in zip(td["change"], new)]
        del sets, ref, o4
    torch.cuda.empty_cache()
    res["int8_matmul_decode"] = {"parent_ms": td["parent"],
                                 "change_ms": td["change"]}
    log(f"compare int8_matmul decode, one layer's 7 projections: parent "
        f"{td['parent']} ms, change {td['change']} ms (graph replays)")
    return res


@contextlib.contextmanager
def _engine_decode(attend):
    """The engine's paged decode attention replaced by ``attend``."""
    saved, E.paged_attention_decode = E.paged_attention_decode, attend
    try:
        yield
    finally:
        E.paged_attention_decode = saved


def _compare_k2(lib, ptr, stream) -> dict:
    """--parent-csrc for K2: at q8_decode_phase's shapes (drawn from
    ``SEED``) each build against the plain version at
    ``PA.TOLERANCE_Q8`` and twice bit-equal, both timed in CUDA-graph
    replays in turns; then the int8 serve's decode step
    (:func:`decode_step_profile`, over 8 prompts of the serve's lengths
    drawn from ``SEED + 12``) with either build's K2 as the engine's, in
    turns, its device time read by ``torch.profiler``."""
    def old_k2(qq, kq, vq, pages, apos, *, q_scale, pk_s, pv_s):
        """The parent's K2 as its wrapper launched it (a scratch a
        call), counted in ``PA.Q8_COUNTS``."""
        B, _, nkv, rep, hd = qq.shape
        geom = (B, pages.shape[1], kq.shape[1], nkv, rep, hd)
        scratch = torch.empty(lib.paged_decode_q8_scratch_floats(*geom),
                              device="cuda")
        out = torch.empty((B, 1, nkv, rep, hd), device="cuda")
        rc = lib.paged_decode_q8_launch(
            ptr(qq), ptr(q_scale), ptr(kq), ptr(vq), ptr(pk_s), ptr(pv_s),
            ptr(pages), ptr(apos), ptr(scratch), ptr(out), *geom, stream())
        check(rc == 0, f"parent paged_decode_q8: CUDA error {rc}")
        PA.Q8_COUNTS.launches += 1
        return out

    builds = {"parent": old_k2, "change": PA.paged_attention_decode}
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    qq, qs, pools, pages, apos, _ = _q8_decode_inputs(rng, gen)
    ref = PA.paged_attention_plain_q8(qq, qs, pools[0][0], pools[0][2],
                                      pools[0][1], pools[0][3], pages, apos)
    res = {"max_abs_err": {}, "gate_ratio": {}}
    calls = {}
    for nm, fn in builds.items():
        calls[nm] = lambda kq, ks, vq, vs, fn=fn: fn(
            qq, kq, vq, pages, apos, q_scale=qs, pk_s=ks, pv_s=vs)
        got = calls[nm](*pools[0])
        torch.cuda.synchronize()
        err, ratio = _q8_reading(f"compare paged_decode_q8 {nm}", got, ref)
        res["max_abs_err"][nm], res["gate_ratio"][nm] = err, ratio
        _twice_equal(f"compare paged_decode_q8 {nm}",
                     lambda: calls[nm](*pools[0]))
    it = iter(range(10 ** 9))
    old, new = _turns(lambda: calls["parent"](*pools[next(it) % 4]),
                      lambda: calls["change"](*pools[next(it) % 4]), graph_ms)
    res.update(parent_ms=old, change_ms=new)
    log(f"compare paged_decode_q8 (serve shapes): parent {old} ms, change "
        f"{new} ms (graph replays; turns: parent, change, change, parent)")
    del pools, ref
    torch.cuda.empty_cache()

    # the int8 serve's decode step with either K2, in turns
    params_q8 = quantize_decode_params(build_params(), CFG)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 12)
    eng = E.ServingEngine(params_q8, CFG, **INT8_ENGINE)
    reqs = [eng.submit(rng.integers(1, CFG.vocab_size, size=int(
        rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))).astype(np.int32),
        max_new_tokens=NEW_TOKENS) for _ in range(N_REQUESTS)]
    steps = {"parent": [], "change": []}
    want = DECODE_PROFILE_STEPS * CFG.num_hidden_layers
    for nm in ("parent", "change", "change", "parent"):
        PA.Q8_COUNTS.reset()
        with _engine_decode(builds[nm]):
            reading = decode_step_profile(eng, reqs, f"compare int8 serve, "
                                          f"{nm} K2", False)
        check(PA.Q8_COUNTS.launches == want,
              f"compare int8 decode step: {PA.Q8_COUNTS.launches} {nm} K2 "
              f"launches, not {want}")
        steps[nm].append(reading)
    res["int8_decode_step"] = steps
    for key in ("device_busy_ms", "paged_decode_ms"):
        log(f"compare int8 decode step, {key} a step (turns): parent "
            f"{[r[key] for r in steps['parent']]}, change "
            f"{[r[key] for r in steps['change']]}")
    del eng, reqs, params_q8
    torch.cuda.empty_cache()
    return res


def parent_compare_phase(csrc: Path) -> dict:
    """K7, K5 and K4 (:func:`_compare_gemms`), K1, K2
    (:func:`_compare_k2`) and K3 at the kernel phase's serve shapes, K6
    at one layer's
    seven projections (M = 8192) and the flash attention's backward and
    forward at the training shape (B 1, S 8192, 16 / 4 heads, hd 128),
    each built from
    this checkout and from ``csrc`` (another commit's sources) and timed
    in one process in turns (old, new, new, old).  Both builds are gated
    against their plain versions at their modules' tolerances; K3 over
    the multi-draw reading (:func:`k3_draws_reading`) and the forward
    over its oracle reading (:func:`fa_oracle_reading`) as well, whose
    counts against the oracle gate the change and are logged for the
    parent.  Then SMOLLM3_3B serves 8 requests with either build's K1 as
    the engine's paged decode (:func:`_serve_reading`), in
    ``SERVE_ROUNDS`` rounds of the same turns after one warm-up serve."""
    libs = _parent_libs(csrc)
    ptr, stream = (lambda t: ctypes.c_void_p(t.data_ptr())), (
        lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = _compare_gemms(libs, ptr, stream,
                         torch.Generator(device="cuda").manual_seed(SEED + 4))

    # K3, as kernel_phase draws it
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    chunk = ENGINE["prefill_chunk"]
    apos_np = ((plen - 1) // chunk * chunk)[:, None] + np.arange(chunk)
    pools = _pools(gen, B * P + 1, page, nkv, hd, 4)
    apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
    pages = _page_table(rng, apos_np.max(axis=1), page, P, B * P + 1)
    qg = torch.randn((B, chunk, nkv, rep, hd), generator=gen, device="cuda",
                     dtype=CFG.dtype)

    def old_k3_on(qg, pk, pv, pages, apos):
        out = torch.empty(qg.shape, device="cuda")
        rc = libs["flash_prefill"].flash_prefill_launch(
            ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(out),
            qg.shape[0], qg.shape[1], pages.shape[1], pk.shape[1], nkv, rep,
            hd, 1, stream())
        check(rc == 0, f"parent flash_prefill: CUDA error {rc}")
        return out

    it = iter(range(10 ** 9))
    old, new = _turns(
        lambda: old_k3_on(qg, *pools[next(it) % 4], pages, apos),
        lambda: FP.paged_flash_prefill(qg, *pools[next(it) % 4], pages,
                                       apos))
    res["flash_prefill"] = {"parent_ms": old, "change_ms": new}
    log(f"compare flash_prefill (serve shapes): parent {old} ms, change "
        f"{new} ms (turns: parent, change, change, parent)")
    del pools
    torch.cuda.empty_cache()
    res["flash_prefill"].update(k3_draws_reading(
        {"parent": old_k3_on, "change": FP.paged_flash_prefill},
        "compare flash_prefill", gated=("change",)))

    # K6, one layer's seven projections; the weight's codes K-major, the
    # layout both builds' C functions take
    M, bf16 = TRAIN["seq"] * TRAIN["bs"], torch.bfloat16
    atol, rtol = Q.TOLERANCE[bf16]
    tot_old, tot_new = [0.0, 0.0], [0.0, 0.0]
    for name, K, N in PROJECTIONS:
        sets = []
        for _ in range(3):
            x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 * 0.02).to(bf16)
            sets.append((*Q.quantize_fp8(x), *Q.quantize_fp8_kmajor(w)))
        o6 = torch.empty((M, N), device="cuda", dtype=bf16)
        # the codes as bf16, the prologue's scratch
        a16 = torch.empty((M, K), device="cuda", dtype=bf16)
        b16 = torch.empty((N, K), device="cuda", dtype=bf16)
        it = iter(range(10 ** 9))

        def old_k6():
            aq, a_s, bt, b_s = sets[next(it) % 3]
            rc = libs["fp8_matmul"].fp8_matmul_launch(
                ptr(aq), ptr(bt), ptr(a_s), ptr(b_s), ptr(a16), ptr(b16),
                ptr(o6), M, N, K, stream())
            check(rc == 0, f"parent fp8_matmul: CUDA error {rc}")
            return o6

        def new_k6():
            aq, a_s, bt, b_s = sets[next(it) % 3]
            return Q.fp8_matmul_kernel(aq, a_s, bt, b_s)

        aq, a_s, bt, b_s = sets[0]
        ref = Q.fp8_matmul(aq, a_s, bt.t(), b_s, bf16)
        ratios = {}
        for nm, fn in (("parent", old_k6), ("change", new_k6)):
            it = iter(range(0, 10 ** 9, 3))
            ratios[nm] = gate_ratio(fn(), ref, atol, rtol)
            check(ratios[nm] <= 1.0, f"compare fp8_matmul {nm}: ({M}, {K}) x "
                  f"({K}, {N}) gate ratio {ratios[nm]:.3f}")
        it = iter(range(10 ** 9))
        old, new = _turns(old_k6, new_k6)
        tot_old = [a + b for a, b in zip(tot_old, old)]
        tot_new = [a + b for a, b in zip(tot_new, new)]
        log(f"compare fp8_matmul {name} ({M}, {K}) x ({K}, {N}): parent "
            f"{old} ms, change {new} ms; gate ratios {json.dumps(ratios)}")
        del sets, ref, a16, b16
        torch.cuda.empty_cache()
    res["fp8_matmul"] = {"parent_ms": tot_old, "change_ms": tot_new}
    log(f"compare fp8_matmul, one layer's 7 projections: parent {tot_old} "
        f"ms, change {tot_new} ms")

    # the flash attention's backward at the training shape, from the
    # change's forward (the forward is the same code in both)
    Bt, S = TRAIN["bs"], TRAIN["seq"]
    nq, nkv_t = TRAIN_CFG.num_attention_heads, TRAIN_CFG.num_key_value_heads
    scale = hd ** -0.5
    mk = lambda n: torch.randn((Bt, S, n, hd), generator=gen,  # noqa: E731
                               device="cuda").to(bf16)
    sets = []
    for _ in range(3):
        q, k, v, do = mk(nq), mk(nkv_t), mk(nkv_t), mk(nq)
        sets.append((q, k, v, *FA.flash_attention_fwd(q, k, v, scale), do))
    it = iter(range(10 ** 9))

    def old_bwd():
        q, k, v, o, lse, do = sets[next(it) % 3]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        dvec = torch.empty_like(lse)
        rc = libs["flash_attention"].flash_attn_bwd_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(dvec),
            ptr(dq), ptr(dk), ptr(dv), Bt, S, nq, nkv_t, hd, scale, stream())
        check(rc == 0, f"parent flash_attention_bwd: CUDA error {rc}")
        return dq, dk, dv

    def new_bwd():
        return FA.flash_attention_bwd(*sets[next(it) % 3], scale)

    q, k, v, _, _, do = sets[0]
    ref_g = FA.flash_attention_bwd_plain(q, k, v, do, scale)
    ratios = {}
    for nm, fn in (("parent", old_bwd), ("change", new_bwd)):
        it = iter(range(0, 10 ** 9, 3))
        ratios[nm] = max(_fa_reading(f"compare flash_attention_bwd {nm}", g,
                                     got, r, "bwd")[1]
                         for g, got, r in zip(("dq", "dk", "dv"), fn(), ref_g))
        check(ratios[nm] <= 1.0, f"compare flash_attention_bwd {nm}: gate "
              f"ratio {ratios[nm]:.3f}")
    del ref_g
    it = iter(range(10 ** 9))
    old, new = _turns(old_bwd, new_bwd)
    res["flash_attention_bwd"] = {"parent_ms": old, "change_ms": new,
                                  "gate_ratio": ratios}
    log(f"compare flash_attention_bwd (B {Bt}, S {S}, {nq}/{nkv_t} heads): "
        f"parent {old} ms, change {new} ms; gate ratios {json.dumps(ratios)}")
    del sets
    torch.cuda.empty_cache()

    # the flash attention's forward at the training shape
    def old_fwd_on(q, k, v, scale):
        o, lse = torch.empty_like(q), torch.empty(
            (q.shape[0], nq, q.shape[1]), device="cuda")
        rc = libs["flash_attention"].flash_attn_fwd_launch(
            ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), q.shape[0], q.shape[1],
            nq, nkv_t, hd, scale, stream())
        check(rc == 0, f"parent flash_attention_fwd: CUDA error {rc}")
        return o, lse

    sets = [(mk(nq), mk(nkv_t), mk(nkv_t)) for _ in range(3)]
    q, k, v = sets[0]
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    ratios = {}
    for nm, fn in (("parent", old_fwd_on), ("change", FA.flash_attention_fwd)):
        o, lse = fn(q, k, v, scale)
        e_lse = float((lse - ref_lse).abs().max())
        ratios[nm] = max(_fa_reading(f"compare flash_attention_fwd {nm}", "O",
                                     o, ref_o, "fwd")[1], e_lse / FA.LSE_ATOL)
        check(ratios[nm] <= 1.0, f"compare flash_attention_fwd {nm}: gate "
              f"ratio {ratios[nm]:.3f}")
    del ref_o, ref_lse, o, lse
    it = iter(range(10 ** 9))
    old, new = _turns(lambda: old_fwd_on(*sets[next(it) % 3], scale),
                      lambda: FA.flash_attention_fwd(*sets[next(it) % 3],
                                                     scale))
    res["flash_attention_fwd"] = {"parent_ms": old, "change_ms": new,
                                  "gate_ratio": ratios}
    log(f"compare flash_attention_fwd (B {Bt}, S {S}, {nq}/{nkv_t} heads): "
        f"parent {old} ms, change {new} ms; gate ratios {json.dumps(ratios)}")
    del sets
    torch.cuda.empty_cache()
    res["flash_attention_fwd"].update(fa_oracle_reading(
        {"parent": old_fwd_on, "change": FA.flash_attention_fwd},
        "compare flash_attention_fwd", gated=("change",)))

    # K1 at the kernel phase's serve shapes: one row per slot somewhere in
    # its 64 decode steps
    rng = np.random.default_rng(SEED + 3)
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    dec = plen + rng.integers(0, NEW_TOKENS, size=B)
    pools = _pools(gen, B * P + 1, page, nkv, hd, 4)
    apos = torch.as_tensor(dec[:, None].astype(np.int32), device="cuda")
    pages = _page_table(rng, dec, page, P, B * P + 1)
    qg = torch.randn((B, 1, nkv, rep, hd), generator=gen, device="cuda",
                     dtype=CFG.dtype)
    geom = (B, P, page, nkv, rep, hd)
    scratch = torch.empty(
        libs["paged_decode"].paged_decode_scratch_floats(*geom),
        device="cuda")

    def old_k1_on(pk, pv):
        out = torch.empty((B, 1, nkv, rep, hd), device="cuda")
        rc = libs["paged_decode"].paged_decode_launch(
            ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(scratch),
            ptr(out), *geom, 1, stream())
        check(rc == 0, f"parent paged_decode: CUDA error {rc}")
        return out

    ref = PA.paged_attention_plain(qg, *pools[0], pages, apos)
    atol, rtol = PA.TOLERANCE[CFG.dtype]
    errs = {}
    for nm, fn in (("parent", old_k1_on), ("change", lambda pk, pv:
                   PA.paged_attention_decode(qg, pk, pv, pages, apos))):
        got = fn(*pools[0])
        errs[nm] = float((got - ref).abs().max())
        check(torch.allclose(got, ref, atol=atol, rtol=rtol),
              f"compare paged_decode {nm}: max |kernel - plain| = "
              f"{errs[nm]} over atol {atol} rtol {rtol}")
    it = iter(range(10 ** 9))
    old, new = _turns(lambda: old_k1_on(*pools[next(it) % 4]),
                      lambda: PA.paged_attention_decode(
                          qg, *pools[next(it) % 4], pages, apos), graph_ms)
    res["paged_decode"] = {"parent_ms": old, "change_ms": new,
                           "max_abs_err": errs}
    log(f"compare paged_decode (serve shapes): parent {old} ms, change {new}"
        f" ms (graph replays); max |kernel - plain| {json.dumps(errs)}")
    del pools, scratch
    torch.cuda.empty_cache()

    res["paged_decode_q8"] = _compare_k2(libs["paged_decode_q8"], ptr,
                                         stream)

    def old_k1_serve(qg, pk, pv, pages, apos):
        """The parent's K1 as its wrapper launched it (a scratch a call)."""
        code = PA.check_cuda_operands(
            "paged_attention_decode", {"qg": qg, "pk": pk, "pv": pv},
            {"pages": pages, "apos": apos})
        B, _, nkv, rep, hd = qg.shape
        geom = (B, pages.shape[1], pk.shape[1], nkv, rep, hd)
        scratch = torch.empty(
            libs["paged_decode"].paged_decode_scratch_floats(*geom),
            device="cuda")
        out = torch.empty((B, 1, nkv, rep, hd), device="cuda")
        rc = libs["paged_decode"].paged_decode_launch(
            ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(scratch),
            ptr(out), *geom, code, stream())
        check(rc == 0, f"parent paged_decode: CUDA error {rc}")
        PA.COUNTS.launches += 1
        return out

    params = build_params()
    serve = {"parent": [], "change": []}
    k1 = {"parent": old_k1_serve, "change": PA.paged_attention_decode}
    # the first serve warms the allocator and the libraries; then
    # SERVE_ROUNDS rounds of turns: the host clock spreads between serves
    order = ["change"] + ["parent", "change", "change", "parent"] \
        * SERVE_ROUNDS
    for i, nm in enumerate(order):
        reading = _serve_reading(params, k1[nm])
        if i:
            serve[nm].append(reading)
        log(f"compare serve ({'warm-up, ' if not i else ''}{nm} K1): "
            f"{json.dumps(reading)}")
    for nm, rs in serve.items():
        log(f"compare serve, {nm} K1 over {len(rs)} serves: medians "
            + json.dumps({k: statistics.median(r[k] for r in rs)
                          for k in rs[0]}))
    res["serve"] = serve
    del params
    torch.cuda.empty_cache()
    return res


def _serve_reading(params, attend) -> dict:
    """The serve phase's requests (the same prompts every call) through a
    fresh engine whose paged decode is ``attend``: the decode step on the
    host clock, TTFT p50 and tokens a second."""
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(1, CFG.vocab_size,
                            size=int(rng.integers(PROMPT_LEN[0],
                                                  PROMPT_LEN[1] + 1))
                            ).astype(np.int32) for _ in range(N_REQUESTS)]
    with _engine_decode(attend):
        eng = E.ServingEngine(params, CFG, **ENGINE)
        for p in prompts:
            eng.submit(p, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        PA.COUNTS.reset()
        eng.run()
        torch.cuda.synchronize()
    steps = eng.stats["decode_steps"]
    check(PA.COUNTS.launches == steps * CFG.num_hidden_layers,
          f"compare serve: {PA.COUNTS.launches} K1 launches for {steps} "
          "decode steps")
    slo = eng.slo_report()
    return {"decode_step_ms": slo["scheduler"]["decode_ms_total"] / steps,
            "ttft_p50_ms": slo["ttft_ms"]["p50"],
            "tokens_per_s": slo["tokens_per_s"]}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="time K7, K4, K5, K1, K2, K3, K6 and the flash "
                    "attention built from this csrc directory (an unpacked "
                    "parent commit) against this checkout's, the int8 "
                    "decode step with either K2 and the serve with either "
                    "K1, in turns, and run nothing else")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: the smoke runs on the card",
              file=sys.stderr)
        return 2
    # the plain paths are f32 oracles: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    if args.parent_csrc is not None:
        try:
            res = parent_compare_phase(args.parent_csrc.resolve())
        except SmokeFailure as e:
            print(f"[smoke] FAILED: {e}", file=sys.stderr)
            return 1
        print(card, flush=True)
        print(json.dumps({"compare": res}), flush=True)
        return 0
    t_all = t = time.perf_counter()
    loader.build_all()
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    for name, text in loader.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t, 1)
        log(f"phase {name}: {walls[name]} s")
        return out

    L, L8 = CFG.num_hidden_layers, INT8_TRAIN_CFG.num_hidden_layers
    try:
        kernels = timed("kernels K1 K3", kernel_phase, rng, gen)
        kernels.append(timed("kernel K2", q8_decode_phase, rng, gen))
        kernels.extend(timed("kernels K4 K5", int8_gemm_phase))
        kernels.append(timed("kernel K6", fp8_phase))
        kernels.extend(timed("kernels FA", attention_phase))
        timed("FA backward oracle", fa_bwd_oracle_gate)
        kernels.append(timed("kernel K7", ag_matmul_phase))
        params = timed("SMOLLM3_3B params", build_params)
        eng, reqs, launches = timed("serve", serve_phase, params, rng, card)
        timed("parity", parity_phase, params, reqs, eng)
        timed("decode profile", decode_step_profile, eng, reqs, "serve",
              ENGINE["flash_prefill"])
        timed("profile", profile_phase, params, rng)
        del eng, reqs
        params_q8 = timed("int8 params", quantize_decode_params, params, CFG)
        del params
        torch.cuda.empty_cache()
        eng, reqs, q8 = timed("int8 serve", int8_serve_phase, params_q8, rng,
                              card)
        timed("int8 parity", int8_parity_phase, params_q8, reqs, eng)
        timed("int8 decode profile", decode_step_profile, eng, reqs,
              "int8 serve", INT8_ENGINE["flash_prefill"])
        timed("int8 profile", profile_phase, params_q8, rng, INT8_ENGINE,
              "int8 serve", (4, 2))
        del eng, reqs, params_q8
        torch.cuda.empty_cache()
        loss0 = timed("train parity", train_parity_phase)
        fp8 = timed("train", train_phase, card, loss0)
        loss0 = timed("int8 train parity", int8_train_parity_phase)
        i8 = timed("int8 train", train_phase, card, loss0, INT8_TRAIN,
                   INT8_TRAIN_CFG, {
                       "int8_matmul_fused": (Q.INT8_FUSED_COUNTS,
                                             L8 * len(PROJECTIONS) * 2),
                       "int8_matmul": (Q.INT8_COUNTS,
                                       L8 * len(PROJECTIONS) * 2),
                       "flash_attention_fwd": (FA.FWD_COUNTS, L8 * 2),
                       "flash_attention_bwd": (FA.BWD_COUNTS, L8)},
                   "int8 train")
        loss0 = timed("fsdp train parity", fsdp_train_parity_phase)
        fs = timed("fsdp train", fsdp_train_phase, card, loss0)
        ddp_zero = timed("ddp and zero", ddp_zero_phase, card)
        pipe_toy = timed("pipeline toy", pipeline_toy_phase, card)
        loss0 = timed("pipeline parity", pipeline_lm_parity_phase)
        pp = timed("pipeline", pipeline_lm_phase, card, loss0)
        bus = timed("busbench", busbench_phase, card)
        loss0 = timed("precision parity", precision_parity_phase)
        prec = timed("precision train", precision_train_phase, card, loss0)
        remat = timed("remat policies", remat_phase, card)
        bench0 = timed("precision bench parity",
                       precision_bench_parity_phase)
        bench_rows, bench = timed("precision bench", precision_bench_phase,
                                  card, bench0)
    except SmokeFailure as e:
        print(f"[smoke] FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        mesh.destroy_process_group()
    # each kernel's launches on the main paths that run it, each path
    # read with its counts set to 0 just before it
    precision = {k: prec.get(k, 0) + bench.get(k, 0)
                 for k in {**prec, **bench}}
    paths = {"serve": launches, "int8 serve": q8, "train": fp8,
             "int8 train": i8, "fsdp train": fs, "pipeline": pp,
             "precision": precision}
    for k in kernels:
        per = {p: c[k["name"]] for p, c in paths.items() if k["name"] in c}
        k["launches"] = sum(per.values())
        k["launches_by_path"] = per
    log(f"phase wall times (s): {json.dumps(walls)}; total "
        f"{time.perf_counter() - t_all:.1f} s")
    log(f"ddp and zero readings on {card}: {json.dumps(ddp_zero)}")
    log(f"pipeline toy readings on {card}: {json.dumps(pipe_toy)}")
    log(f"busbench rows on {card} (one rank: copies): {json.dumps(bus)}")
    log(f"remat policies on {card}: {json.dumps(remat)}")
    log(f"precision bench rows on {card}: {json.dumps(bench_rows)}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
