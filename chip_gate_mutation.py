#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s accuracy gates.

    python3 chip_gate_mutation.py

Needs the card, as ``chip_smoke.py`` does.  For each mutant it copies
the port and ``chip_smoke.py`` into ``build/gate_mutation/<mutant>/``,
changes one line of one source there, and runs the smoke's
phases that read that kernel on the copy, with every gate logged
instead of raised.  Each kernel mutant is a step of the reference's
arithmetic left out or done in lower precision, so that its output
stays close to the sound kernel's (``dot_q8_skipped`` and the three
resilience mutants edit a Python module of the port instead):

- ``probs_rounding``: K1 and K3 skip the bf16 rounding of the
  normalised probabilities (``dts::round_to``); K3's bf16 kernel then
  hands wgmma the probability's upper 16 bits, a truncation instead of
  a round to nearest; the kernel, serve and parity phases run, and K1's,
  K3's one-draw and both multi-draw, the prefill-logit and the
  decode-logit gates must fail;
- ``k3_diagonal_mask``: K3's mask on the tiles that cross a row's
  position is off by one (``t < apos``), so each row loses its own key;
  the same phases run, and K3's one-draw and both multi-draw gates and
  the prefill-logit gate must fail;
- ``k3_qk_truncating_add``: K3 adds the k-groups' QKᵀ sums into its f32
  scores rounding toward zero, as the tensor cores align addends; the
  same phases run, and K3's count against the f64 oracle (over the plain
  path's) must fail;
- ``fp8_bf16_accumulator``: K6 rounds its f32 accumulator to bf16 where
  it promotes each 128-deep k-block's wgmma sum; K6's gate, K6 on the
  operands of phase 13c's fp8_pallas row (``precision bench
  fp8_matmul``) and that row's step against the plain fp8 recipe
  (``precision bench fp8_pallas step-0``) must fail;
- ``fa_fwd_bf16_rowsum``: the flash forward sums the row's softmax
  denominator from the bf16-rounded probabilities, not the f32 ones;
  the forward's gate and phase 15b's MoE step against plain attention
  (``moe bf16 step-0``) must fail;
- ``fa_bwd_bf16_lse``: the flash backward reads the logsumexp rounded to
  bf16, not f32; the backward's gate and its L2 distance from the exact
  gradient at a pipeline stage's microbatch (over the plain path's)
  must fail;
- ``fa_fwd_pv_tile``: in the second half of the rows the flash forward
  leaves key tile 1 (64 keys) out of its wgmma PV product but not out of
  the row sum, so the logsumexp stays exact; the forward's gate, its
  count against the f64 oracle, the pipeline's step-0 gate against
  plain attention (``pipeline plain``), the flash kernels on phase
  13a's own step inputs (``precision attention``), 13a's step against
  plain attention (``precision plain``), the flash kernels on 13c's
  rows' inputs (``precision bench attention``) and 15b's MoE step
  against plain attention (``moe bf16 step-0``) must fail;
- ``fa_fwd_bf16_scores``: the flash forward rounds each tensor-core
  score to bf16 before scaling it; the forward's count against the f64
  oracle (over the plain path's) and 15b (``moe bf16 step-0``) must
  fail;
- ``k1_last_key``: K1's last visible key is ``apos - 1``, not ``apos``
  (``t < apos``), so each slot loses its own new key; the serve phases
  run, and K1's gate and the decode-logit gate must fail;
- ``fa_bwd_dv_tile``: in the second half of the keys the dK/dV kernel
  leaves one query tile (64 queries) out of its wgmma dV product; the
  backward's gate, its L2 distance from the exact gradient at a
  pipeline stage's microbatch and the pipeline's step-0 gate against
  plain attention must fail;
- ``k5_slice_absmax``: K5's quantising prologue codes each 128-wide K
  slice of a row with that slice's own absmax instead of the full
  row's; K5's gate and the int8 step-0 parity must fail;
- ``k5_eager_scale``: K5's prologue computes its row scale as
  ``amax / 127`` (the reference's eager form) instead of
  ``amax · f32(1/127)``; K5's gate and the int8 step-0 parity must fail;
- ``k5_dropped_k_block``: K5's consumers leave the last k-block of the
  TMA ring out of the sum; K5's gate, the int8 step-0 parity, the
  precision tier's step-0 parity (``precision step-0``, phase 13a:
  quantised gathers and grads, int8 moments) and 13c's int8_pallas_bwd
  row against the plain int8 products (``precision bench
  int8_pallas_bwd step-0``) must fail;
- ``k5_scale_product``: K5's epilogue applies ``acc · (xs · ws)``; K5's
  gate and the int8 step-0 parity must fail;
- ``k4_scale_product``: K4's epilogue, shared by its three designs,
  applies ``acc · (xs · ws)``; K4's gate and the int8 step-0 parity
  must fail;
- ``k4_dropped_k_block``: K4's wgmma GEMM (the training path's dX and
  dW) leaves the last k-block of its TMA ring out of the sum; K4's gate
  and the int8 step-0 parity must fail;
- ``k4_gemv_dropped_split``: K4's split-K decode GEMV loses the last K
  split's partial sums; K4's decode gate and the int8 decode-logit gate
  must fail;
- ``k2_chunk_absmax``: each block of K2's cluster requantises its
  positions' ``p · vs`` with its own absmax instead of the cluster's
  (the row's); K2's gate and the int8 decode-logit gate must fail;
- ``k2_dropped_rank``: K2's int32 reduction over the cluster leaves out
  the last rank's partial PV sums; the same gates must fail;
- ``k2_last_key``: K2's last visible key is ``apos - 1``, not ``apos``,
  so each slot loses its own new key; the same gates must fail;
- ``k7_bf16_accumulator``: K7 rounds its f32 accumulators to bf16 after
  every 64-deep k-block; K7's gate must fail;
- ``k7_dropped_k_tile``: K7 leaves the chunk's last K tile out of the
  sum; K7's gate and the FSDP step-0 parity must fail;
- ``remat_pallas_keeps_products``: the ``save_dots`` policy
  (``models/transformer.py``, ``_saved_ops``) keeps the projection
  ops' outputs at the ``*_pallas`` precisions too (K5's and K6's),
  which the reference's policy never sees; phase 22a's gates that
  ``save_dots`` keeps no byte beyond ``full``'s there and that its peak
  is ``full``'s must fail;
- ``q8_residual_skipped``: ``save_dots_q8`` keeps, beside the
  round-trip's int8 pair, its dequantised bf16 output (every
  ``aten._to_copy``, the casts of the layer with it); 22a's gates on
  its kept bytes and on its peak's excess against bf16 ``save_dots``'
  must fail at int8_pallas_bwd;
- ``dot_q8_skipped``: the ``save_dots_q8`` projection
  (``ops/quant.py``, ``dot_q8``) hands on the bf16 product instead of
  its int8 round-trip, while the policy still keeps the codes; phase
  13b's ``save_dots_q8`` gate (its loss must differ from ``full``'s)
  must fail;
- three of the resilience runtime (phase 14, the port's Python):
  ``resume_cursor_skipped`` (``resilience/supervisor.py``: a resumed
  run reads its batches from the start, not past its data cursor), whose
  FSDP and DDP resumes must break (``resilience fsdp``, ``resilience
  ddp``); ``adam_count_not_restored`` (``utils/checkpoint.py``: a
  restore takes the host scalars, ``AdamState.count``, from the fresh
  state), whose FSDP and ZeRO-3 resumes must break; and
  ``ckpt_live_tensors`` (``utils/checkpoint.py``: an async save hands
  the writer the live tensors instead of its snapshot, so the write
  reads them after the next step's in-place update), whose DDP resume
  from an async save (``resilience ddp crash``) must break;
- four of the MoE model (phase 15, the port's Python; child ``moe``
  runs 15a, the oracle gates and 15b): ``moe_capacity_plus_one``
  (``parallel/expert.py``: a group's bucket admits one assignment more,
  ``pos <= capg``), whose oracle gates at the tight capacities (``moe
  oracle top-1 cf 0.75``, ``moe oracle top-2 cf 1.0``) must fail;
  ``moe_token_major_top2`` (the bucket positions counted token by token
  instead of every first choice before any second), whose top-2 oracle
  gate must fail; ``moe_shared_int8_scale`` (the experts' products as
  one product over the bank, block-diagonal, so the int8 backward's
  scales are shared across experts), whose int8 oracle gate must fail
  (the forward's scales are per row and per column, so they stay each
  expert's own, and 15a stays bit-equal: both sides share the mutant);
  and ``moe_aux_dropped`` (``models/transformer.py``: ``lm_loss``
  leaves the aux term out), whose loss recomposition (``moe loss sum``)
  must fail.  The all_to_all's backward cannot show at one rank; a
  two-rank CPU test removes it (``tests/test_torch_expert_ranks.py``).
- three of tensor and sequence parallelism (phase 16, the port's
  Python; child ``tp`` runs 16b and 16c): ``ring_causal_off_by_one``
  (``ops/ring_attention.py``: the contiguous ring takes its own block
  as fully visible, ``src <= my``), whose ring fold against the flash
  kernels and the f64 oracle (``ring contiguous O``) must fail;
  ``zigzag_stripe_swapped`` (``zigzag_positions`` lists the late stripe
  first, so RoPE and the local mask see swapped positions), whose
  zigzag fold (``ring zigzag O``) must fail; and ``tp_rejoin_dropped``
  (``models/transformer.py``: the attention's rejoin left out; at one
  rank it is a copy, so only the count can see it), whose TP step's
  collectives against the ``tp`` contract (``tp step: collectives``)
  must fail.
- three of the composable step (phase 17, the port's Python; child
  ``composable`` runs 17a's steps and 17d's two-rank laws):
  ``composable_tp_sync_forgotten`` (``parallel/composable.py``: the grad
  sync of a tp-replicated leaf sums over dp only), whose law at tp 2
  (``composable law t2``) must fail; ``composable_row_rule_swapped``
  (``analysis/rules.py``: the row-parallel rule shards fsdp on the in
  dim and tp on the out dim), whose generated contract then counts no
  rejoin, so 17a's collectives against it (``composable step: step 0
  collectives``) and the law at tp 2 must fail; and
  ``auto_grad_divide_skipped`` (``parallel/fsdp.py``: the auto variant
  hands Adam the ranks' sum), whose law at two ranks (``auto law``)
  must fail.  At one rank none of them changes a value.
- four of the serving frontier (phase 18, the port's Python; child
  ``frontier`` runs the serve phase for its requests and then phase
  18): ``spec_accept_no_cumprod`` (``serving/engine.py``: the accept
  rule counts every matching proposal, not the matching prefix, so it
  accepts past a mismatch), whose near-argmax law at 36 draft layers
  and on the int8 frontier (``frontier spec 36 near-argmax``, ``int8
  frontier near-argmax``) must fail (at 4 draft layers no proposal
  after a mismatch ever matches, so nothing is accepted past one);
  ``prefix_prefill_from_zero`` (``serving/scheduler.py``: admission
  aliases the cached pages but prefills from position 0, writing into
  them), whose CoW law (``frontier cache CoW law``) and chunk count
  (``frontier cache prefix chunks``) must fail; ``trie_keeps_duplicate``
  (``serving/kv_pool.py``: an insert that finds a concurrent twin keeps
  its own page instead of swapping to the twin's and freeing it), whose
  allocator law after 18c's first run (``int8 frontier run 1 allocator
  law``) must fail; and ``verify_rows_at_lengths``
  (``serving/engine.py``: the verify writes every row of its block at
  ``lengths``, not ``lengths + i``), whose near-argmax law at 4 and 36
  draft layers and the acceptance limit at 36 must fail.
- four of the serving fleet, TP serving and the handoff (phase 19, the
  port's Python; each child runs only its sub-phase):
  ``failover_no_replay_reset`` (``serving/scheduler.py``: a failover
  requeues the dead replica's requests without ``reset_for_replay``, so
  they keep their partial tokens), whose bit-equality against the
  undisturbed fleet after the kill and after the hang (``fleet kill
  tokens``, ``fleet hang tokens``, 19a) must fail;
  ``serve_tp_rejoin_dropped`` (``serving/engine.py``: the layer body
  leaves out the rejoin after attention, which changes no value at one
  rank), whose count against the generated ``serve_decode`` contract
  (``tp serve collectives``, 19d) must fail; ``handoff_page_off``
  (``serving/engine.py``: the handoff writes each prompt page's rows
  into the decode page one before its own), whose bit-equality against
  the engine without ``disaggregate`` on both pools (``disaggregated
  float tokens``, ``disaggregated int8 tokens``, 19e) must fail; and
  ``swap_in_flight`` (``serving/engine.py``: ``drained()`` says yes with
  requests in flight, so the hot-swap installs the new weights under
  them), whose old-or-new law (``fleet swap old-or-new``, 19c) must
  fail.
- C9's route-aware law (phase 19f, child ``moe_serve``):
  ``moe_route_decode_skew`` (``parallel/expert.py``: the router's
  probabilities of a decode step's rows, at most 8 of them, taken from
  logits raised by 2 · expert index, so a row's route depends on the
  batch it runs in), whose router-probability gates (``moe serve bf16
  router probabilities``, ``... int8 ...``: the RMS ratio against the
  f32 pass; ``... f32 ...``) and the f32 near-argmax law with
  ``generate`` teacher-forced on the engine's experts must fail.
- two of the flash kernels at hd 64 (phase 2's hd-64 shapes, child
  ``fa_hd64``): ``fa_hd64_qk_kstep`` (QKᵀ and the backward's S and dP
  leave the last of their four k16 steps out), whose forward and
  backward gates and forward oracle count must fail; and
  ``fa_hd64_pv_block_unscaled`` (the forward's online softmax leaves
  O's last 8-column block unrescaled when the row maximum moves), whose
  forward gate and oracle count must fail.

- two of the observability tier (phase 21, the port's Python; each
  child runs only its sub-phase): ``pipeline_resume_no_adam``
  (``parallel/pipeline.py``: a resumed stage takes the checkpoint's
  params but keeps its fresh Adam state), whose bit-equality of the
  resumed pipeline with the uninterrupted one (``pipeline harness:
  resumed losses``, ``pipeline harness: the resumed run's``, 21a) must
  fail; and ``ledger_drops_reduce_scatter``
  (``utils/trace_analysis.py``: the trace reader no longer counts the
  ``c10d`` reduce_scatter op), whose FSDP ledger join (``ledger fsdp:``,
  21b) must fail.

The fp8-path training mutants also run the step-0 parity of the
training path; its loss or grad gates must fail on at least one of
them.  Exits 0 only if every expected gate failed.  Names given on the
command line run those mutants only.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "gate_mutation"
PKG = "distributed_training_sandbox_tpu_torch"
ROUND = "__bfloat162float(__float2bfloat16_rn({}))"
MUTANTS = [
    # name, source, sound line, mutant line, phases, gates that must fail
    ("probs_rounding", "csrc/paged_common.cuh",
     "  return __bfloat162float(__float2bfloat16_rn(x));",
     "  return x;", "serve",
     ("paged_decode:", "flash_prefill:", "flash_prefill draws:",
      "flash_prefill oracle:", "prefill logits", "decode logits")),
    ("fp8_bf16_accumulator", "csrc/fp8_matmul.cu",
     "  return acc + part;",
     f"  return {ROUND.format('acc + part')};", "train_precision",
     ("fp8_matmul:", "precision bench fp8_matmul",
      "precision bench fp8_pallas step-0")),
    ("fa_fwd_bf16_rowsum", "csrc/flash_attention.cu",
     "__device__ __forceinline__ float lsum_term(float p) { return p; }",
     "__device__ __forceinline__ float lsum_term(float p) { return "
     f"{ROUND.format('p')}; }}", "train",
     ("flash_attention_fwd:", "moe bf16 step-0")),
    ("fa_bwd_bf16_lse", "csrc/flash_attention.cu",
     "__device__ __forceinline__ float lse_in(float x) { return x; }",
     "__device__ __forceinline__ float lse_in(float x) { return "
     f"{ROUND.format('x')}; }}", "train",
     ("flash_attention_bwd:", "flash_attention_bwd oracle:")),
    ("fa_fwd_pv_tile", "csrc/flash_attention.cu",
     "    acc_rows(oacc, pa, vtile(j));   // O += P V",
     "    if (j != 1 || q0 < S / 2) acc_rows(oacc, pa, vtile(j));   "
     "// O += P V", "train_pipeline",
     ("flash_attention_fwd:", "flash_attention_fwd oracle:",
      "pipeline plain", "precision attention", "precision plain",
      "precision bench attention", "moe bf16 step-0")),
    ("fa_fwd_bf16_scores", "csrc/flash_attention.cu",
     "__device__ __forceinline__ float fwd_score(float s, float scale) "
     "{ return s * scale; }",
     "__device__ __forceinline__ float fwd_score(float s, float scale) "
     f"{{ return {ROUND.format('s')} * scale; }}", "train",
     ("flash_attention_fwd oracle:", "moe bf16 step-0")),
    ("fa_bwd_dv_tile", "csrc/flash_attention.cu",
     "    accumulate_dv_dk(dva, pa, dos, dka, da, qs, true);   // dV, dK",
     "    accumulate_dv_dk(dva, pa, dos, dka, da, qs, "
     "q0 != k0 + kQt || k0 < S / 2);   // dV, dK",
     "train_pipeline", ("flash_attention_bwd:",
                        "flash_attention_bwd oracle:", "pipeline plain")),
    ("k3_diagonal_mask", "csrc/flash_prefill.cu",
     "__device__ __forceinline__ bool visible(int t, int ap) "
     "{ return t <= ap; }",
     "__device__ __forceinline__ bool visible(int t, int ap) "
     "{ return t < ap; }", "serve",
     ("flash_prefill:", "flash_prefill draws:", "flash_prefill oracle:",
      "prefill logits")),
    ("k3_qk_truncating_add", "csrc/flash_prefill.cu",
     "  return acc + part;", "  return __fadd_rz(acc, part);", "serve",
     ("flash_prefill oracle:",)),
    ("k5_slice_absmax", "csrc/int8_matmul.cu",
     "  return s;   // the scale of the full row",
     "  { const float a = slice_amax(row, k & ~127, K); "
     "return a > 0.f ? a * (1.0f / 127.0f) : 1.0f; }", "int8_train",
     ("int8_matmul_fused:", "int8 step-0")),
    ("k5_eager_scale", "csrc/int8_matmul.cu",
     "  const float s = amax > 0.f ? amax * (1.0f / 127.0f) : 1.0f;",
     "  const float s = amax > 0.f ? amax / 127.0f : 1.0f;", "int8_train",
     ("int8_matmul_fused:", "int8 step-0")),
    ("k5_dropped_k_block", "csrc/int8_matmul.cu",
     "  return kb < nk;", "  return kb + 1 < nk;", "int8_train_precision",
     ("int8_matmul_fused:", "int8 step-0", "precision step-0",
      "precision bench int8_pallas_bwd step-0")),
    ("k5_scale_product", "csrc/int8_matmul.cu",
     "  return __float2bfloat16_rn((__int2float_rn(acc) * sx) * sw);",
     "  return __float2bfloat16_rn(__int2float_rn(acc) * (sx * sw));",
     "int8_train", ("int8_matmul_fused:", "int8 step-0")),
    ("k4_scale_product", "csrc/int8_matmul.cu",
     "  const float v = (__int2float_rn(acc) * sx) * sw;",
     "  const float v = __int2float_rn(acc) * (sx * sw);",
     "int8_train", ("int8_matmul:", "int8 step-0")),
    ("k4_dropped_k_block", "csrc/int8_matmul.cu",
     "__device__ __forceinline__ bool k4_kblock_in_sum(int kb, int nk) "
     "{ return kb < nk; }",
     "__device__ __forceinline__ bool k4_kblock_in_sum(int kb, int nk) "
     "{ return kb + 1 < nk; }", "int8_train",
     ("int8_matmul:", "int8 step-0")),
    ("k4_gemv_dropped_split", "csrc/int8_matmul.cu",
     "__device__ __forceinline__ bool split_in_sum(int s, int n) "
     "{ return s < n; }",
     "__device__ __forceinline__ bool split_in_sum(int s, int n) "
     "{ return s + 1 < n; }", "int8_decode",
     ("int8_matmul decode:", "int8 decode logits")),
    ("k1_last_key", "csrc/paged_decode.cu",
     "__device__ __forceinline__ int last_key(int ap, int V) "
     "{ return min(ap, V - 1); }",
     "__device__ __forceinline__ int last_key(int ap, int V) "
     "{ return min(ap - 1, V - 1); }", "serve",
     ("paged_decode:", "decode logits")),
    ("k2_chunk_absmax", "csrc/paged_decode_q8.cu",
     "      A = fmaxf(A, cluster.map_shared_rank(sm.am, c)[r]);",
     "      A = sm.am[r];", "int8_serve",
     ("paged_decode_q8:", "int8 decode logits")),
    ("k2_dropped_rank", "csrc/paged_decode_q8.cu",
     "__device__ __forceinline__ bool rank_in_sum(int c, int n) "
     "{ return c < n; }",
     "__device__ __forceinline__ bool rank_in_sum(int c, int n) "
     "{ return c + 1 < n; }", "int8_serve",
     ("paged_decode_q8:", "int8 decode logits")),
    ("k2_last_key", "csrc/paged_decode_q8.cu",
     "__device__ __forceinline__ int last_key(int ap, int V) "
     "{ return min(ap, V - 1); }",
     "__device__ __forceinline__ int last_key(int ap, int V) "
     "{ return min(ap - 1, V - 1); }", "int8_serve",
     ("paged_decode_q8:", "int8 decode logits")),
    ("k7_bf16_accumulator", "csrc/ag_matmul.cu",
     "__device__ __forceinline__ bool acc_rounded() { return false; }",
     "__device__ __forceinline__ bool acc_rounded() { return true; }",
     "fsdp_train", ("ag_matmul:",)),
    ("k7_dropped_k_tile", "csrc/ag_matmul.cu",
     "__device__ __forceinline__ bool tile_in_sum(int kt, int nk) "
     "{ return kt < nk; }",
     "__device__ __forceinline__ bool tile_in_sum(int kt, int nk) "
     "{ return kt + 1 < nk; }", "fsdp_train",
     ("ag_matmul:", "fsdp step-0")),
    ("dot_q8_skipped", "ops/quant.py",
     "        return dequantize(q, s, a.dtype)",
     "        return torch.matmul(a, w)", "remat", ("remat save_dots_q8",)),
    ("resume_cursor_skipped", "resilience/supervisor.py",
     "        return self.restored.data_cursor if self.restored else 0",
     "        return 0", "resilience",
     ("resilience fsdp", "resilience ddp")),
    ("adam_count_not_restored", "utils/checkpoint.py",
     "            out[k] = got.to(v.device) if isinstance(v, torch.Tensor) "
     "else got",
     "            out[k] = got.to(v.device) if isinstance(v, torch.Tensor) "
     "else v", "resilience", ("resilience fsdp", "resilience zero3")),
    ("ckpt_live_tensors", "utils/checkpoint.py",
     "            out[k] = buf", "            out[k] = v", "resilience",
     ("resilience ddp crash",)),
    ("moe_capacity_plus_one", "parallel/expert.py",
     "            kept = (pos < capg) & (onehot > 0)",
     "            kept = (pos <= capg) & (onehot > 0)", "moe",
     ("moe oracle top-1 cf 0.75", "moe oracle top-2 cf 1.0")),
    ("moe_token_major_top2", "parallel/expert.py",
     "            onehot, pos = _group_slot_positions(eg, E)",
     "            onehot, pos = _group_slot_positions(eg, E); "
     "pos = torch.cumsum(onehot.reshape(NG, top_k, G, E).transpose(1, 2)"
     ".reshape(NG, G * top_k, E), dim=1, dtype=torch.int32).reshape("
     "NG, G, top_k, E).transpose(1, 2).reshape(NG, top_k * G, E) "
     "* onehot - 1", "moe", ("moe oracle top-2 cf 1.0",)),
    ("moe_shared_int8_scale", "parallel/expert.py",
     "    return torch.stack([dense(toks[e], bank[e]) for e in "
     "range(len(bank))])",
     "    E, M, N = len(bank), toks.shape[1], bank.shape[2]; "
     "full = dense(toks.reshape(E * M, -1), bank.transpose(0, 1).reshape("
     "bank.shape[1], E * N)); return torch.stack([full[e * M:(e + 1) * M, "
     "e * N:(e + 1) * N] for e in range(E)])", "moe",
     ("moe oracle top-1 cf 2.0 int8_pallas_bwd",)),
    ("moe_aux_dropped", "models/transformer.py",
     "        loss = loss + cfg.moe_aux_weight * aux",
     "        loss = loss + 0.0 * aux", "moe", ("moe loss sum",)),
    ("ring_causal_off_by_one", "ops/ring_attention.py",
     "    if src < my:      # an earlier block: every key visible",
     "    if src <= my:      # an earlier block: every key visible", "tp",
     ("ring contiguous O",)),
    ("zigzag_stripe_swapped", "ops/ring_attention.py",
     "    return torch.cat([my * w + ar, (2 * n - 1 - my) * w + ar])",
     "    return torch.cat([(2 * n - 1 - my) * w + ar, my * w + ar])", "tp",
     ("ring zigzag O",)),
    ("tp_rejoin_dropped", "models/transformer.py",
     "            attn_out = rejoin(attn_out)",
     "            attn_out = attn_out", "tp", ("tp step: collectives",)),
    ("composable_tp_sync_forgotten", "parallel/composable.py",
     "                optim.tree_get(specs, path)) else dp_tp) / n_total",
     "                optim.tree_get(specs, path)) else dp_axis) / n_total",
     "composable", ("composable law t2",)),
    ("composable_row_rule_swapped", "analysis/rules.py",
     "        Rule(rf\"^layers/({row})$\", (None, tp_axis, fsdp_axis),",
     "        Rule(rf\"^layers/({row})$\", (None, fsdp_axis, tp_axis),",
     "composable", ("composable step: step 0 collectives",
                    "composable law t2")),
    ("auto_grad_divide_skipped", "parallel/fsdp.py",
     "            grads = [p.grad.to_local() / ws for p in params]",
     "            grads = [p.grad.to_local() for p in params]",
     "composable", ("auto law",)),
    ("spec_accept_no_cumprod", "serving/engine.py",
     "    e = 1 + torch.cumprod(match, dim=1).sum(dim=1)",
     "    e = 1 + match.sum(dim=1)", "frontier",
     ("frontier spec 36 near-argmax", "int8 frontier near-argmax")),
    ("prefix_prefill_from_zero", "serving/scheduler.py",
     "            req.prefill_pos = len(nodes) * self.page_size",
     "            req.prefill_pos = 0", "frontier",
     ("frontier cache CoW law", "frontier cache prefix chunks")),
    ("trie_keeps_duplicate", "serving/kv_pool.py",
     "                self.allocator.free([pages[i]])",
     "                swaps.pop(i)", "frontier",
     ("int8 frontier run 1 allocator law",)),
    ("verify_rows_at_lengths", "serving/engine.py",
     "    apos = lengths[:, None] + ar[None, :]",
     "    apos = lengths[:, None] + 0 * ar[None, :]", "frontier",
     ("frontier spec 4 near-argmax", "frontier spec 36 near-argmax",
      "frontier spec 36 acceptance")),
    ("failover_no_replay_reset", "serving/scheduler.py",
     "            reset_for_replay(req)", "            pass",
     "fleet_failover", ("fleet kill tokens", "fleet hang tokens")),
    ("serve_tp_rejoin_dropped", "serving/engine.py",
     "        attn_out = C.all_reduce(attn_out, tp_axis)",
     "        attn_out = attn_out", "fleet_tp", ("tp serve collectives",)),
    ("handoff_page_off", "serving/engine.py",
     "        pre = torch.as_tensor(src, device=self._prefill_dev)",
     "        pre = torch.as_tensor(src[1:] + src[:1], "
     "device=self._prefill_dev)", "fleet_disagg",
     ("disaggregated float tokens", "disaggregated int8 tokens")),
    ("swap_in_flight", "serving/engine.py",
     "        return not self.batcher.has_work()", "        return True",
     "fleet_swap", ("fleet swap old-or-new",)),
    ("moe_route_decode_skew", "parallel/expert.py",
     "    probs = torch.softmax(logits, dim=-1)",
     "    probs = torch.softmax(logits + 2.0 * (x2d.shape[0] <= 8) * "
     "torch.arange(logits.shape[-1], device=logits.device), dim=-1)",
     "moe_serve", ("moe serve bf16 router probabilities",
                   "moe serve int8 router probabilities",
                   "moe serve f32 router probabilities",
                   "moe serve f32 route-aware near-argmax")),
    ("fa_hd64_qk_kstep", "csrc/flash_attention.cu",
     "__host__ __device__ constexpr int qk_steps(int hd) "
     "{ return hd / 16; }",
     "__host__ __device__ constexpr int qk_steps(int hd) "
     "{ return hd == 64 ? hd / 16 - 1 : hd / 16; }", "fa_hd64",
     ("flash_attention_fwd:", "flash_attention_fwd oracle:",
      "flash_attention_bwd:")),
    ("fa_hd64_pv_block_unscaled", "csrc/flash_attention.cu",
     "    for (int i = 0; i < acc_regs(HD); ++i) "
     "oacc[i] *= corr[(i / 2) % 2];",
     "    for (int i = 0; i < (HD == 64 ? acc_regs(HD) - 4 : acc_regs(HD)); "
     "++i) oacc[i] *= corr[(i / 2) % 2];", "fa_hd64",
     ("flash_attention_fwd:", "flash_attention_fwd oracle:")),
    ("pipeline_resume_no_adam", "parallel/pipeline.py",
     "        self.opt_state = opt_state",
     "        self.opt_state = self.opt_state", "pipeline_harness",
     ("pipeline harness: resumed losses",
      "pipeline harness: the resumed run's")),
    ("ledger_drops_reduce_scatter", "utils/trace_analysis.py",
     '    "c10d::_reduce_scatter_base_": "reduce_scatter",',
     '    "c10d::_reduce_scatter_base_#": "reduce_scatter",', "ledger",
     ("ledger fsdp:",)),
    ("remat_pallas_keeps_products", "models/transformer.py",
     "            return None   # a kernel is no dot: save_dots keeps what "
     "full keeps",
     "            return {INT8_DENSE_OP, FP8_DENSE_OP}", "remat22",
     ("int8_pallas_bwd save_dots: ", "bytes kept beyond full's",
      "from full's, over")),
    ("q8_residual_skipped", "models/transformer.py",
     "    return {DOT_Q8_OP}",
     "    return {DOT_Q8_OP, torch.ops.aten._to_copy.default}", "remat22",
     ("int8_pallas_bwd save_dots_q8: kept bytes ratio",
      "int8_pallas_bwd save_dots_q8: peak excess ratio")),
]
STEP0 = ("step-0 loss", "step-0 grads", "step-0 bf16 grads")

CHILD = {"fa_hd64": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
c.attention_hd64_phase()
c.family_parity("llama3.2-1b", c.FAMILY_TRAINS[0])
""", "moe_serve": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
rng = np.random.default_rng(c.SEED)
prompts = [rng.integers(1, c.CFG.vocab_size, size=int(rng.integers(
    *c.PROMPT_LEN))).astype(np.int32) for _ in range(c.N_REQUESTS)]
c.moe_serve_phase(prompts, c.card_line())
""", "serve": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
rng = np.random.default_rng(c.SEED)
gen = torch.Generator(device="cuda").manual_seed(c.SEED)
c.kernel_phase(rng, gen)
c.q8_decode_phase(rng, gen)   # the smoke's draws: the same prompts
params = c.build_params()
eng, reqs, _ = c.serve_phase(params, rng, c.card_line())
c.parity_phase(params, reqs, eng)
""", "train": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.fp8_phase()
c.attention_phase()
c.fa_bwd_oracle_gate()
c.train_parity_phase()
c.family_parity("llama3.2-1b", c.FAMILY_TRAINS[0])
try:
    c.moe_bf16_phase()
finally:
    c.mesh.destroy_process_group()
""", "train_pipeline": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.fp8_phase()
c.attention_phase()
c.fa_bwd_oracle_gate()
c.train_parity_phase()
c.pipeline_lm_parity_phase()
try:
    c.precision_parity_phase()
    c.precision_bench_parity_phase()
    c.moe_bf16_phase()
finally:
    c.mesh.destroy_process_group()
""", "train_precision": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.fp8_phase()
c.train_parity_phase()
try:
    c.precision_bench_parity_phase()
finally:
    c.mesh.destroy_process_group()
""", "remat": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.mesh.init_process_group("cuda")
try:
    c.remat_phase(c.card_line())
finally:
    c.mesh.destroy_process_group()
""", "remat22": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
c.mesh.init_process_group("cuda")
try:
    c.remat22_phase(c.card_line())
finally:
    c.mesh.destroy_process_group()
""", "int8_train": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.int8_gemm_phase()
c.int8_train_parity_phase()
""", "int8_train_precision": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.int8_gemm_phase()
c.int8_train_parity_phase()
try:
    c.precision_parity_phase()
    c.precision_bench_parity_phase()
finally:
    c.mesh.destroy_process_group()
""", "int8_serve": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
rng = np.random.default_rng(c.SEED)
gen = torch.Generator(device="cuda").manual_seed(c.SEED)
c.kernel_phase(rng, gen)
c.q8_decode_phase(rng, gen)
params = c.quantize_decode_params(c.build_params(), c.CFG)
eng, reqs, _ = c.int8_serve_phase(params, rng, c.card_line())
c.int8_parity_phase(params, reqs, eng)
""", "int8_decode": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.k4_decode_gates()
rng = np.random.default_rng(c.SEED)
gen = torch.Generator(device="cuda").manual_seed(c.SEED)
c.kernel_phase(rng, gen)
c.q8_decode_phase(rng, gen)
params = c.quantize_decode_params(c.build_params(), c.CFG)
eng, reqs, _ = c.int8_serve_phase(params, rng, c.card_line())
c.int8_parity_phase(params, reqs, eng)
""", "fsdp_train": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.ag_matmul_phase()
try:
    c.fsdp_train_parity_phase()
finally:
    c.mesh.destroy_process_group()
""", "moe": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
try:
    c.moe_parity_phase()
    c.moe_oracle_phase()
    c.moe_bf16_phase()
finally:
    c.mesh.destroy_process_group()
""", "tp": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
try:
    c.tp_parity_phase()
    c.ring_fold_phase()
finally:
    c.mesh.destroy_process_group()
""", "composable": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
try:
    c.composable_train_phase(c.card_line(), c.composable_parity_phase())
    c.composable_law_phase()
finally:
    c.mesh.destroy_process_group()
""", "frontier": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
rng = np.random.default_rng(c.SEED)
gen = torch.Generator(device="cuda").manual_seed(c.SEED)
c.kernel_phase(rng, gen)
c.q8_decode_phase(rng, gen)   # the smoke's draws: the same prompts
params = c.build_params()
card = c.card_line()
eng, reqs, _ = c.serve_phase(params, rng, card)
prompts, vanilla = [r.prompt for r in reqs], eng.slo_report()
del eng, reqs
c.frontier_phase(params, c.quantize_decode_params(params, c.CFG), prompts,
                 vanilla, card)
""", "resilience": """
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
try:
    c.resilience_phase(c.card_line())
finally:
    c.mesh.destroy_process_group()
""", "fleet_failover": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
card = c.card_line()
c.failover_phase(c.build_params(), card)
""", "fleet_swap": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
card = c.card_line()
c.swap_phase(card)
""", "fleet_tp": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
card = c.card_line()
c.mesh.init_process_group("cuda")
try:
    params = c.build_params()
    eng, reqs, _ = c.serve_phase(params, np.random.default_rng(c.SEED), card)
    serve = ([r.prompt for r in reqs], [list(r.tokens) for r in reqs])
    del eng, reqs
    c.tp_serve_phase(params, serve, card)
finally:
    c.mesh.destroy_process_group()
""", "pipeline_harness": """
import shutil, tempfile
from pathlib import Path
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
root = Path(tempfile.mkdtemp(prefix="phase21_"))
(root / "runs").mkdir()
try:
    c.pipeline_harness_phase(c.card_line(), root)
finally:
    shutil.rmtree(root, ignore_errors=True)
""", "ledger": """
import shutil, tempfile
from pathlib import Path
import torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
root = Path(tempfile.mkdtemp(prefix="phase21_"))
(root / "runs").mkdir()
try:
    c.ledger_phase(c.card_line(), root)
finally:
    c.mesh.destroy_process_group()
    shutil.rmtree(root, ignore_errors=True)
""", "fleet_disagg": """
import numpy as np, torch
import chip_smoke as c
def check(cond, msg):
    if not cond:
        print("[mutant] gate fails:", msg, flush=True)
c.check = check
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.loader.build_all()
card = c.card_line()
rng = np.random.default_rng(c.SEED)
params = c.build_params()
eng, reqs, _ = c.serve_phase(params, rng, card)
serve = ([r.prompt for r in reqs], [list(r.tokens) for r in reqs])
del eng, reqs
params_q8 = c.quantize_decode_params(params, c.CFG)
eng, reqs, _ = c.int8_serve_phase(params_q8, rng, card)
q8 = ([r.prompt for r in reqs], [list(r.tokens) for r in reqs])
del eng, reqs
c.disagg_phase(params, params_q8, serve, q8, card)
"""}


def run_mutant(name, source, sound, mutant, phases) -> list[str] | None:
    """The failed-gate lines of one mutant's run, or None if the run
    itself failed."""
    work = WORK / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    shutil.copy(ROOT / "chip_smoke.py", work)
    shutil.copytree(ROOT / PKG, work / PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = work / PKG / source
    text = path.read_text()
    if text.count(sound + "\n") != 1:
        print(f"[mutant] {name}: the line {sound!r} is not in {source} "
              f"once", file=sys.stderr)
        return None
    path.write_text(text.replace(sound + "\n", mutant + "\n"))
    out = subprocess.run([sys.executable, "-c", CHILD[phases]], cwd=work,
                         capture_output=True, text=True, timeout=1200)
    for line in out.stdout.splitlines():
        print(f"[{name}] {line}", flush=True)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        return None
    return [ln for ln in out.stdout.splitlines()
            if ln.startswith("[mutant] gate fails:")]


def main(argv) -> int:
    ok, step0 = True, []
    chosen = [m for m in MUTANTS if not argv or m[0] in argv]
    if len(chosen) != len(argv or MUTANTS):
        print(f"[mutant] unknown mutants in {argv}", file=sys.stderr)
        return 2
    for name, source, sound, mutant, phases, expected in chosen:
        fails = run_mutant(name, source, sound, mutant, phases)
        if fails is None:
            return 1
        missed = [g for g in expected if not any(g in ln for ln in fails)]
        if missed:
            ok = False
            print(f"[mutant] {name}: gates that let it through: {missed}",
                  file=sys.stderr)
        else:
            print(f"[mutant] {name}: every expected gate failed: "
                  f"{list(expected)}", flush=True)
        if phases.startswith("train") and any(g in ln for ln in fails
                                              for g in STEP0):
            step0.append(name)
    print(f"[mutant] the step-0 loss or grad gate failed on: {step0}",
          flush=True)
    if not step0 and any(m[4].startswith("train") for m in chosen):
        print("[mutant] the step-0 gates let every training mutant through",
              file=sys.stderr)
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
