#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s accuracy gates.

    python3 chip_gate_mutation.py

Needs the card, as ``chip_smoke.py`` does.  For each mutant it copies
the port and ``chip_smoke.py`` into ``build/gate_mutation/<mutant>/``,
changes one line of one kernel source there, and runs the smoke's
phases that read that kernel on the copy, with every gate logged
instead of raised.  Each mutant is a step of the reference's arithmetic
left out or done in lower precision, so that its output stays close to
the sound kernel's (one, ``dot_q8_skipped``, edits a Python module of
the port instead):

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
  the forward's gate must fail;
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
  plain attention (``precision plain``) and the flash kernels on 13c's
  rows' inputs (``precision bench attention``) must fail;
- ``fa_fwd_bf16_scores``: the flash forward rounds each tensor-core
  score to bf16 before scaling it; the forward's count against the f64
  oracle (over the plain path's) must fail;
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
- ``dot_q8_skipped``: the ``save_dots_q8`` projection
  (``ops/quant.py``, ``dot_q8``) hands on the bf16 product instead of
  its int8 round-trip, while the policy still keeps the codes; phase
  13b's ``save_dots_q8`` gate (its loss must differ from ``full``'s)
  must fail.

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
     f"{ROUND.format('p')}; }}", "train", ("flash_attention_fwd:",)),
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
      "precision bench attention")),
    ("fa_fwd_bf16_scores", "csrc/flash_attention.cu",
     "__device__ __forceinline__ float fwd_score(float s, float scale) "
     "{ return s * scale; }",
     "__device__ __forceinline__ float fwd_score(float s, float scale) "
     f"{{ return {ROUND.format('s')} * scale; }}", "train",
     ("flash_attention_fwd oracle:",)),
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
]
STEP0 = ("step-0 loss", "step-0 grads", "step-0 bf16 grads")

CHILD = {"serve": """
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
