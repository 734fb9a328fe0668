"""Chunked-prefill flash attention over the paged pool: the CUDA kernel
``csrc/flash_prefill.cu`` and its plain PyTorch version.

Port of the JAX package's ``ops/flash_prefill.py``.  The reference has
two modes: one tile, which rounds the normalised probabilities to the
activation dtype before PV exactly as the engine's gather-then-einsum
path does, and an online softmax over ``kv_block_pages`` blocks, which
rounds unnormalised weights.  The kernel computes the first (it takes
two passes over the keys to have the softmax max and sum before it
rounds); the plain version is the gather path itself
(:func:`.paged_attention.gather_attention`).  Float pools only, as in
the reference.  A bf16 pool (the serve's) runs QKᵀ and PV on the tensor
cores (wgmma, K/V tiles through a cp.async ring); an f32 pool runs the
CUDA-core kernel of the same source, whose f32 products meet its f32
tolerance (TF32 tensor cores would not).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises.  Tolerance of the kernel against the
plain version (``TOLERANCE``): ``atol = rtol = 1e-5`` on an f32 pool;
``atol = 1e-3, rtol = 0`` on a bf16 pool, for the reason the decode
kernel states.

The bf16 atol is the ONE-DRAW limit: ``chip_smoke.py``'s kernel phase
holds one draw of the serve shapes to it, where the kernel reads 3.7e-4
on an H100 and a kernel that truncates the probabilities instead of
rounding them reads 3.9e-3.  Over many draws a single output can pass
it without any fault of the kernel: the kernel and the plain path each
compute the normalised probabilities in f32 in their own summation
order, and where one lands within an f32 ulp of a bf16 rounding boundary
the two round it to neighbouring bf16 values; one such flip of a large
probability moves an output by up to ~1.6e-3.
:func:`paged_flash_prefill_oracle` (the reference's arithmetic in f64)
tells which side strays.  Two MULTI-DRAW limits, over
``chip_smoke.COMPARE_DRAWS`` draws of each of ``chip_smoke.K3_DRAW_SEEDS``:
``DRAW_COUNT_LIMIT``, the count of outputs that ``|kernel - plain|``
puts off by more than ``atol / 4`` (:func:`off_count`) on one seed's
draws; and ``ORACLE_COUNT_RATIO``, the kernel's count of outputs off
the oracle by more than ``atol / 4`` over the plain path's, summed over
the seeds: the kernel may stray from the reference's arithmetic about
as often as the plain path does, and no more.  On an H100, over 2 x 10 draws: the
kernel 249 and 114 against the plain path (max 1.297e-3, at outputs
where the plain path is 1.297e-3 off the oracle and the kernel 1.7e-7);
against the oracle the kernel 347, the plain path 336 (ratio 1.03).  A
kernel that carried QKᵀ's tensor-core sum across all of hd read 229 and
238 and ratio 1.85, and alone strayed at every output past atol; one
that truncates the probabilities 1.1e7, one that loses each row's own
key 2.7e7 (``chip_gate_mutation.py``; PERF.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import LaunchCount, check_cuda_operands, launch, loader, ptr
from .paged_attention import gather_attention

__all__ = ["paged_flash_prefill", "paged_flash_prefill_plain",
           "paged_flash_prefill_oracle", "off_count", "COUNTS", "TOLERANCE",
           "DRAW_COUNT_LIMIT", "ORACLE_COUNT_RATIO"]

COUNTS = LaunchCount()
# (atol, rtol) of the kernel against the plain version, by pool dtype
TOLERANCE = {torch.bfloat16: (1e-3, 0.0), torch.float32: (1e-5, 1e-5)}
# the bf16 multi-draw gates (see the module docstring): outputs off the
# plain path by more than atol / 4 on one seed's draws; the kernel's
# count off the oracle over the plain path's
DRAW_COUNT_LIMIT = 600
ORACLE_COUNT_RATIO = 1.3
QUERY_VECTORS, MAX_HD = 64, 128   # the kernel's limits (csrc/flash_prefill.cu)


def paged_flash_prefill_plain(qg, pk, pv, pages, apos):
    """The prefill kernel's plain version, on any device; every call is
    counted in ``COUNTS.plain_calls``."""
    COUNTS.plain_calls += 1
    return gather_attention(qg, pk, pv, pages, apos)


def paged_flash_prefill_oracle(qg, pk, pv, pages, apos):
    """The reference's arithmetic in f64, uncounted: scores q·k in f64
    times the f32 constant ``f32(1) / f32(sqrt(hd))``, the causal mask
    (key ``t`` visible iff ``t <= apos``), softmax in f64, the
    normalised probabilities rounded to f32 and then to qg's dtype (the
    reference rounds its f32 probabilities), PV in f64.  Same arguments as
    :func:`paged_flash_prefill`; returns f64 (B, S, n_kv, rep, hd).
    Where a probability sits on a rounding boundary this rounds it from
    its f64 value, which both f32 paths straddle."""
    B, S = qg.shape[:2]
    V = pages.shape[1] * pk.shape[1]
    pg = pages.long()
    gk = pk[pg].reshape(B, V, *pk.shape[2:]).double()
    gv = pv[pg].reshape(B, V, *pv.shape[2:]).double()
    inv = float(np.float32(1.0) / np.float32(math.sqrt(qg.shape[-1])))
    scores = torch.einsum("bsgrh,bkgh->bgrsk", qg.double(), gk) * inv
    vis = torch.arange(V, device=qg.device)[None, None, :] \
        <= apos[:, :, None]
    scores = scores.masked_fill(~vis[:, None, None], -math.inf)
    probs = torch.softmax(scores, dim=-1).float().to(qg.dtype).double()
    return torch.einsum("bgrsk,bkgh->bsgrh", probs, gv)


def off_count(got, ref, thresh: float) -> int:
    """The number of elements with ``|got - ref| > thresh``, compared in
    f64 (the multi-draw gate's reading, with ``thresh = atol / 4``)."""
    return int(((got.double() - ref.double()).abs() > thresh).sum())


def paged_flash_prefill(qg, pk, pv, pages, apos):
    """Paged flash attention for a prefill chunk, pages read in place.

    qg (B, S, n_kv, rep, hd); pk/pv (n_pages, page, n_kv, hd) float
    pools; pages (B, P) int32; apos (B, S) int32 absolute positions of
    the chunk's rows, each ≥ 0.  Returns f32 (B, S, n_kv, rep, hd); the
    caller applies the ``astype`` epilogue."""
    if pk.dtype == torch.int8:
        raise ValueError("flash prefill is float-pool only (int8 scale "
                         "folding does not commute with the online "
                         "rescale)")
    if qg.device.type == "cpu":
        return paged_flash_prefill_plain(qg, pk, pv, pages, apos)
    B, S, nkv, rep, hd = qg.shape
    code = check_cuda_operands(
        "paged_flash_prefill", {"qg": qg, "pk": pk, "pv": pv},
        {"pages": pages, "apos": apos})
    if pk.shape[2:] != (nkv, hd) or pv.shape != pk.shape:
        raise ValueError(f"pool shape {tuple(pk.shape)} does not match "
                         f"qg {tuple(qg.shape)}")
    if pages.shape[0] != B or apos.shape != (B, S):
        raise ValueError("pages must be (B, P) and apos (B, S)")
    if QUERY_VECTORS % rep or hd > MAX_HD or hd % 8:
        raise ValueError(f"kernel takes rep dividing {QUERY_VECTORS} and "
                         f"hd <= {MAX_HD}, a multiple of 8; got rep={rep} "
                         f"hd={hd}")
    if any(t.data_ptr() % 16 for t in (qg, pk, pv)):
        raise ValueError("paged_flash_prefill: qg, pk and pv must be "
                         "16-byte aligned (16-byte row copies)")
    out = torch.empty((B, S, nkv, rep, hd), dtype=torch.float32,
                      device=qg.device)
    launch("paged_flash_prefill",
           loader.load("flash_prefill").flash_prefill_launch,
           ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(out),
           B, S, pages.shape[1], pk.shape[1], nkv, rep, hd, code,
           device=qg.device)
    COUNTS.launches += 1
    return out
