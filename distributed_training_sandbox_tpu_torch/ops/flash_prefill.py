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
the reference.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises.  Tolerance of the kernel against the
plain version (``TOLERANCE``): ``atol = rtol = 1e-5`` on an f32 pool;
``atol = 1e-3, rtol = 0`` on a bf16 pool, for the reason the decode
kernel states.  On an H100 at the serve shapes (``chip_smoke.py``
kernel phase) the kernel reads 6.3e-4, and a kernel that skips the
probabilities' rounding reads 1.9e-3; the limit lies between the two.
"""

from __future__ import annotations

import torch

from ..kernels import (LaunchCount, check_cuda_operands, loader, ptr,
                       raise_on_error, stream_ptr)
from .paged_attention import gather_attention

__all__ = ["paged_flash_prefill", "paged_flash_prefill_plain", "COUNTS",
           "TOLERANCE"]

COUNTS = LaunchCount()
# (atol, rtol) of the kernel against the plain version, by pool dtype
TOLERANCE = {torch.bfloat16: (1e-3, 0.0), torch.float32: (1e-5, 1e-5)}
QUERY_VECTORS, MAX_HD = 64, 128   # the kernel's limits (csrc/flash_prefill.cu)


def paged_flash_prefill_plain(qg, pk, pv, pages, apos):
    """The prefill kernel's plain version, on any device; every call is
    counted in ``COUNTS.plain_calls``."""
    COUNTS.plain_calls += 1
    return gather_attention(qg, pk, pv, pages, apos)


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
    out = torch.empty((B, S, nkv, rep, hd), dtype=torch.float32,
                      device=qg.device)
    fn = loader.load("flash_prefill").flash_prefill_launch
    rc = fn(ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(out),
            B, S, pages.shape[1], pk.shape[1], nkv, rep, hd, code,
            stream_ptr(qg.device))
    raise_on_error("paged_flash_prefill", rc)
    COUNTS.launches += 1
    return out
