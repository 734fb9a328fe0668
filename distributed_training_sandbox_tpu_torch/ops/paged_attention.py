"""Paged-attention decode: the CUDA kernel ``csrc/paged_decode.cu`` and
its plain PyTorch version.

Port of the JAX package's ``ops/paged_attention.py`` (float pools).  The
kernel reads the slot's pages in place through the page table; the
plain version gathers them into a contiguous ``(B, V, n_kv, hd)`` view
and runs the reference's einsums — the gather path of the serving
engine (``serving/engine._paged_layer_body``), which is what the
reference kernel is defined to equal.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor
launches the kernel or raises.  There is no fallback between them.

The kernel rounds the normalised probabilities to the pool's dtype before
the PV contraction, as the reference does.  Tolerance of the kernel
against the plain version on the same inputs (``TOLERANCE``):

- f32 pool: ``atol = rtol = 1e-5``; only the summation order differs.
- bf16 pool: ``atol = 2e-4, rtol = 0``.  The kernel's f32 softmax can
  land a probability on the other side of a bf16 rounding boundary from
  the plain version's, which moves that term by one bf16 ulp.  On an
  H100 at the serve shapes (``chip_smoke.py`` kernel phase) the kernel
  reads 4.7e-5, and a kernel that skips the probabilities' rounding
  reads 6.7e-4; the limit lies between the two.
"""

from __future__ import annotations

import math

import torch

from ..kernels import (LaunchCount, check_cuda_operands, loader, ptr,
                       raise_on_error, stream_ptr)

__all__ = ["paged_attention_decode", "paged_attention_plain",
           "gather_attention", "COUNTS", "TOLERANCE"]

COUNTS = LaunchCount()
# (atol, rtol) of the kernel against the plain version, by pool dtype
TOLERANCE = {torch.bfloat16: (2e-4, 0.0), torch.float32: (1e-5, 1e-5)}
MAX_REP, MAX_HD = 8, 128   # the kernel's limits (csrc/paged_decode.cu)


def gather_attention(qg, pk, pv, pages, apos):
    """The reference's gather-then-einsum paged attention, op for op —
    the body of both kernels' plain versions.

    qg (B, S, n_kv, rep, hd); pk/pv (n_pages, page, n_kv, hd); pages
    (B, P) int; apos (B, S) int absolute positions of qg's rows.
    Key position ``t`` of the gathered view is absolute position ``t``,
    so the causal mask is ``t <= apos``; masked positions score −1e30
    and get probability exactly 0.  Scores and the PV sum are f32; the
    probabilities are rounded to qg's dtype before PV.  Returns f32
    (B, S, n_kv, rep, hd)."""
    B, S = qg.shape[:2]
    V = pages.shape[1] * pk.shape[1]
    gk = pk[pages].reshape(B, V, *pk.shape[2:])
    gv = pv[pages].reshape(B, V, *pv.shape[2:])
    scores = torch.einsum("bsgrh,bkgh->bgrsk", qg.float(), gk.float()) \
        / math.sqrt(qg.shape[-1])
    vis = torch.arange(V, device=qg.device)[None, None, :] \
        <= apos[:, :, None]                                   # (B, S, V)
    scores = scores.masked_fill(~vis[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrsk,bkgh->bsgrh", probs.to(qg.dtype).float(),
                        gv.float())


def paged_attention_plain(qg, pk, pv, pages, apos):
    """The decode kernel's plain version, on any device; every call is
    counted in ``COUNTS.plain_calls``."""
    COUNTS.plain_calls += 1
    return gather_attention(qg, pk, pv, pages, apos)


def paged_attention_decode(qg, pk, pv, pages, apos):
    """Decode-step (S == 1) paged attention, pages read in place.

    qg (B, 1, n_kv, rep, hd); pk/pv (n_pages, page, n_kv, hd); pages
    (B, P) int32; apos (B, 1) int32, each ≥ 0.  Returns f32
    (B, 1, n_kv, rep, hd); the caller applies the ``astype`` epilogue."""
    B, S, nkv, rep, hd = qg.shape
    if S != 1:
        raise ValueError(f"decode kernel is S==1 only, got S={S}")
    if qg.device.type == "cpu":
        return paged_attention_plain(qg, pk, pv, pages, apos)
    code = check_cuda_operands(
        "paged_attention_decode", {"qg": qg, "pk": pk, "pv": pv},
        {"pages": pages, "apos": apos})
    if pk.shape[2:] != (nkv, hd) or pv.shape != pk.shape:
        raise ValueError(f"pool shape {tuple(pk.shape)} does not match "
                         f"qg {tuple(qg.shape)}")
    if pages.shape[0] != B or apos.shape != (B, 1):
        raise ValueError("pages must be (B, P) and apos (B, 1)")
    if not (1 <= rep <= MAX_REP and hd <= MAX_HD and hd % 8 == 0):
        raise ValueError(f"kernel takes rep <= {MAX_REP} and hd <= "
                         f"{MAX_HD}, a multiple of 8; got rep={rep} hd={hd}")
    lib = loader.load("paged_decode")
    geom = (B, pages.shape[1], pk.shape[1], nkv, rep, hd)
    scratch = torch.empty(lib.paged_decode_scratch_floats(*geom),
                          dtype=torch.float32, device=qg.device)
    out = torch.empty((B, 1, nkv, rep, hd), dtype=torch.float32,
                      device=qg.device)
    rc = lib.paged_decode_launch(
        ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos), ptr(scratch),
        ptr(out), *geom, code, stream_ptr(qg.device))
    raise_on_error("paged_attention_decode", rc)
    COUNTS.launches += 1
    return out
