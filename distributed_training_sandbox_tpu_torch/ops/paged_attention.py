"""Paged-attention decode: the CUDA kernels ``csrc/paged_decode.cu``
(K1, float pools) and ``csrc/paged_decode_q8.cu`` (K2, int8 pools) and
their plain PyTorch versions.

Port of the JAX package's ``ops/paged_attention.py``.  The kernels read
the slot's pages in place through the page table; the plain versions
gather them into a contiguous ``(B, V, n_kv, hd)`` view and run the
reference's einsums — the gather path of the serving engine
(``serving/engine._paged_layer_body``), which is what the reference
kernel is defined to equal.  The int8 one (``gather_attention_q8``) is
the op-for-op copy of the engine's int8 branch, in the form the
reference's jitted step computes: ``/ math.sqrt(hd)`` becomes a
multiplication by ``f32(1/sqrt(hd))`` under ``jax.jit``, and the
requantisation of the v-scaled probabilities takes the jitted
``quantize_int8`` (``ops/quant.py``).  Its integer contractions are
exact on every device (``quant.int_einsum_exact``).

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
  reads 5.1e-6 (an earlier, split-K design 4.7e-5), a kernel that skips
  the probabilities' rounding 6.7e-4, and one that loses each slot's
  own key 3.8e-2; the limit lies between.
- int8 pool (K2, ``TOLERANCE_Q8``): ``atol = 2.5e-3, rtol = 0``.  The
  kernel's softmax sums in another order, so a probability can differ
  by an f32 ulp, which now and then moves one code of the requantised
  ``p · vs`` across a rounding boundary: one step of ``sc · |v|``, at
  most the row's ``p · vs`` absmax (about 1.2e-3 at the serve shapes'
  inputs), in that output element; an ulp of that absmax moves the
  row's scale, and every output of the row, by about an ulp.  On an
  H100 at those shapes the kernel reads 4.5e-8 (no code moved), and its
  mutants read 3.9e-2 (each slot's own key lost), 0.12 (a rank's
  partial sums lost) and 0.42 (each block of the cluster requantising
  with its own absmax); the limit lies between a moved code and the
  mutants.
"""

from __future__ import annotations

import math

import torch

from ..kernels import LaunchCount, check_cuda_operands, launch, loader, ptr
from .quant import f32_recip, int_einsum_exact, quantize_int8

__all__ = ["paged_attention_decode", "paged_attention_plain",
           "paged_attention_plain_q8", "gather_attention",
           "gather_attention_q8", "attend_q8", "COUNTS", "Q8_COUNTS",
           "TOLERANCE", "TOLERANCE_Q8"]

COUNTS = LaunchCount()
# K2 (int8 pools): launches, and S == 1 plain calls (the wrapper's CPU
# branch and the engine's plain decode path); int8 prefill (S > 1) has
# no kernel, in the reference too, and is not counted
Q8_COUNTS = LaunchCount()
# (atol, rtol) of the kernel against the plain version, by pool dtype
TOLERANCE = {torch.bfloat16: (2e-4, 0.0), torch.float32: (1e-5, 1e-5)}
# (atol, rtol) of K2 against its plain version, on its f32 output
TOLERANCE_Q8 = (2.5e-3, 0.0)
MAX_REP, MAX_HD = 8, 128   # the kernels' limits (csrc/paged_decode*.cu)
# K1's blocks a (slot, kv head), and the bytes of K and V rows a block
# holds at once (csrc/paged_decode.cu kCluster, kRowBytes): a block whose
# range is longer takes it in sub-ranges of rows_held positions
CLUSTER, ROW_BYTES = 8, 57344
# K2's, likewise (csrc/paged_decode_q8.cu kCluster, kRowBytes; its rows
# are int8 codes)
Q8_CLUSTER, Q8_ROW_BYTES = 8, 57344


def rows_held(view: int, hd: int, itemsize: int) -> int:
    """The positions of K and V a K1 block holds at once in a view of
    ``view`` positions (``rows_held`` in csrc/paged_decode.cu)."""
    return min(ROW_BYTES // (2 * hd * itemsize), -(-view // CLUSTER))


def rows_held_q8(view: int, hd: int) -> int:
    """The positions of K and V a K2 block holds at once in a view of
    ``view`` positions (``rows_held`` in csrc/paged_decode_q8.cu)."""
    return min(Q8_ROW_BYTES // (2 * hd), -(-view // Q8_CLUSTER))


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


def attend_q8(qq, qs, k, v, ks, vs, vis):
    """The reference's int8 attention core, op for op (``engine.py``
    lines 199-226, ``generate.py`` lines 202-226): qq int8 (B, S, g, r,
    hd) with scales qs (B, S, g, r, 1); k/v int8 (B, V, g, hd) with
    scales ks/vs (B, V, g, 1), position-major; vis (B, S, V) bool.
    Returns f32 (B, S, g, r, hd)."""
    hd = qq.shape[-1]
    scores = int_einsum_exact("bsgrh,bkgh->bgrsk", qq, k)
    scores = (scores * qs[..., 0].permute(0, 2, 3, 1)[..., None]
              * ks[..., 0].permute(0, 2, 1)[:, :, None, None, :]) \
        * f32_recip(math.sqrt(hd))
    scores = scores.masked_fill(~vis[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    pvw = probs * vs[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    pvq, pv_sc = quantize_int8(pvw, axis=-1)
    attn = int_einsum_exact("bgrsk,bkgh->bsgrh", pvq, v)
    return attn * pv_sc[..., 0].permute(0, 3, 1, 2)[..., None]


def gather_attention_q8(qq, qs, pk, pv, pk_s, pv_s, pages, apos):
    """The engine's int8 gather path: the slot's pages and their scales
    gathered into the contiguous view, then :func:`attend_q8`.  K2's
    plain version, and the int8 prefill path (which has no kernel).

    qq (B, S, n_kv, rep, hd) int8 with qs (B, S, n_kv, rep, 1) f32;
    pk/pv (n_pages, page, n_kv, hd) int8 with pk_s/pv_s (n_pages, page,
    n_kv, 1) f32; pages (B, P) int; apos (B, S) int."""
    B = qq.shape[0]
    V = pages.shape[1] * pk.shape[1]

    def view(pool):
        return pool[pages.long()].reshape(B, V, *pool.shape[2:])

    vis = torch.arange(V, device=qq.device)[None, None, :] \
        <= apos[:, :, None]
    return attend_q8(qq, qs, view(pk), view(pv), view(pk_s), view(pv_s),
                     vis)


def paged_attention_plain_q8(qq, qs, pk, pv, pk_s, pv_s, pages, apos):
    """K2's plain version, on any device; every call is counted in
    ``Q8_COUNTS.plain_calls``."""
    Q8_COUNTS.plain_calls += 1
    return gather_attention_q8(qq, qs, pk, pv, pk_s, pv_s, pages, apos)


def paged_attention_plain(qg, pk, pv, pages, apos):
    """The decode kernel's plain version, on any device; every call is
    counted in ``COUNTS.plain_calls``."""
    COUNTS.plain_calls += 1
    return gather_attention(qg, pk, pv, pages, apos)


def paged_attention_decode(qg, pk, pv, pages, apos, *, q_scale=None,
                           pk_s=None, pv_s=None):
    """Decode-step (S == 1) paged attention, pages read in place.

    qg (B, 1, n_kv, rep, hd); pk/pv (n_pages, page, n_kv, hd); pages
    (B, P) int32; apos (B, 1) int32, each ≥ 0.  An int8 pool takes qg as
    int8 codes with ``q_scale`` (B, 1, n_kv, rep, 1) f32 and the pool's
    scales ``pk_s``/``pv_s`` (n_pages, page, n_kv, 1) f32, and goes to
    K2.  Returns f32 (B, 1, n_kv, rep, hd); the caller applies the
    ``astype`` epilogue."""
    B, S, nkv, rep, hd = qg.shape
    if S != 1:
        raise ValueError(f"decode kernel is S==1 only, got S={S}")
    if pk.dtype == torch.int8:
        if q_scale is None or pk_s is None or pv_s is None:
            raise ValueError("int8 pool needs q_scale, pk_s and pv_s")
        return _decode_q8(qg, q_scale, pk, pv, pk_s, pv_s, pages, apos)
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
    if pk.data_ptr() % 16 or pv.data_ptr() % 16:
        raise ValueError("paged_attention_decode: the pools must be 16-byte "
                         "aligned")
    lib = loader.load("paged_decode")
    geom = (B, pages.shape[1], pk.shape[1], nkv, rep)
    # a long view's scores do not fit in shared memory: the kernel then
    # keeps them in this scratch
    n_scores = lib.paged_decode_scratch_floats(*geom)
    scores = torch.empty(n_scores, dtype=torch.float32, device=qg.device) \
        if n_scores else None
    out = torch.empty((B, 1, nkv, rep, hd), dtype=torch.float32,
                      device=qg.device)
    launch("paged_attention_decode", lib.paged_decode_launch,
           ptr(qg), ptr(pk), ptr(pv), ptr(pages), ptr(apos),
           ptr(scores) if n_scores else None, ptr(out), *geom, hd, code,
           device=qg.device)
    COUNTS.launches += 1
    return out


def _decode_q8(qq, qs, pk, pv, pk_s, pv_s, pages, apos):
    """K2, or its plain version for CPU tensors."""
    if qq.device.type == "cpu":
        return paged_attention_plain_q8(qq, qs, pk, pv, pk_s, pv_s, pages,
                                        apos)
    B, _, nkv, rep, hd = qq.shape
    for name, t, dt in (("qg", qq, torch.int8), ("pk", pk, torch.int8),
                        ("pv", pv, torch.int8), ("q_scale", qs, torch.float32),
                        ("pk_s", pk_s, torch.float32),
                        ("pv_s", pv_s, torch.float32)):
        if t.dtype != dt:
            raise ValueError(f"paged_attention_decode: {name} must be {dt}, "
                             f"got {t.dtype}")
    check_cuda_operands("paged_attention_decode",
                        {"q_scale": qs, "pk_s": pk_s, "pv_s": pv_s},
                        {"pages": pages, "apos": apos},
                        {"qg": qq, "pk": pk, "pv": pv})
    if pk.shape[2:] != (nkv, hd) or pv.shape != pk.shape:
        raise ValueError(f"pool shape {tuple(pk.shape)} does not match "
                         f"qg {tuple(qq.shape)}")
    if pk_s.shape != (*pk.shape[:3], 1) or pv_s.shape != pk_s.shape \
            or qs.shape != (B, 1, nkv, rep, 1):
        raise ValueError("scales must be (n_pages, page, n_kv, 1) and "
                         "q_scale (B, 1, n_kv, rep, 1)")
    if pages.shape[0] != B or apos.shape != (B, 1):
        raise ValueError("pages must be (B, P) and apos (B, 1)")
    if not (1 <= rep <= MAX_REP and 16 <= hd <= MAX_HD and hd % 16 == 0):
        raise ValueError(f"kernel takes rep <= {MAX_REP} and hd <= "
                         f"{MAX_HD}, a multiple of 16; got rep={rep} hd={hd}")
    if qq.data_ptr() % 16 or pk.data_ptr() % 16 or pv.data_ptr() % 16:
        raise ValueError("paged_attention_decode: qg and the pools must be "
                         "16-byte aligned")
    lib = loader.load("paged_decode_q8")
    geom = (B, pages.shape[1], pk.shape[1], nkv, rep, hd)
    # a long view's scores do not fit in shared memory: the kernel then
    # keeps them in this scratch
    n_scratch = lib.paged_decode_q8_scratch_floats(*geom)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=qq.device) \
        if n_scratch else None
    out = torch.empty((B, 1, nkv, rep, hd), dtype=torch.float32,
                      device=qq.device)
    launch("paged_attention_decode", lib.paged_decode_q8_launch,
           ptr(qq), ptr(qs), ptr(pk), ptr(pv), ptr(pk_s), ptr(pv_s),
           ptr(pages), ptr(apos), ptr(scratch) if n_scratch else None,
           ptr(out), *geom, device=qq.device)
    Q8_COUNTS.launches += 1
    return out
