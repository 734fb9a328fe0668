"""Causal GQA flash attention, forward and backward: the CUDA kernels
``csrc/flash_attention.cu`` and their plain PyTorch version.

Counterpart of the JAX package's ``transformer._attention_flash`` (jax's
splash kernel).  ``flash_attention(q, k, v, scale)`` takes the reference
layout: q (B, S, nq, hd), k and v (B, S, nkv, hd) with ``nkv`` dividing
``nq``, and returns (B, S, nq, hd) in q's dtype.

The plain version is ``transformer._attention_xla``'s math
(:func:`attention_plain`): f32 scores scaled after the product, the
-1e30 causal mask, softmax in f32, the probabilities rounded to q's
dtype before PV.  The kernel scales the f32 scores in the same place;
the splash path instead rounds ``q·scale`` to bf16 before its kernel,
which the port does not copy.  There is no einsum fallback for ragged
S as the reference has (``S % 128``): the kernels mask ragged tiles.

Dispatch: CPU tensors take the plain version, forward and backward
(counted in ``FWD_COUNTS.plain_calls`` and ``BWD_COUNTS.plain_calls``);
CUDA tensors launch the kernels or raise.  The forward is one
dispatcher op, ``dtsb_torch::attention_fwd`` (a
``torch.library.custom_op`` with its backward registered), so that a
selective-checkpoint policy can keep its output instead of launching it
again in the recompute (the ``save_attn`` remat policy).  ``FWD_COUNTS.launches`` counts
forward launches; ``BWD_COUNTS.launches`` counts backward launches, one
per backward call (its three kernels: D, dK/dV, dQ).

Tolerances against the plain version on bf16 inputs, each set between
the sound kernel's reading and a mutant's (``chip_smoke.py``,
``chip_gate_mutation.py``): ``TOLERANCE``, elementwise ``(atol, rtol)``
for O, dQ, dK and dV; ``BLOCK_REL_L2`` for the relative L2 error of
each 64-row block of one head; ``LSE_ATOL`` for the f32 logsumexp.  The
kernels round ``exp(s - m_running)`` and dS to bf16 where the plain path
rounds the normalised probabilities and dP, so the two differ by a bf16
ulp or two of the largest terms of a sum.  In the first rows and keys a
few large terms cancel to a small entry, and there that difference sets
the elementwise atol; the block gate holds the small entries of late
rows and keys to their own scale.  The logsumexp differs only by the
order of f32 sums.

A multi-draw reading beside an f64 oracle of the reference's arithmetic
(:func:`attention_oracle`; ``chip_smoke.fa_oracle_reading``): over
``chip_smoke.FA_ORACLE_DRAWS`` draws the count of O's outputs off the
oracle by more than a quarter of the elementwise tolerance
(:func:`off_count`), the kernel's over the plain path's, is held to
``ORACLE_COUNT_RATIO``.  The kernel rounds ``exp(s - m)`` where the
reference rounds the normalised probability, so it strays from the
oracle more often than the plain path does, by design (the plain path
rounds the same normalised probabilities as the oracle, and its
outputs stay within a quarter of the tolerance of it); the limit lies
between that and a kernel whose scores lose precision.

The backward's elementwise tolerance was set at B 1, S 8192.  At a
pipeline stage's microbatch (B 16, S 256) the plain path's own distance
from the exact gradient is of the kernel's order: its autograd rounds
the normalised probabilities and dP to bf16 (the bf16 PV product's
backward), where the kernel rounds ``exp(s - lse)`` and dS, so the two
paths differ elementwise by more than the tolerance at about half the
grads of a few draws, with either one the farther from the exact
gradient at that element.  There
each of dQ, dK and dV is held to the exact gradient in f64
(:func:`attention_bwd_oracle`): its L2 distance from it over the plain
path's (:func:`oracle_l2_ratio`) at most ``BWD_ORACLE_L2_RATIO``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..kernels import LaunchCount, check_cuda_operands, launch, loader, ptr

__all__ = ["flash_attention", "attention_saved", "ATTENTION_OP",
           "attention_plain", "attention_plain_lse",
           "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_bwd_plain", "attention_oracle",
           "attention_bwd_oracle", "off_count", "oracle_l2_ratio",
           "block_rel_l2", "FWD_COUNTS", "BWD_COUNTS", "TOLERANCE",
           "BLOCK_REL_L2", "LSE_ATOL", "ORACLE_COUNT_RATIO",
           "BWD_ORACLE_L2_RATIO"]

FWD_COUNTS = LaunchCount()
BWD_COUNTS = LaunchCount()
# (atol, rtol) of the kernels' O and dQ/dK/dV against the plain version,
# element by element
TOLERANCE = {"fwd": (6e-3, 2e-2), "bwd": (1.5e-2, 2e-2)}
# ... and the largest relative L2 error of a block of BLOCK_ROWS
# sequence positions of one head (:func:`block_rel_l2`), for each of O,
# dQ, dK and dV
BLOCK_REL_L2 = 1e-2
BLOCK_ROWS = 64
LSE_ATOL = 1e-4
# the forward's count of outputs off the f64 oracle over the plain path's
# (module docstring; a plain count of 0 counts as 1).  On an H100 over
# the 4 draws the plain path reads 0 and the kernel 1306; a kernel that
# rounds its scores to bf16 before scaling them reads 18240, one that
# drops a key tile from PV 6929675.  The limit lies between.
ORACLE_COUNT_RATIO = 4000.0
# each of the backward's dQ, dK, dV: L2 distance from the exact gradient
# over the plain path's, at B 16, S 256 (module docstring).  On an H100
# over seeds 0-7 the kernel reads dQ 1.072-1.079, dK 0.866-0.873, dV
# 0.803-0.807; one reading the logsumexp rounded to bf16 2.454-3.380,
# one dropping a query tile from dV 47.7-48.4 on dV.  The limit lies
# between.
BWD_ORACLE_L2_RATIO = 2.0
HEAD_DIM = 128   # the kernels' head dim (csrc/flash_attention.cu)


def _attention_math(q, k, v, scale):
    """``_attention_xla``: (B, S, n, hd) → (B, S, nq, hd) and the f32
    row logsumexp (B, nq, S).  Uncounted."""
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    if nq != nkv:
        rep = nq // nkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float()) * scale
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, torch.full((), -1e30,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bnqk,bknh->bqnh", probs, v)
    return out, torch.logsumexp(scores, dim=-1)


def attention_plain(q, k, v, scale):
    """The plain attention, differentiable by autograd; counted in
    ``FWD_COUNTS.plain_calls``."""
    FWD_COUNTS.plain_calls += 1
    return _attention_math(q, k, v, scale)[0]


def attention_plain_lse(q, k, v, scale):
    """The forward kernel's plain version: (O, logsumexp); counted in
    ``FWD_COUNTS.plain_calls``."""
    FWD_COUNTS.plain_calls += 1
    return _attention_math(q, k, v, scale)


def flash_attention_bwd_plain(q, k, v, dout, scale):
    """The backward kernel's plain version: (dq, dk, dv) by autograd
    through the plain forward; counted in ``BWD_COUNTS.plain_calls``."""
    BWD_COUNTS.plain_calls += 1
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = _attention_math(qq, kk, vv, scale)[0]
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def attention_oracle(q, k, v, scale):
    """The reference's arithmetic in f64, uncounted: scores q·k in f64
    times ``f32(scale)``, the causal mask, softmax in f64, the normalised
    probabilities rounded to f32 and then to q's dtype, PV in f64.
    Returns f64 (B, S, nq, hd), not rounded to q's dtype."""
    B, S, nq, hd = q.shape
    rep = nq // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2).double()
    v = torch.repeat_interleave(v, rep, dim=2).double()
    scores = torch.einsum("bqnh,bknh->bnqk", q.double(), k) \
        * float(torch.tensor(scale, dtype=torch.float32))
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores, dim=-1).float().to(q.dtype).double()
    return torch.einsum("bnqk,bknh->bqnh", probs, v)


def attention_bwd_oracle(q, k, v, dout, scale):
    """The exact gradient of causal GQA attention, uncounted: autograd
    through f64 scores, softmax and PV, nothing rounded on the way.
    Returns f64 (dq, dk, dv)."""
    rep = q.shape[2] // k.shape[2]
    S = q.shape[1]
    with torch.enable_grad():
        q64, k64, v64 = (t.double().requires_grad_() for t in (q, k, v))
        s = torch.einsum("bqnh,bknh->bnqk", q64,
                         k64.repeat_interleave(rep, dim=2)) * scale
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
        o = torch.einsum("bnqk,bknh->bqnh", p,
                         v64.repeat_interleave(rep, dim=2))
        return torch.autograd.grad(o, (q64, k64, v64), dout.double())


def oracle_l2_ratio(got, plain, exact) -> float:
    """``||got - exact|| / ||plain - exact||`` in f64: how far ``got``
    strays from the exact value, in units of the plain path's
    distance."""
    e = exact.double()
    return float(torch.linalg.vector_norm(got.double() - e)
                 / torch.linalg.vector_norm(plain.double() - e))


def off_count(got, ref, frac: float = 0.25) -> int:
    """The number of O's elements off ``ref`` by more than ``frac`` of the
    forward's elementwise tolerance, ``|got - ref| > frac · (atol + rtol
    · |ref|)``, compared in f64."""
    atol, rtol = TOLERANCE["fwd"]
    g, r = got.double(), ref.double()
    return int(((g - r).abs() > frac * (atol + rtol * r.abs())).sum())


def block_rel_l2(got, ref, rows: int = BLOCK_ROWS) -> float:
    """The largest relative L2 error ``||got - ref|| / ||ref||`` over the
    blocks of ``rows`` sequence positions of one head of (B, S, n, hd)
    tensors.  Each block is held to its own scale, so the small entries
    of late query rows (O, dQ) and late keys (dK, dV) are checked as
    closely as the large early ones."""
    B, S, n, hd = ref.shape
    pad = (-S) % rows

    def sq_norms(t):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(B, -1, rows, n, hd).pow(2).sum((2, 4))

    num, den = sq_norms(got.float() - ref.float()), sq_norms(ref)
    return float((num / den.clamp_min(torch.finfo(torch.float32).tiny))
                 .sqrt().max())


def _check(q, k, v):
    B, S, nq, hd = q.shape
    if k.shape != (B, S, k.shape[2], hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match")
    if nq % k.shape[2]:
        raise ValueError(f"flash_attention: nkv={k.shape[2]} must divide "
                         f"nq={nq}")
    if hd != HEAD_DIM:
        raise ValueError(f"flash_attention: the kernels take hd "
                         f"{HEAD_DIM}, got {hd}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: the kernels take bf16, got "
                         f"{q.dtype}")


def flash_attention_fwd(q, k, v, scale):
    """The forward kernel on CUDA tensors: (O bf16 like q, logsumexp f32
    (B, nq, S))."""
    _check(q, k, v)
    check_cuda_operands("flash_attention_fwd", {"q": q, "k": k, "v": v}, {})
    B, S, nq, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, nq, S), dtype=torch.float32, device=q.device)
    launch("flash_attention_fwd",
           loader.load("flash_attention").flash_attn_fwd_launch,
           ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), B, S, nq, k.shape[2],
           hd, ctypes.c_float(scale), device=q.device)
    FWD_COUNTS.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, dout, scale):
    """The backward kernels on CUDA tensors: (dq, dk, dv)."""
    _check(q, k, v)
    dout = dout.contiguous()
    check_cuda_operands("flash_attention_bwd",
                        {"q": q, "k": k, "v": v, "o": o, "dout": dout}, {})
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous f32")
    B, S, nq, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dvec = torch.empty_like(lse)
    launch("flash_attention_bwd",
           loader.load("flash_attention").flash_attn_bwd_launch,
           ptr(q), ptr(k), ptr(v), ptr(o), ptr(dout), ptr(lse), ptr(dvec),
           ptr(dq), ptr(dk), ptr(dv), B, S, nq, k.shape[2], hd,
           ctypes.c_float(scale), device=q.device)
    BWD_COUNTS.launches += 1
    return dq, dk, dv


@torch.library.custom_op(
    "dtsb_torch::attention_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, float scale, bool kernel) "
           "-> (Tensor, Tensor)")
def _attention_fwd_op(q, k, v, scale, kernel):
    """(O, logsumexp): the forward kernel when ``kernel`` and the
    operands are on a card, else the plain version (counted)."""
    if kernel and q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, scale)
    return attention_plain_lse(q, k, v, scale)


def _attention_fwd_setup(ctx, inputs, output):
    q, k, v, scale, kernel = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.scale, ctx.kernel = scale, kernel


def _attention_fwd_backward(ctx, dout, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    if ctx.kernel and q.device.type == "cuda":
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, dout, ctx.scale)
    else:
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, dout, ctx.scale)
    return dq, dk, dv, None, None


torch.library.register_autograd(
    "dtsb_torch::attention_fwd", _attention_fwd_backward,
    setup_context=_attention_fwd_setup)
# the op a selective-checkpoint policy names to keep attention's output
# (``models.transformer.resolve_remat_policy``, ``"save_attn"``)
ATTENTION_OP = torch.ops.dtsb_torch.attention_fwd.default


def flash_attention(q, k, v, scale: float):
    """Causal GQA attention (B, S, nq, hd) × (B, S, nkv, hd)² → (B, S,
    nq, hd); CPU tensors take the plain version, CUDA tensors the
    kernels.  One dispatcher op (``ATTENTION_OP``, with its backward
    registered), so that a remat policy can save its output: the
    kernel's ``ctypes`` launch is invisible to the dispatcher."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return torch.ops.dtsb_torch.attention_fwd(q, k, v, float(scale),
                                              True)[0]


def attention_saved(q, k, v, scale: float):
    """The plain attention as the same dispatcher op (``ATTENTION_OP``,
    ``kernel=False``) on any device: the form ``"xla"`` attention takes
    under the ``save_attn`` remat policy, where its output must be one
    op's.  Values and grads are :func:`attention_plain`'s."""
    return torch.ops.dtsb_torch.attention_fwd(q, k, v, float(scale),
                                              False)[0]
