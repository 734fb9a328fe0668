"""The precision stack: the int8 tier (per-row absmax int8, kernels K4
and K5) and the fp8 tier (the Float8Linear recipe, kernel K6), each
with its plain PyTorch versions.

Port of the JAX package's ``ops/quant.py``: ``quantize_int8``,
``QuantizedWeight``, ``quantize_weight``, ``dequantize``,
``prequantized_dense``, ``int8_matmul`` (K4's plain version) with its
CUDA kernel ``csrc/int8_matmul.cu`` (``int8_matmul_kernel``, K4, the
twin of ``int8_matmul_pallas``), the fused quantise-matmul
(``int8_matmul_fused``, K5's plain version, and
``int8_matmul_fused_kernel``, the twin of ``int8_matmul_pallas_fused``),
``_int8_dot``, ``quantized_dense`` with the reference's custom VJP, the
fp8 recipe (``:533-687``, K6 in ``csrc/fp8_matmul.cu``),
``resolve_quantized_dense`` for every name the port runs,
``quantized_residual`` (the int8 round-trip with a straight-through
backward; ``dot_q8`` fuses it with the projection of any precision for
the ``save_dots_q8`` remat policy) and the quantized collectives
``quantized_all_gather``, ``quantized_all_reduce`` and
``quantized_reduce_scatter`` (``:370-531``, autograd Functions over
``ops/collectives.py`` with the reference's pinned backwards; no kernel
in either package).

Each quantised projection family is one dispatcher op with the
reference's custom VJP registered (``dtsb_torch::int8_dense`` for K4 and
K5, ``dtsb_torch::fp8_dense`` for K6 and the plain fp8 recipe), and a
projection of any precision fused with the ``save_dots_q8`` round-trip
is ``dtsb_torch::dot_q8``: a selective-checkpoint policy sees the same
ops on the CPU and on the card, where the kernels launch through
``ctypes`` inside them (``models.transformer`` ``_saved_ops`` keeps
what the reference's remat policies keep).

**Which form of a quantizer.**  The reference divides by a constant
(``amax / 127.0``, ``amax / fmax``), and XLA rewrites that division into
a multiplication by the f32 reciprocal whenever the quantizer runs under
``jax.jit``; the division ``x / scale`` stays a true division.  Eager
and jitted quantizers therefore disagree: on the CPU, eager and jitted
``quantize_int8`` gave different scales on 195 of 200 random 64×48 f32
tensors, and ``quantize_fp8`` on 232 of 400 (by one f32 ulp).  The
reference runs both forms: its train and serve steps are jitted
(activations, gradients, K/V rows, q rows and the v-scaled
probabilities), while ``quantize_decode_params`` runs eagerly
(``scripts/decode_bench.py``, ``generate_demo.py``).  So every
quantizer here takes the jitted form, ``amax * f32(1/127)``, unless the
caller passes ``eager=True`` (the decode weights).  ``x / scale`` is a
true IEEE division, rounded half to even and clipped to ±127.

Dispatch of the kernel wrappers (``int8_matmul_kernel``,
``int8_matmul_fused_kernel``, ``fp8_matmul_kernel``): a CPU tensor goes
to the plain version and is counted in the kernel's ``plain_calls``; a
CUDA tensor launches the kernel or raises.  Every int8 product of the
model path goes to a kernel on the card: the ``"int8"`` (the
reference's XLA) and ``"int8_pallas"`` forwards, both backward products
of the ``_bwd`` names and ``prequantized_dense`` to K4; the
``int8_pallas`` forward to K5.  None of them takes ``torch._int_mm`` or
the plain f64 product.  Inside :func:`plain_int8_products` (the
step-level parity on the card) they take the plain versions instead.

The plain int8 products are exact: int32 sums on the CPU, and on CUDA
(where torch has no integer matmul, and f32 is not exact above 2^24)
f64 sums, which equal ``float(int32 sum)`` bit for bit.  With the
epilogue ``(float(acc) · xs) · ws`` in that order and one rounding to
the output dtype, the kernels K4 and K5 are bit-equal to their plain
versions (``chip_smoke.py`` gates it).

Tolerance of K6 against its plain version (``TOLERANCE``): both
multiply the same fp8 operands, and each product of two fp8 values is
exact in f32, so they differ only in the order of the f32 sum, and then
in the one bf16 rounding of the output; the limits are stated below
and set between the sound kernel's reading and a mutant's
(``chip_smoke.py``, ``chip_gate_mutation.py``).  K6's gates are not
moved by the quantizer's form: both sides share the quantizer.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import LaunchCount, check_cuda_operands, launch, loader, ptr
from . import collectives as C

__all__ = ["quantize_int8", "QuantizedWeight", "quantize_weight",
           "dequantize", "f32_recip", "int_einsum_exact", "int8_matmul",
           "int8_matmul_kernel", "k4_design", "GEMV_MAX_M",
           "int8_matmul_fused", "int8_matmul_fused_kernel",
           "prequantized_dense", "quantized_dense", "plain_int8_products",
           "INT8_COUNTS", "INT8_FUSED_COUNTS",
           "FP8_FWD_DTYPE", "FP8_BWD_DTYPE", "fp8_max",
           "amax_history_update", "scale_from_history", "quantize_fp8",
           "quantize_fp8_kmajor",
           "fp8_matmul", "fp8_matmul_kernel", "fp8_dense",
           "resolve_quantized_dense", "COUNTS", "BWD_COUNTS", "TOLERANCE",
           "INT8_DENSE_OP", "FP8_DENSE_OP", "DOT_Q8_OP",
           "quantized_residual", "dot_q8", "quantized_all_gather",
           "quantized_all_reduce", "quantized_reduce_scatter"]


def f32_recip(v: float) -> float:
    """``f32(1) / f32(v)``: the constant XLA folds ``x / v`` into."""
    return float(np.float32(1.0) / np.float32(v))


# ------------------------------------------------------------------ int8

# K4: launches of the int8 GEMM and its plain calls (the wrapper's CPU
# branch, and every product inside plain_int8_products)
INT8_COUNTS = LaunchCount()
# K5: the fused quantise-matmul, likewise
INT8_FUSED_COUNTS = LaunchCount()
INV_127 = f32_recip(127.0)
_PLAIN = {"on": False}


@contextlib.contextmanager
def plain_int8_products():
    """Within this block every int8 product of ``quantized_dense`` and
    ``prequantized_dense`` (forward and backward) takes the plain
    version on any device, counted in the kernels' ``plain_calls``:
    the plain side of a step-level parity check on the card.  The
    kernel wrappers themselves are unchanged."""
    old = _PLAIN["on"]
    _PLAIN["on"] = True
    try:
        yield
    finally:
        _PLAIN["on"] = old


def quantize_int8(x: torch.Tensor, axis: int = -1, *, eager: bool = False):
    """Symmetric absmax int8 quantisation along ``axis`` (the
    contraction dim): ``(q int8, scale f32 with axis kept at 1)``.  The
    scale is ``amax · f32(1/127)`` (the jitted form), or
    ``amax / 127`` with ``eager=True``; an all-zero row gets scale 1.
    ``q`` is contiguous: ``quantize_int8(x.t(), axis=-1)`` is bit for bit
    ``quantize_int8(x, axis=0)``'s transpose, codes and scales, laid out
    with the contraction dim last."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    if eager:
        # a divisor on the tensor's device: CUDA turns a division by a
        # Python scalar into a multiplication by its reciprocal
        s = amax / torch.full((), 127.0, device=amax.device)
    else:
        s = amax * INV_127
    scale = torch.where(amax > 0, s, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    # contiguous codes whatever x's strides: quantising a transposed view
    # along its last axis writes the K-major codes K4's and K5's wgmma
    # GEMMs read in its last pass, which on an H100 costs less than the
    # int8 transposed copy a layout-keeping pass would need (PERF.md)
    return q.to(torch.int8, memory_format=torch.contiguous_format), scale


class QuantizedWeight(NamedTuple):
    """A weight stored as int8 with its f32 dequant scales: ``q`` keeps
    the contraction dim where the bf16 weight had it, ``s`` keeps it at
    size 1.  Any ``resolve_quantized_dense`` matmul takes it in the
    weight slot and routes it through ``prequantized_dense``."""
    q: torch.Tensor
    s: torch.Tensor


def quantize_weight(w: torch.Tensor, *, contract_axis: int = -2,
                    eager: bool = False) -> QuantizedWeight:
    """(…, K, N) → QuantizedWeight: per-output-column absmax over the
    contraction dim (stacked (L, K, N) leaves quantise per layer)."""
    q, s = quantize_int8(w, axis=contract_axis, eager=eager)
    return QuantizedWeight(q=q.contiguous(), s=s.contiguous())


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int_einsum_exact(eq: str, a: torch.Tensor, b: torch.Tensor):
    """``einsum`` of two integer-valued tensors as f32 ``float(int32
    sum)``, exactly: int32 on the CPU; f64 on CUDA (torch has no integer
    matmul there, and f32 is not exact above 2^24), whose integer sums
    are exact below 2^53 in any order."""
    if a.device.type == "cpu":
        return torch.einsum(eq, a.to(torch.int32), b.to(torch.int32)).float()
    return torch.einsum(eq, a.double(), b.double()).float()


def int8_matmul(xq, xs, wq, ws, out_dtype=torch.bfloat16):
    """K4's plain version: (M, K) int8 · (K, N) int8, exact integer
    sum, then ``(f32(acc) · xs) · ws`` rounded to ``out_dtype``.  xs
    (M, 1) f32, ws (1, N) f32."""
    return (int_einsum_exact("mk,kn->mn", xq, wq) * xs * ws).to(out_dtype)


def int8_matmul_fused(x, wq, ws, out_dtype=torch.bfloat16):
    """K5's plain version: quantise each row of ``x`` (M, K) over its
    full K (the jitted form), then K4's product and epilogue."""
    xq, xs = quantize_int8(x, axis=-1)
    return int8_matmul(xq, xs, wq, ws, out_dtype)


# K4's split-K GEMV takes products of at most this many rows (decode)
GEMV_MAX_M = 16


def k4_design(M: int, N: int, K: int, b_kmajor: bool) -> str:
    """Which of K4's designs (``csrc/int8_matmul.cu``) takes an (M, K) x
    B product: ``"wgmma"`` (B K-major, (N, K): the training path's dX
    and dW), ``"gemv"`` (B (K, N), M <= ``GEMV_MAX_M``: decode and the
    unembedding) or ``"mma"`` (B (K, N), larger M: the int8 prefill).
    Raises on a shape none of them takes."""
    if M < 1 or N < 1:
        raise ValueError(f"int8_matmul_kernel: empty product ({M}, {N})")
    _check_int8_shape("int8_matmul_kernel", N, K, b_kmajor)
    if b_kmajor:
        return "wgmma"
    return "gemv" if M <= GEMV_MAX_M else "mma"


def _check_int8_shape(name, N, K, b_kmajor):
    if K % 16:
        raise ValueError(f"{name}: the contraction K={K} must be a multiple "
                         f"of 16 (16-byte row loads)")
    if not b_kmajor and N % 16:
        raise ValueError(f"{name}: N={N} must be a multiple of 16 for a "
                         f"(K, N) weight (16-byte row loads)")


def _check_int8_gemm(name, M, N, K, b, b_kmajor):
    _check_int8_shape(name, N, K, b_kmajor)
    if b.dtype != torch.int8:
        raise ValueError(f"{name}: the weight must be int8, got {b.dtype}")
    want = (N, K) if b_kmajor else (K, N)
    if tuple(b.shape) != want:
        raise ValueError(f"{name}: weight shape {tuple(b.shape)} != {want}")


# the GEMV's zeroed int32 scratch, one a device, grown as shapes need
# (every launch leaves it zero again, so the port's launches, all on one
# stream, share it; two launches in flight at once on two streams would
# not)
_GEMV_SCRATCH: dict = {}


def _gemv_scratch(lib, M, N, K, device):
    n = max(1, lib.int8_gemv_scratch_ints(M, N, K))
    buf = _GEMV_SCRATCH.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _GEMV_SCRATCH[device] = buf
    return buf


def _launch_k4(a, xs, b, ws, b_kmajor: bool):
    """K4 on the card: a (M, Kc) int8; b (N, Kc) int8 if ``b_kmajor``
    else (Kc, N); xs (M,) and ws (N,) f32.  Launches the design
    :func:`k4_design` picks; returns (M, N) bf16."""
    M, Kc = a.shape
    N = b.shape[0] if b_kmajor else b.shape[1]
    design = k4_design(M, N, Kc, b_kmajor)
    _check_int8_gemm("int8_matmul_kernel", M, N, Kc, b, b_kmajor)
    if a.dtype != torch.int8:
        raise ValueError("int8_matmul_kernel takes an int8 activation")
    xs = xs.reshape(M).float().contiguous()
    ws = ws.reshape(N).float().contiguous()
    check_cuda_operands("int8_matmul_kernel", {"xs": xs, "ws": ws}, {},
                        {"a": a, "b": b})
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("int8_matmul_kernel: a and b must be 16-byte "
                         "aligned")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    lib = loader.load("int8_matmul")
    if design == "gemv":
        scratch = _gemv_scratch(lib, M, N, Kc, a.device)
        launch("int8_matmul_kernel", lib.int8_gemv_launch, ptr(a), ptr(b),
               ptr(xs), ptr(ws), ptr(out), ptr(scratch), M, N, Kc,
               device=a.device)
    else:
        launch("int8_matmul_kernel", lib.int8_matmul_launch, ptr(a), ptr(b),
               ptr(xs), ptr(ws), ptr(out), M, N, Kc, int(b_kmajor),
               device=a.device)
    INT8_COUNTS.launches += 1
    return out


def int8_matmul_kernel(xq, xs, wq, ws, out_dtype=torch.bfloat16):
    """K4: xq (M, K) int8, xs (M, 1) f32, wq (K, N) int8 in the
    reference's layout, ws (1, N) f32; returns (M, N) ``out_dtype``
    (bf16 on the card), bit-equal to ``int8_matmul``.  The kernel reads
    wq in place (no transposed copy): the split-K GEMV at M <= 16, the
    mma.sync GEMM above."""
    if xq.device.type == "cpu":
        INT8_COUNTS.plain_calls += 1
        return int8_matmul(xq, xs, wq, ws, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError("int8_matmul_kernel writes bf16 only")
    if xq.shape[1] != wq.shape[0]:
        raise ValueError(f"int8_matmul_kernel: inner dims {xq.shape[1]} != "
                         f"{wq.shape[0]}")
    return _launch_k4(xq.contiguous(), xs, wq.contiguous(), ws,
                      b_kmajor=False)


def int8_matmul_fused_kernel(x, wq, ws, out_dtype=torch.bfloat16, *,
                             b_kmajor: bool = False):
    """K5: x (M, K) bf16 activation; wq the int8 weight codes, (K, N) in
    the reference's layout or, with ``b_kmajor``, (N, K), the layout
    the training path passes (``_QuantizedDense``); ws its N f32
    scales.  Each row of x is quantised over its full K by the kernel's
    prologue (codes written once to an (M, K) scratch), then the wgmma
    GEMM.  A (K, N) weight is transposed here first (a copy of K·N
    bytes).  Returns (M, N) ``out_dtype`` (bf16 on the card), bit-equal
    to ``int8_matmul_fused``."""
    M, K = x.shape
    N, Kw = wq.shape if b_kmajor else wq.shape[::-1]
    if Kw != K:
        raise ValueError(f"int8_matmul_fused_kernel: inner dims {K} != "
                         f"{Kw}")
    if x.device.type == "cpu":
        INT8_FUSED_COUNTS.plain_calls += 1
        return int8_matmul_fused(x, wq.t() if b_kmajor else wq,
                                 ws.reshape(1, N), out_dtype)
    if out_dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise ValueError("int8_matmul_fused_kernel takes and writes bf16 "
                         "only")
    b = wq.contiguous() if b_kmajor else wq.t().contiguous()
    _check_int8_gemm("int8_matmul_fused_kernel", M, N, K, b, True)
    ws = ws.reshape(N).float().contiguous()
    check_cuda_operands("int8_matmul_fused_kernel", {"ws": ws}, {},
                        {"x": x, "wq": b})
    if x.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("int8_matmul_fused_kernel: x and wq must be "
                         "16-byte aligned")
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    launch("int8_matmul_fused_kernel",
           loader.load("int8_matmul").int8_matmul_fused_launch,
           ptr(x), ptr(b), ptr(codes), ptr(xs), ptr(ws), ptr(out), M, N, K,
           device=x.device)
    INT8_FUSED_COUNTS.launches += 1
    return out


def _int8_dot(aq, a_scale, bq, b_scale, dims, out_dtype, plain: bool):
    """Two-operand int8 ``dot_general`` with int32 accumulation and the
    epilogue ``(f32(acc) · a_scale) · b_scale``: ``dims = (ca, cb)``,
    the contraction axis of the 2-D ``aq`` and of ``bq``; the scales
    broadcast against the (m, n) result.  ``plain`` takes the plain
    product on any device; otherwise K4 (the plain version on the CPU).
    K4 takes A row-major over the contraction, so ``ca == 0`` costs a
    transposed copy of ``aq``; B it reads either way, on its wgmma GEMM
    when ``cb == 1`` (K-major).  A contraction that is not a multiple of
    16 (dW over a ragged batch × sequence) is zero-padded for the
    kernel: zero codes add exactly nothing."""
    ca, cb = dims
    a = aq if ca == 1 else aq.t()
    if plain or aq.device.type == "cpu":
        INT8_COUNTS.plain_calls += 1
        b = bq.t() if cb == 1 else bq
        return (int_einsum_exact("mk,kn->mn", a, b) * a_scale
                * b_scale).to(out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError("int8_matmul_kernel writes bf16 only")
    pad = -a.shape[1] % 16
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        bq = torch.nn.functional.pad(bq, (0, pad) if cb == 1
                                     else (0, 0, 0, pad))
    return _launch_k4(a.contiguous(), a_scale, bq.contiguous(), b_scale,
                      b_kmajor=(cb == 1))


def prequantized_dense(a: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """(…, K) · QuantizedWeight (K, N) → (…, N): per-row activation
    quantisation (the jitted form), then K4 on the stored int8 weight
    (``int8_matmul_kernel``), or its plain version inside
    :func:`plain_int8_products`."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    xq, xs = quantize_int8(a2, axis=-1)
    ws = w.s.reshape(1, -1)
    if _PLAIN["on"]:
        INT8_COUNTS.plain_calls += 1
        out = int8_matmul(xq, xs, w.q, ws, a.dtype)
    else:
        out = int8_matmul_kernel(xq, xs, w.q, ws, a.dtype)
    return out.reshape(*lead, w.q.shape[-1])


INT8_IMPLS = ("xla", "pallas", "pallas_fused", "plain")


def _int8_forward(x, w, impl):
    """``quantized_dense``'s forward product: K5 (``"pallas_fused"``) or
    K4 (``"xla"``, ``"pallas"``) launched through ``ctypes`` on the card,
    their plain versions on the CPU and under ``"plain"``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if impl == "pallas_fused":
        # (N, K) codes: bit for bit quantize_int8(w, axis=0)'s transpose
        wq, ws = quantize_int8(w.t(), axis=-1)
        out = int8_matmul_fused_kernel(x2.contiguous(), wq.contiguous(),
                                       ws, x.dtype, b_kmajor=True)
    else:
        wq, ws = quantize_int8(w, axis=0)
        xq, xs = quantize_int8(x2, axis=-1)
        if impl == "plain":
            INT8_COUNTS.plain_calls += 1
            out = int8_matmul(xq, xs, wq, ws, x.dtype)
        else:   # "xla" and "pallas" are both K4 on the card
            out = int8_matmul_kernel(xq, xs, wq, ws, x.dtype)
    return out.reshape(*lead, w.shape[1])


def _int8_backward(x, w, g, impl, quantize_bwd):
    """The reference's custom VJP of ``quantized_dense``: ``(dx, dw)``."""
    if not quantize_bwd:   # straight-through bf16 backward
        return (torch.einsum("...n,kn->...k", g, w),
                torch.einsum("...k,...n->kn", x, g))
    plain = impl == "plain"
    lead = x.shape[:-1]
    K, N = w.shape
    g2 = g.reshape(-1, N)
    x2 = x.reshape(-1, K)
    # dX = g · Wᵀ, contraction over N: g rows, w along its N axis
    gq, gs = quantize_int8(g2, axis=-1)                 # (M,N), (M,1)
    wq_n, ws_n = quantize_int8(w, axis=1)               # (K,N), (K,1)
    gx = _int8_dot(gq, gs, wq_n, ws_n.T, (1, 1), x.dtype, plain)
    # dW = Xᵀ · g, contraction over M: both quantised along M, the
    # quantiser writing the codes K-major ((K, M) and (N, M), bit for
    # bit the transposes of quantize_int8(·, axis=0)) as K4's wgmma
    # GEMM reads them, with no separate transposed copy
    xq_t, xs_t = quantize_int8(x2.t(), axis=-1)         # (K,M), (K,1)
    gq_t, gs_t = quantize_int8(g2.t(), axis=-1)         # (N,M), (N,1)
    gw = _int8_dot(xq_t, xs_t, gq_t, gs_t.T, (1, 1), w.dtype, plain)
    return gx.reshape(*lead, K), gw


@torch.library.custom_op(
    "dtsb_torch::int8_dense", mutates_args=(),
    schema="(Tensor x, Tensor w, str impl, bool quantize_bwd) -> Tensor")
def _int8_dense_op(x, w, impl, quantize_bwd):
    """The int8 projection (``quantized_dense``'s forward,
    :func:`_int8_forward`) as one dispatcher op, so that a remat policy
    sees it whatever runs inside.  Its output is what ``save_dots``
    keeps at ``int8`` and ``int8_bwd``: the reference keeps its XLA
    dot's int32 accumulator there, which K4 never writes (its epilogue
    is fused), so the port keeps K4's output in the activation dtype,
    the same element count (``models.transformer._saved_ops``)."""
    return _int8_forward(x, w, impl)


def _int8_dense_setup(ctx, inputs, output):
    x, w, impl, quantize_bwd = inputs
    ctx.save_for_backward(x, w)
    ctx.impl, ctx.quantize_bwd = impl, quantize_bwd


def _int8_dense_backward(ctx, g):
    x, w = ctx.saved_tensors
    return (*_int8_backward(x, w, g, ctx.impl, ctx.quantize_bwd), None,
            None)


torch.library.register_autograd("dtsb_torch::int8_dense",
                                _int8_dense_backward,
                                setup_context=_int8_dense_setup)
INT8_DENSE_OP = torch.ops.dtsb_torch.int8_dense.default


def quantized_dense(x, w, impl: str = "xla", quantize_bwd: bool = False):
    """Linear layer with an int8 forward (``x`` (…, K), ``w`` (K, N)).
    ``impl``: ``"xla"`` or ``"pallas"`` (K4 on the pre-quantised
    operands), ``"pallas_fused"`` (K5), or ``"plain"`` (the plain
    products on any device, also inside :func:`plain_int8_products`).
    ``quantize_bwd=False``: straight-through bf16 backward; True: dX
    and dW as int8 products (K4) with fresh absmax scales."""
    if impl not in INT8_IMPLS:
        raise ValueError(f"quantized_dense: unknown impl {impl!r}")
    if _PLAIN["on"]:
        impl = "plain"
    return torch.ops.dtsb_torch.int8_dense(x, w, impl, quantize_bwd)


# ------------------------------------------------------------------- fp8

FP8_FWD_DTYPE = torch.float8_e4m3fn   # forward operands  (max 448)
FP8_BWD_DTYPE = torch.float8_e5m2     # grad_output       (max 57344)

# K6: launches of the kernel, and plain forward products (the wrapper's
# CPU branch and fp8_dense's impl="plain")
COUNTS = LaunchCount()
# the backward's plain products (two per fp8_dense backward)
BWD_COUNTS = LaunchCount()
# (atol, rtol) of K6 against the plain version on bf16 output: rtol
# covers one bf16 ulp (at most 2^-7 relative), where the two f32 sums
# land on either side of a rounding boundary; atol covers outputs that
# cancel to near zero, where the sums' f32 rounding shows.
TOLERANCE = {torch.bfloat16: (1e-5, 1e-2)}

def fp8_max(dtype) -> float:
    """Largest finite value of an fp8 dtype (448 for e4m3fn, 57344 for
    e5m2)."""
    return float(torch.finfo(dtype).max)


def amax_history_update(history: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Shift the tensor's current absmax into the rolling (H,) f32
    history (the oldest entry drops off)."""
    amax = x.float().abs().max()
    return torch.cat([history[1:], amax[None]])


def scale_from_history(history: torch.Tensor, dtype) -> torch.Tensor:
    """Delayed scaling's scale: the absmax over the whole history,
    times ``f32(1/fmax)`` (the jitted form)."""
    amax = history.max()
    return torch.where(amax > 0, amax * f32_recip(fp8_max(dtype)),
                       torch.ones_like(amax))


def quantize_fp8(x: torch.Tensor, dtype=FP8_FWD_DTYPE, *,
                 amax_history_len: int = 0):
    """Per-tensor absmax scaling to fp8: ``(q, scale f32 scalar)`` with
    ``dequant = q * scale``; the scale is ``amax · f32(1/fmax)``, the
    form the reference's jitted train step computes.
    ``amax_history_len > 0`` routes the scale through the delayed-scaling
    helpers, with the history seeded by the current tensor (numerically
    the dynamic scale), as the reference's stateless instantiation
    does."""
    scale = _fp8_scale(x, dtype, amax_history_len)
    fmax = fp8_max(dtype)
    q = torch.clamp(x.float() / scale, -fmax, fmax).to(dtype)
    return q, scale


def _fp8_scale(x, dtype, amax_history_len):
    if amax_history_len:
        hist = amax_history_update(
            torch.zeros((amax_history_len,), dtype=torch.float32,
                        device=x.device), x)
        return scale_from_history(hist, dtype)
    amax = x.float().abs().max()
    return torch.where(amax > 0, amax * f32_recip(fp8_max(dtype)),
                       torch.ones_like(amax))


def quantize_fp8_kmajor(w: torch.Tensor, dtype=FP8_FWD_DTYPE, *,
                        amax_history_len: int = 0):
    """:func:`quantize_fp8` of a (K, N) weight with its codes written
    K-major, ``(N, K)`` contiguous, in the pass that rounds them: bit
    for bit ``quantize_fp8(w)[0].t()`` and the same scale.  K6 takes B
    in this layout only (its TMA loads and wgmma read both operands
    K-major),
    so the training path makes no transposed copy per launch."""
    scale = _fp8_scale(w, dtype, amax_history_len)
    fmax = fp8_max(dtype)
    q = torch.empty((w.shape[1], w.shape[0]), dtype=dtype, device=w.device)
    q.copy_(torch.clamp(w.float() / scale, -fmax, fmax).t())
    return q, scale


def fp8_matmul(aq, a_scale, bq, b_scale, out_dtype):
    """K6's plain version: (M, K)·(K, N) over fp8 operands upcast to
    f32, f32 accumulation, then ``(acc · a_scale) · b_scale`` rounded to
    ``out_dtype`` — the reference's order.  Also the product of the
    backward, which passes transposed views."""
    acc = aq.float() @ bq.float()
    return (acc * a_scale * b_scale).to(out_dtype)


def fp8_matmul_kernel(aq, a_scale, bt, b_scale, out_dtype=torch.bfloat16):
    """K6: aq (M, K) e4m3; bt (N, K) e4m3, the weight's codes K-major
    (:func:`quantize_fp8_kmajor`, the reference's (K, N) codes
    transposed), as Hopper's MMAs take B; scales f32 scalars; returns
    (M, N) ``out_dtype`` (bf16 on the card).  The kernel's prologue
    writes both operands' codes as bf16 into scratch allocated here
    ((M, K) and (N, K)): the bf16 tensor cores sum in f32, the fp8 ones
    do not (csrc/fp8_matmul.cu).  The operands' shapes and dtype are
    checked on every device, so that a CPU run meets what the card would
    refuse."""
    M, K = aq.shape
    N, K2 = bt.shape
    if K != K2:
        raise ValueError(f"fp8_matmul_kernel: inner dims {K} != {K2} (B "
                         f"is (N, K), K-major)")
    if K % 16:
        raise ValueError(f"fp8_matmul_kernel: K={K} must be a multiple "
                         f"of 16 (16-byte TMA row strides)")
    if aq.dtype != FP8_FWD_DTYPE or bt.dtype != FP8_FWD_DTYPE:
        raise ValueError("fp8_matmul_kernel takes e4m3 operands")
    if aq.device.type == "cpu":
        COUNTS.plain_calls += 1
        return fp8_matmul(aq, a_scale, bt.t(), b_scale, out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError("fp8_matmul_kernel writes bf16 only")
    a_s = a_scale.reshape(1).float().contiguous()
    b_s = b_scale.reshape(1).float().contiguous()
    check_cuda_operands("fp8_matmul_kernel", {"aq": aq, "bt": bt}, {})
    if a_s.device != aq.device or b_s.device != aq.device:
        raise ValueError("fp8_matmul_kernel: scales must be on the "
                         "operands' device")
    if aq.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("fp8_matmul_kernel: operands must be 16-byte "
                         "aligned (TMA)")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=aq.device)
    # the codes as bf16, written by the kernel's prologue
    a16 = torch.empty((M, K), dtype=torch.bfloat16, device=aq.device)
    b16 = torch.empty((N, K), dtype=torch.bfloat16, device=aq.device)
    launch("fp8_matmul_kernel", loader.load("fp8_matmul").fp8_matmul_launch,
           ptr(aq), ptr(bt), ptr(a_s), ptr(b_s), ptr(a16), ptr(b16),
           ptr(out), M, N, K, device=aq.device)
    COUNTS.launches += 1
    return out


def _fp8_forward(x, w, impl, hist):
    """``fp8_dense``'s forward product.  ``"kernel"``: K6 (its plain
    version on the CPU), whose epilogue writes the activation dtype.
    ``"plain"``: the recipe's f32 product, its two scalar scales
    applied, before the rounding to the activation dtype."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, xs = quantize_fp8(x2, FP8_FWD_DTYPE, amax_history_len=hist)
    if impl == "kernel":
        # the codes K-major, as K6 reads them
        wt, ws = quantize_fp8_kmajor(w, FP8_FWD_DTYPE, amax_history_len=hist)
        out = fp8_matmul_kernel(xq, xs, wt, ws, x.dtype)
    else:
        wq, ws = quantize_fp8(w, FP8_FWD_DTYPE, amax_history_len=hist)
        COUNTS.plain_calls += 1
        out = fp8_matmul(xq, xs, wq, ws, torch.float32)
    return out.reshape(*lead, w.shape[1])


def _fp8_backward(x, w, g, hist):
    """The reference's custom VJP of ``fp8_dense`` (plain products):
    ``(dx, dw)``."""
    lead = x.shape[:-1]
    K, N = w.shape
    g2 = g.reshape(-1, N)
    x2 = x.reshape(-1, K)
    gq, gs = quantize_fp8(g2, FP8_BWD_DTYPE, amax_history_len=hist)
    # dX = g · Wᵀ: e5m2 grad × e4m3 weight
    wq, ws = quantize_fp8(w, FP8_FWD_DTYPE, amax_history_len=hist)
    gx = fp8_matmul(gq, gs, wq.t(), ws, x.dtype)
    # dW = Xᵀ · g: e4m3 activation × e5m2 grad
    xq, xs = quantize_fp8(x2, FP8_FWD_DTYPE, amax_history_len=hist)
    gw = fp8_matmul(xq.t(), xs, gq, gs, w.dtype)
    BWD_COUNTS.plain_calls += 2
    return gx.reshape(*lead, K), gw


@torch.library.custom_op(
    "dtsb_torch::fp8_dense", mutates_args=(),
    schema="(Tensor x, Tensor w, str impl, int hist) -> Tensor")
def _fp8_dense_op(x, w, impl, hist):
    """The fp8 projection (:func:`_fp8_forward`) as one dispatcher op.
    At ``"plain"`` its output is the f32 ``(B·S, N)`` product the
    reference's ``save_dots`` keeps of its XLA fp8 dot at ``fp8`` and
    ``fp8_delayed`` (``models.transformer._saved_ops``)."""
    return _fp8_forward(x, w, impl, hist)


def _fp8_dense_setup(ctx, inputs, output):
    x, w, impl, hist = inputs
    ctx.save_for_backward(x, w)
    ctx.hist = hist


def _fp8_dense_backward(ctx, g):
    x, w = ctx.saved_tensors
    return (*_fp8_backward(x, w, g, ctx.hist), None, None)


torch.library.register_autograd("dtsb_torch::fp8_dense",
                                _fp8_dense_backward,
                                setup_context=_fp8_dense_setup)
FP8_DENSE_OP = torch.ops.dtsb_torch.fp8_dense.default


def fp8_dense(x, w, impl: str = "plain", amax_history_len: int = 0):
    """``x @ w`` under the Float8Linear recipe.  ``impl``: ``"kernel"``
    (forward through K6) or ``"plain"``; the backward is plain either
    way.  One dispatcher op (``FP8_DENSE_OP``) and the rounding of the
    plain product to ``x``'s dtype."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"fp8_dense: unknown impl {impl!r}")
    out = torch.ops.dtsb_torch.fp8_dense(x, w, impl, int(amax_history_len))
    return out.to(x.dtype)


def _projection(precision: str, fp8_history_len: int = 0):
    """``matmul_precision`` → ``(kind, impl, quantize_bwd, hist)``, the
    arguments of its projection: ``"mm"`` a plain matmul, ``"fp8"``
    :func:`_fp8_forward`, ``"int8"`` :func:`_int8_forward`."""
    if precision == "bf16":
        return "mm", "", False, 0
    if precision in ("fp8", "fp8_delayed", "fp8_pallas"):
        impl = "kernel" if precision == "fp8_pallas" else "plain"
        hist = (fp8_history_len or 16) if precision == "fp8_delayed" else 0
        return "fp8", impl, False, hist
    if precision in ("int8", "int8_pallas", "int8_bwd", "int8_pallas_bwd"):
        base = precision.removesuffix("_bwd")
        impl = {"int8": "xla", "int8_pallas": "pallas_fused"}[base]
        return "int8", impl, precision.endswith("_bwd"), 0
    raise ValueError(f"unknown matmul_precision {precision!r}")


def resolve_quantized_dense(precision: str, *, fp8_history_len: int = 0):
    """``matmul_precision`` → ``(a, w) -> out``: ``"bf16"`` a plain
    matmul; ``"fp8"`` and ``"fp8_delayed"`` the fp8 recipe with the
    plain forward, ``"fp8_pallas"`` with K6 forward; ``"int8"`` and
    ``"int8_pallas"`` the int8 forward through K4 and K5, with a
    straight-through backward, or with int8 dX and dW (K4) under the
    ``_bwd`` suffix.  Every returned matmul also takes a
    ``QuantizedWeight`` and routes it through ``prequantized_dense``."""
    kind, impl, quantize_bwd, hist = _projection(precision, fp8_history_len)
    if kind == "mm":
        base_fn = torch.matmul
    elif kind == "fp8":
        def base_fn(a, w):
            return fp8_dense(a, w, impl, hist)
    else:
        def base_fn(a, w):
            return quantized_dense(a, w, impl, quantize_bwd)

    def dense(a, w):
        if isinstance(w, QuantizedWeight):
            return prequantized_dense(a, w)
        return base_fn(a, w)

    return dense


# ------------------------------------------------------- quantized residual

class _QuantizedResidual(torch.autograd.Function):
    """``quantized_residual``: the int8 round-trip forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, y):
        q, s = quantize_int8(y, axis=-1)
        return dequantize(q, s, y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def quantized_residual(y: torch.Tensor) -> torch.Tensor:
    """``y`` through an int8 round-trip along its last axis (per-row
    absmax codes and f32 scales, dequantised to ``y``'s dtype), with a
    straight-through (identity) backward: ``round``'s derivative is zero
    almost everywhere, so the true one would null every gradient.  The
    reference's ``checkpoint_name(·, "dot_q8")`` marks the codes and
    scales for its ``save_dots_q8`` remat policy; here a projection and
    its round-trip are one op (:func:`dot_q8`) whose codes and scales
    the policy keeps."""
    return _QuantizedResidual.apply(y)


@torch.library.custom_op(
    "dtsb_torch::dot_q8", mutates_args=(),
    schema="(Tensor a, Tensor w, str kind, str impl, bool quantize_bwd, "
           "int hist) -> (Tensor, Tensor)")
def _dot_q8_op(a, w, kind, impl, quantize_bwd, hist):
    """``quantize_int8(projection(a, w), axis=-1)``: the precision's
    projection (:func:`_projection`'s arguments; its kernel on the card)
    and the round-trip's codes and scales as one dispatcher op, so that
    a selective-checkpoint policy keeps the pair and skips the product
    in the recompute."""
    if kind == "mm":
        y = torch.matmul(a, w)
    elif kind == "fp8":
        y = _fp8_forward(a, w, impl, hist).to(a.dtype)
    else:
        y = _int8_forward(a, w, impl)
    return quantize_int8(y, axis=-1)


DOT_Q8_OP = torch.ops.dtsb_torch.dot_q8.default


class _DotQ8(torch.autograd.Function):
    """``quantized_residual(projection(a, w))``: the forward through
    :func:`_dot_q8_op`, the backward straight through the round-trip
    and then the projection's own VJP."""

    @staticmethod
    def forward(ctx, a, w, kind, impl, quantize_bwd, hist):
        ctx.save_for_backward(a, w)
        ctx.args = kind, impl, quantize_bwd, hist
        q, s = torch.ops.dtsb_torch.dot_q8(a, w, kind, impl, quantize_bwd,
                                           hist)
        return dequantize(q, s, a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        kind, impl, quantize_bwd, hist = ctx.args
        if kind == "fp8":
            ga, gw = _fp8_backward(a, w, g, hist)
        elif kind == "int8":
            ga, gw = _int8_backward(a, w, g, impl, quantize_bwd)
        else:
            ga = torch.einsum("...n,kn->...k", g, w)
            gw = torch.einsum("...k,...n->kn", a, g)
        return ga, gw, None, None, None, None


def dot_q8(a: torch.Tensor, w: torch.Tensor, precision: str = "bf16", *,
           fp8_history_len: int = 0) -> torch.Tensor:
    """``quantized_residual(dense(a, w))`` at ``precision``, the
    projection of the ``save_dots_q8`` remat policy
    (``models.transformer``): forward values bit for bit the
    round-trip's of that precision's projection, grads its VJP's; the
    policy keeps the op's int8 codes and f32 scales, so the recompute
    neither keeps the projection's output nor runs its product again."""
    kind, impl, quantize_bwd, hist = _projection(precision, fp8_history_len)
    if kind == "int8" and _PLAIN["on"]:
        impl = "plain"
    return _DotQ8.apply(a, w, kind, impl, quantize_bwd, hist)


# ---------------------------------------------------- quantized collectives
#
# The reference's EQuARX-style collectives (``ops/quant.py:370-531``):
# int8 codes and f32 per-row scales on the wire, dequantised after it.
# Each is an autograd Function with the reference's pinned backward.
# The quantiser is the jitted form (the reference runs them inside its
# jitted step).  Sums over ranks add the dequantised contributions in
# rank order, one f32 addition a rank.

def _sum_in_rank_order(t: torch.Tensor) -> torch.Tensor:
    """``t[0] + t[1] + …`` along the leading (source-rank) axis."""
    out = t[0]
    for r in range(1, t.shape[0]):
        out = out + t[r]
    return out


def _qag_value(x, axis_name, dim):
    if x.ndim == 1:
        # 1-D leaf: one scalar scale a shard, applied segment by segment
        ws, n = C.axis_size(axis_name), x.shape[0]
        q, s = quantize_int8(x.reshape(1, n), axis=-1)
        qg = C.all_gather(q.reshape(n), axis_name, axis=0)
        sg = C.all_gather(s.reshape(1), axis_name, axis=0)
        return (qg.reshape(ws, n).float() * sg[:, None]).reshape(-1) \
            .to(x.dtype)
    # quantise along a dim that is not the gather dim, so that each
    # shard's scales travel with its codes
    qaxis = -1 if dim not in (x.ndim - 1, -1) else 0
    q, s = quantize_int8(x, axis=qaxis)
    qg = C.all_gather(q, axis_name, axis=dim)
    sg = C.all_gather(s, axis_name, axis=dim)
    return dequantize(qg, sg, x.dtype)


class _QuantizedAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, dim, q8_bwd):
        ctx.axis_name, ctx.dim, ctx.q8_bwd = axis_name, dim, q8_bwd
        return _qag_value(x, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        # the gathered output has x's dtype, so g's is x's
        if ctx.q8_bwd:
            gx = quantized_reduce_scatter(
                g.float(), ctx.axis_name, axis=0 if g.ndim == 1 else ctx.dim)
        else:
            gx = C.reduce_scatter(g.float(), ctx.axis_name, axis=ctx.dim)
        return gx.to(g.dtype), None, None, None


def quantized_all_gather(x: torch.Tensor, axis_name="dp", axis: int = 0,
                         q8_bwd: bool = False) -> torch.Tensor:
    """All-gather a shard as int8 codes and f32 scales and dequantise
    after the wire (the torchao fp8 all-gather twin): a 1-D ``x`` as one
    scalar scale a shard, otherwise per row along the last dim (along
    dim 0 when ``axis`` is the last).  The backward is a full-precision
    f32 reduce_scatter cast back to ``x``'s dtype, or with ``q8_bwd``
    :func:`quantized_reduce_scatter`.  At one rank it is still the
    round-trip."""
    return _QuantizedAllGather.apply(x, axis_name, axis, q8_bwd)


def _qar_value(x, axis_name):
    # rows are the last axis; a 0-D or 1-D x is one row with one scale
    q, s = quantize_int8(x.reshape(1, -1) if x.ndim < 2 else x, axis=-1)
    # two-shot: every rank's codes and scales on a new leading rank axis,
    # dequantised and summed in rank order, the same on every rank
    qg = C.all_gather(q, axis_name, axis=0, tiled=False)
    sg = C.all_gather(s, axis_name, axis=0, tiled=False)
    return _sum_in_rank_order(qg.float() * sg).reshape(x.shape).to(x.dtype)


class _QuantizedAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _qar_value(x, axis_name)

    @staticmethod
    def backward(ctx, g):   # psum's own transpose: a full-precision psum
        return C.all_reduce(g, ctx.axis_name), None


def quantized_all_reduce(x: torch.Tensor, axis_name="dp") -> torch.Tensor:
    """EQuARX-style two-shot all-reduce: each rank's int8 codes and
    per-row scales gathered (untiled), dequantised and summed in rank
    order.  Within ``n_ranks · max_scale / 2`` of the full-precision sum,
    element by element.  The backward is a full-precision all_reduce."""
    return _QuantizedAllReduce.apply(x, axis_name)


def _qrs_value(x, axis_name, axis):
    n = C.axis_size(axis_name)
    if x.ndim == 1:
        # 1-D: one scalar scale a rank, the codes scattered by chunk
        if x.shape[0] % n:
            raise ValueError(f"quantized_reduce_scatter: dim of size "
                             f"{x.shape[0]} not divisible by axis "
                             f"{C.resolve_axis(axis_name).name!r} size {n}")
        q, s = quantize_int8(x.reshape(1, -1), axis=-1)
        qt = C.all_to_all(q.reshape(n, -1), axis_name, split_axis=0,
                          concat_axis=0, tiled=False)
        sg = C.all_gather(s.reshape(1), axis_name, axis=0, tiled=False)
        return _sum_in_rank_order(qt.float() * sg).to(x.dtype)
    axis = axis % x.ndim
    if x.shape[axis] % n:
        raise ValueError(f"quantized_reduce_scatter: dim {axis} of size "
                         f"{x.shape[axis]} not divisible by axis "
                         f"{C.resolve_axis(axis_name).name!r} size {n}")
    q, s = quantize_int8(x, axis=-1 if axis != x.ndim - 1 else 0)

    def route(t):
        # the rank chunks of the scatter dim onto a new leading axis, then
        # one untiled all_to_all: rank r holds every rank's chunk r, the
        # leading axis indexing the source rank
        c = t.shape[axis] // n
        tr = t.reshape(t.shape[:axis] + (n, c) + t.shape[axis + 1:])
        return C.all_to_all(tr.movedim(axis, 0), axis_name, split_axis=0,
                            concat_axis=0, tiled=False)

    return _sum_in_rank_order(route(q).float() * route(s)).to(x.dtype)


class _QuantizedReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, axis):
        ctx.axis_name, ctx.axis = axis_name, axis % max(x.ndim, 1)
        return _qrs_value(x, axis_name, axis)

    @staticmethod
    def backward(ctx, g):   # the reduce_scatter's transpose: all_gather
        dim = 0 if g.ndim == 1 else ctx.axis
        return C.all_gather(g, ctx.axis_name, axis=dim), None, None


def quantized_reduce_scatter(x: torch.Tensor, axis_name="dp",
                             axis: int = 0) -> torch.Tensor:
    """Two-shot quantised reduce-scatter (the FSDP grad-traffic leg):
    each rank quantises its whole partial (per row along a dim other
    than ``axis``), one untiled all_to_all each for the codes and the
    scales routes chunk r of every rank to rank r, which dequantises and
    sums them in source-rank order.  A 1-D ``x`` scatters its codes and
    all_gathers one scalar scale a rank.  The same half-quantum bound as
    :func:`quantized_all_reduce`; the backward is a full-precision
    all_gather."""
    return _QuantizedReduceScatter.apply(x, axis_name, axis)
