"""The fp8 tier of the precision stack: the Float8Linear recipe (e4m3
forward operands, e5m2 grad_output in the backward, per-tensor absmax
scales), and the forward product's CUDA kernel ``csrc/fp8_matmul.cu``
(K6) with its plain PyTorch version.

Port of the fp8 part of the JAX package's ``ops/quant.py`` (``:533-687``)
and of ``resolve_quantized_dense`` for ``bf16`` and the fp8 names.  The
int8 tier (``quantized_dense``, kernels K4 and K5) is not ported yet.

Dispatch of ``fp8_matmul_kernel``: a CPU tensor goes to the plain
version (``fp8_matmul``) and is counted in ``COUNTS.plain_calls``; a
CUDA tensor launches the kernel or raises.  The backward of
``fp8_dense`` is plain products on every device, as the reference
computes it outside any Pallas kernel; each is counted in
``BWD_COUNTS.plain_calls``.

Tolerance of the kernel against the plain version (``TOLERANCE``): both
multiply the same fp8 operands, and each product of two fp8 values is
exact in f32, so they differ only in the order of the f32 sum, and then
in the one bf16 rounding of the output; the limits are stated below
and set between the sound kernel's reading and a mutant's
(``chip_smoke.py``, ``chip_gate_mutation.py``).
"""

from __future__ import annotations

import torch

from ..kernels import (LaunchCount, check_cuda_operands, loader, ptr,
                       raise_on_error, stream_ptr)

__all__ = ["FP8_FWD_DTYPE", "FP8_BWD_DTYPE", "fp8_max",
           "amax_history_update", "scale_from_history", "quantize_fp8",
           "fp8_matmul", "fp8_matmul_kernel", "fp8_dense",
           "resolve_quantized_dense", "COUNTS", "BWD_COUNTS", "TOLERANCE"]

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

_ROADMAP_INT8 = ("the int8 precisions are not ported yet — see "
                 "ROADMAP.md, queue B items 3 and 4 (K5, K4)")


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
    """Delayed scaling's scale: the absmax over the whole history."""
    amax = history.max()
    return torch.where(amax > 0, amax / fp8_max(dtype),
                       torch.ones_like(amax))


def quantize_fp8(x: torch.Tensor, dtype=FP8_FWD_DTYPE, *,
                 amax_history_len: int = 0):
    """Per-tensor absmax scaling to fp8: ``(q, scale f32 scalar)`` with
    ``dequant = q * scale``.  ``amax_history_len > 0`` routes the scale
    through the delayed-scaling helpers, with the history seeded by the
    current tensor (numerically the dynamic scale), as the reference's
    stateless instantiation does."""
    if amax_history_len:
        hist = amax_history_update(
            torch.zeros((amax_history_len,), dtype=torch.float32,
                        device=x.device), x)
        scale = scale_from_history(hist, dtype)
    else:
        amax = x.float().abs().max()
        scale = torch.where(amax > 0, amax / fp8_max(dtype),
                            torch.ones_like(amax))
    fmax = fp8_max(dtype)
    q = torch.clamp(x.float() / scale, -fmax, fmax).to(dtype)
    return q, scale


def fp8_matmul(aq, a_scale, bq, b_scale, out_dtype):
    """K6's plain version: (M, K)·(K, N) over fp8 operands upcast to
    f32, f32 accumulation, then ``(acc · a_scale) · b_scale`` rounded to
    ``out_dtype`` — the reference's order.  Also the product of the
    backward, which passes transposed views."""
    acc = aq.float() @ bq.float()
    return (acc * a_scale * b_scale).to(out_dtype)


def fp8_matmul_kernel(aq, a_scale, bq, b_scale, out_dtype=torch.bfloat16):
    """K6: aq (M, K) e4m3, bq (K, N) e4m3 in the reference's layout,
    scales f32 scalars; returns (M, N) ``out_dtype`` (bf16 on the
    card).  The kernel takes B K-major, so this wrapper hands it
    ``bq.T`` contiguous: one (N, K) fp8 copy (K·N bytes read and
    written), counted in the kernel phase's bound."""
    if aq.device.type == "cpu":
        COUNTS.plain_calls += 1
        return fp8_matmul(aq, a_scale, bq, b_scale, out_dtype)
    M, K = aq.shape
    K2, N = bq.shape
    if K != K2:
        raise ValueError(f"fp8_matmul_kernel: inner dims {K} != {K2}")
    if out_dtype != torch.bfloat16:
        raise ValueError("fp8_matmul_kernel writes bf16 only")
    if K % 16:
        raise ValueError(f"fp8_matmul_kernel: K={K} must be a multiple "
                         f"of 16 (16-byte row loads)")
    bt = bq.t().contiguous()
    a_s = a_scale.reshape(1).float().contiguous()
    b_s = b_scale.reshape(1).float().contiguous()
    check_cuda_operands("fp8_matmul_kernel", {"aq": aq, "bt": bt}, {})
    if aq.dtype != FP8_FWD_DTYPE or bt.dtype != FP8_FWD_DTYPE:
        raise ValueError("fp8_matmul_kernel takes e4m3 operands")
    if a_s.device != aq.device or b_s.device != aq.device:
        raise ValueError("fp8_matmul_kernel: scales must be on the "
                         "operands' device")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=aq.device)
    fn = loader.load("fp8_matmul").fp8_matmul_launch
    rc = fn(ptr(aq), ptr(bt), ptr(a_s), ptr(b_s), ptr(out), M, N, K,
            stream_ptr(aq.device))
    raise_on_error("fp8_matmul_kernel", rc)
    COUNTS.launches += 1
    return out


class _FP8Dense(torch.autograd.Function):
    """``fp8_dense`` with the reference's custom VJP."""

    @staticmethod
    def forward(ctx, x, w, impl, hist):
        ctx.save_for_backward(x, w)
        ctx.hist = hist
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        xq, xs = quantize_fp8(x2, FP8_FWD_DTYPE, amax_history_len=hist)
        wq, ws = quantize_fp8(w, FP8_FWD_DTYPE, amax_history_len=hist)
        if impl == "kernel":
            out = fp8_matmul_kernel(xq, xs, wq, ws, x.dtype)
        else:
            COUNTS.plain_calls += 1
            out = fp8_matmul(xq, xs, wq, ws, x.dtype)
        return out.reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        hist = ctx.hist
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
        return gx.reshape(*lead, K), gw, None, None


def fp8_dense(x, w, impl: str = "plain", amax_history_len: int = 0):
    """``x @ w`` under the Float8Linear recipe.  ``impl``: ``"kernel"``
    (forward through K6) or ``"plain"``; the backward is plain either
    way."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"fp8_dense: unknown impl {impl!r}")
    return _FP8Dense.apply(x, w, impl, amax_history_len)


def resolve_quantized_dense(precision: str, *, fp8_history_len: int = 0):
    """``matmul_precision`` → ``(a, w) -> out``: ``"bf16"`` a plain
    matmul; ``"fp8"`` and ``"fp8_delayed"`` the recipe with the plain
    forward; ``"fp8_pallas"`` the recipe with K6 forward (the
    reference's Pallas-forward name)."""
    if precision == "bf16":
        return torch.matmul
    if precision in ("fp8", "fp8_delayed", "fp8_pallas"):
        impl = "kernel" if precision == "fp8_pallas" else "plain"
        hist = (fp8_history_len or 16) if precision == "fp8_delayed" else 0
        return lambda a, w: fp8_dense(a, w, impl, hist)
    if precision.startswith("int8"):
        raise NotImplementedError(
            f"matmul_precision={precision!r}: {_ROADMAP_INT8}")
    raise ValueError(f"unknown matmul_precision {precision!r}")
