"""The port's hand-written CUDA kernels: sources in ``../csrc``, built
and loaded by :mod:`.loader` at first use."""

from __future__ import annotations

import ctypes

import torch


class LaunchCount:
    """Two plain counters kept by a kernel's module: ``launches`` of the
    CUDA kernel, and ``plain_calls`` of its plain PyTorch version on any
    device (the wrapper takes it for CPU tensors; the engine's plain
    path takes it directly)."""

    def __init__(self):
        self.launches = 0
        self.plain_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda_operands(name: str, floats: dict, ints: dict) -> int:
    """Validate a kernel's operands: one CUDA device, contiguous, the
    float operands of one supported dtype, the index operands int32.
    Returns the dtype code of the C interface."""
    dev = None
    for k, t in {**floats, **ints}.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {k} is on {t.device}, not CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    dts = {t.dtype for t in floats.values()}
    if len(dts) != 1 or next(iter(dts)) not in DTYPE_CODES:
        raise ValueError(f"{name}: float operands must share one dtype of "
                         f"{list(DTYPE_CODES)}, got {sorted(map(str, dts))}")
    for k, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {k} must be int32, got {t.dtype}")
    return DTYPE_CODES[next(iter(dts))]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
