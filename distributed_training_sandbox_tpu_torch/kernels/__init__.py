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


# dtype codes of the C interfaces; the fp8 kernel (csrc/fp8_matmul.cu)
# takes e4m3, the attention kernels bf16 (and f32 for the paged ones)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def check_cuda_operands(name: str, floats: dict, ints: dict,
                        others: dict | None = None) -> int | None:
    """Validate a kernel's operands: one CUDA device, contiguous, the
    float operands of one supported dtype, the index operands int32
    (``others``: any dtype, checked by the caller).  Returns the dtype
    code of the C interface (None without float operands)."""
    dev = None
    for k, t in {**floats, **ints, **(others or {})}.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {k} is on {t.device}, not CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")
    for k, t in ints.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {k} must be int32, got {t.dtype}")
    if not floats:
        return None
    dts = {t.dtype for t in floats.values()}
    if len(dts) != 1 or next(iter(dts)) not in DTYPE_CODES:
        raise ValueError(f"{name}: float operands must share one dtype of "
                         f"{list(DTYPE_CODES)}, got {sorted(map(str, dts))}")
    return DTYPE_CODES[next(iter(dts))]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, fn, *args, device: torch.device) -> None:
    """Call the C launcher ``fn(*args, stream)`` with ``device`` as the
    CUDA runtime's current device and its current stream, and raise on
    the launcher's error code.  The runtime launches a kernel (and
    ``cudaFuncSetAttribute`` sets its attributes) on the *current*
    device, whatever device the operands lie on, so every wrapper
    launches through here: a stage on ``cuda:1`` of a one-process
    pipeline gets its kernels on ``cuda:1``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
