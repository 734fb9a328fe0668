"""Build-and-load for the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use the
loader compiles it with ``nvcc`` for ``sm_90a`` into a shared library
under ``build/torch_kernels/`` at the repo root and loads it with
``ctypes``.  The library's file name carries a hash of the sources it
was built from, so an edited source is rebuilt, never reused stale.
Nothing is built or loaded at import: the CPU-only test tier imports
every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I = ctypes.c_void_p, ctypes.c_int
# the C functions of each kernel library: name -> {function: (argtypes,
# restype)}
SIGNATURES = {
    "paged_decode": {
        "paged_decode_launch": ([P] * 7 + [I] * 7 + [P], I),
        "paged_decode_scratch_floats": ([I] * 6, ctypes.c_int64),
    },
    "flash_prefill": {
        "flash_prefill_launch": ([P] * 6 + [I] * 8 + [P], I),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler output of each build (ptxas register / spill report)
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(proc or None, tmp, out)``."""
    src, out = _lib_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or none


def build_all(names=None) -> None:
    """Compile every kernel (or ``names``) in parallel, one nvcc each."""
    names = list(names or SIGNATURES)
    with _lock:
        started = [(n, *_start_build(n)) for n in names]
        for n, proc, tmp, out in started:
            _finish_build(n, proc, tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)[1]))
            for entry, (argtypes, restype) in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
    return _libs[name]
