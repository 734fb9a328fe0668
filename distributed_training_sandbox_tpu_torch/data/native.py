"""ctypes binding of the native (C++) data engine, ``native/dtsdata.cpp``:
the port of the JAX package's ``data/native.py``.

Three C functions: ``dts_zipf_fill`` (the alias-method Zipf sampler of
the synthetic stream), ``dts_pack_windows`` (the window packer) and
``dts_shuffle_indices`` (a seeded Fisher–Yates permutation).  At first
use the library is built with ``g++`` from the committed source into
``build/native/`` at the repo root (the file name carries a hash of the
source, so an edited source is rebuilt and a stale library never
loaded), through a per-process temporary file and an atomic rename, so
that two processes building at once never load a half-written library.
Nothing is written into ``native/``.

Each stream is a pure function of its arguments and seed, the same on
every host: the packer's windows are ``packing.pack_tokens``'s bit for
bit, and the Zipf stream is its own (not numpy's ``Generator.choice``).
Where the library cannot be built or loaded, ``available()`` is False,
``build_error()`` says why, and every entry point raises: nothing falls
back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "build_error", "synthetic_token_stream",
           "pack_tokens", "shuffle_indices", "SOURCE", "BUILD_DIR"]

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "dtsdata.cpp"
BUILD_DIR = ROOT / "build" / "native"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_err: str | None = None


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdtsdata-{digest}.so"


def _build(lib: Path) -> None:
    """``g++`` the source into ``lib`` through a per-process temporary
    file and an atomic rename."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp),
                        str(SOURCE)], check=True, capture_output=True,
                       text=True, timeout=120)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL | None:
    global _lib, _err
    with _lock:
        if _lib is not None or _err is not None:
            return _lib
        try:
            path = _library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.dts_zipf_fill.argtypes = [i32p, ctypes.c_int64,
                                          ctypes.c_int32, ctypes.c_uint64]
            lib.dts_zipf_fill.restype = None
            lib.dts_pack_windows.argtypes = [i32p, ctypes.c_int64,
                                             ctypes.c_int64, i32p, i32p]
            lib.dts_pack_windows.restype = ctypes.c_int64
            lib.dts_shuffle_indices.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_uint64]
            lib.dts_shuffle_indices.restype = None
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", None) or ""
            _err = f"{type(e).__name__}: {e} {detail}".strip()
        return _lib


def available() -> bool:
    """Whether the library built and loaded."""
    return _load() is not None


def build_error() -> str | None:
    """Why the native engine is unavailable (None when it is)."""
    _load()
    return _err


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native data engine unavailable: {_err}")
    return lib


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def synthetic_token_stream(num_tokens: int, vocab_size: int,
                           seed: int = 42) -> np.ndarray:
    """The engine's Zipf stream (p ∝ 1 / rank, the law of
    ``packing.synthetic_token_stream``, its own stream): int32
    (num_tokens,)."""
    lib = _lib_or_raise()
    out = np.empty(num_tokens, np.int32)
    lib.dts_zipf_fill(_i32ptr(out), num_tokens, vocab_size, seed)
    return out


def pack_tokens(tokens: np.ndarray, seq_len: int):
    """``packing.pack_tokens`` in C: (input_ids, labels), each
    (n_windows, seq_len) int32, the same values."""
    lib = _lib_or_raise()
    tokens = np.ascontiguousarray(np.asarray(tokens).reshape(-1), np.int32)
    window = seq_len + 1
    n = len(tokens) // window
    if n == 0:
        raise ValueError(f"stream of {len(tokens)} tokens too short for "
                         f"one window of {window}")
    inputs = np.empty((n, seq_len), np.int32)
    labels = np.empty((n, seq_len), np.int32)
    got = lib.dts_pack_windows(_i32ptr(tokens), len(tokens), seq_len,
                               _i32ptr(inputs), _i32ptr(labels))
    if got != n:
        raise RuntimeError(f"dts_pack_windows packed {got} windows, "
                           f"expected {n}")
    return inputs, labels


def shuffle_indices(n: int, seed: int = 0) -> np.ndarray:
    """A seeded Fisher–Yates permutation of [0, n), int64."""
    lib = _lib_or_raise()
    out = np.empty(n, np.int64)
    lib.dts_shuffle_indices(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, seed)
    return out
