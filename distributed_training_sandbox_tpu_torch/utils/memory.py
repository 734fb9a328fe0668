"""Memory accounting: port of the JAX package's ``utils/memory.py``.

``tree_size_bytes`` walks a tensor tree (the component sizes of the
reference's ``training_utils/memory.py``); ``device_memory_stats`` reads
the caching allocator of a CUDA device (``torch.cuda.memory_stats``:
``allocated_bytes.all.current`` and ``.peak``, the card's total memory
as the limit).  The CPU has no allocator statistics, so there every
field reads 0, as the reference reads on a backend without them.

The reference parses XLA's HBM verdicts; here :func:`classify_failure`
and :func:`parse_hbm_oom` read PyTorch's CUDA out-of-memory errors, and
:func:`hbm_capacity_gb` asks ``torch.cuda.mem_get_info``.  The
reference's shared per-device sampler belongs to its memory ledger
(ROADMAP.md queue A item A12); :func:`all_devices_memory_gb` polls the
allocator directly.
"""

from __future__ import annotations

import re

import torch

MB = 1024 ** 2
GB = 1024 ** 3

_OOM_RE = re.compile(r"(CUDA out of memory|out of memory)[^\n]*")
_CUDA_OOM_RE = re.compile(
    r"Tried to allocate ([\d.]+) (GiB|MiB|KiB|B)\b.*?total capacity of "
    r"([\d.]+) (GiB|MiB)", re.S)
_UNIT = {"B": 1 / GB, "KiB": 1 / 1024 ** 2, "MiB": 1 / 1024, "GiB": 1.0}


def classify_failure(e: BaseException) -> tuple[str, str]:
    """(kind, message) for a benchmark-sweep failure: kind is ``"oom"``
    only when PyTorch's own verdict says so (``torch.OutOfMemoryError``
    or its CUDA out-of-memory text) — anything else is a real error and
    must not be published as the memory edge."""
    msg = str(e)
    if isinstance(e, torch.OutOfMemoryError) or _OOM_RE.search(msg):
        m = _OOM_RE.search(msg)
        return "oom", (m.group(0) if m else msg)[:200]
    return "error", f"{type(e).__name__}: {msg[:200]}"


def parse_hbm_oom(msg: str) -> tuple[float, float] | None:
    """``(needed_gb, capacity_gb)`` from a CUDA out-of-memory message
    (``Tried to allocate X GiB. GPU 0 has a total capacity of Y GiB``),
    GB of 2^30 bytes, or None when the text carries no such verdict."""
    m = _CUDA_OOM_RE.search(msg)
    if not m:
        return None
    return (float(m.group(1)) * _UNIT[m.group(2)],
            float(m.group(3)) * _UNIT[m.group(4)])


def _cuda_device(device=None) -> torch.device:
    """``device``, or the current card (the CPU where there is none)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def hbm_capacity_gb(device=None) -> float | None:
    """One card's memory in GB (``torch.cuda.mem_get_info``'s total), or
    None on the CPU or without a card."""
    dev = _cuda_device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.mem_get_info(dev)[1] / GB


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):    # NamedTuples too
        for v in tree:
            yield from _tensors(v)


def tree_size_bytes(tree) -> int:
    """Total bytes of the tensor leaves of a tree of dicts, lists, tuples
    and NamedTuples (an ``AdamState``, a ``Q8``)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def tree_size_mb(tree) -> float:
    """`tree_size_bytes` in MB."""
    return tree_size_bytes(tree) / MB


def tree_local_size_mb(tree) -> float:
    """The bytes this rank holds of a tree, in MB.  The port's shards
    are plain per-rank tensors, so this is :func:`tree_size_mb` of the
    rank's tree (the reference sums one device's addressable shards)."""
    return tree_size_mb(tree)


def device_memory_stats(device=None) -> dict[str, int]:
    """``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit`` of one
    device's allocator (default: the current CUDA device); zeros for
    the CPU."""
    dev = _cuda_device(device)
    if dev.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev)
                           .total_memory),
    }


def peak_memory_gb(device=None) -> float:
    return device_memory_stats(device)["peak_bytes_in_use"] / GB


def all_devices_memory_gb() -> dict[str, dict[str, float]]:
    """Per-card current/peak GB of every visible card (empty without
    one), keyed by the card's index as the reference keys device ids."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = device_memory_stats(torch.device("cuda", i))
        out[str(i)] = {"current_gb": s["bytes_in_use"] / GB,
                       "peak_gb": s["peak_bytes_in_use"] / GB}
    return out


def print_memory_stats(tag: str, params=None, grads=None, opt_state=None,
                       *, device=None, printer=print) -> dict[str, float]:
    """Component-wise MB + allocator totals, twin of
    ``print_memory_stats``; returns the dict it prints."""
    stats = {}
    if params is not None:
        stats["model_mb"] = tree_size_mb(params)
    if grads is not None:
        stats["grads_mb"] = tree_size_mb(grads)
    if opt_state is not None:
        stats["optimizer_mb"] = tree_size_mb(opt_state)
    dev = device_memory_stats(device)
    stats["device_in_use_mb"] = dev["bytes_in_use"] / MB
    stats["device_peak_mb"] = dev["peak_bytes_in_use"] / MB
    parts = " | ".join(f"{k}={v:,.1f}" for k, v in stats.items())
    printer(f"[memory:{tag}] {parts}")
    return stats
