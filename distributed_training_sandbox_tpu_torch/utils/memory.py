"""Memory accounting: the part of the JAX package's ``utils/memory.py``
that the pipeline reads.

``tree_size_bytes`` walks a tensor tree; ``device_memory_stats`` reads
the caching allocator of a CUDA device (``torch.cuda.memory_stats``:
``allocated_bytes.all.current`` and ``.peak``, the card's total memory
as the limit).  The CPU has no allocator statistics, so there every
field reads 0, as the reference reads on a backend without them.  The
rest of the module (failure classification, the HBM parsers, the
per-device sampler) belongs to ROADMAP.md queue A item A8.
"""

from __future__ import annotations

import torch

from ..parallel.optim import tree_leaves

MB = 1024 ** 2


def tree_size_bytes(tree) -> int:
    """Total bytes of the tensor leaves of a tree of dicts, lists and
    tuples."""
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def device_memory_stats(device=None) -> dict[str, int]:
    """``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit`` of one
    device's allocator (default: the current CUDA device); zeros for
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev)
                           .total_memory),
    }
