"""Seeded determinism: the port of the JAX package's ``utils/prng.py``.

``set_seed`` seeds Python's ``random``, numpy and torch (every device)
and returns a ``torch.Generator``, the run's root stream, where the
reference returns its root ``jax.random`` key.  ``key_for_axis`` is the
per-rank stream: a generator seeded from ``(seed, rank)``, where the
reference folds the device's axis index into its key.  The streams
differ from ``jax.random``'s, so parity tests carry the reference's
weights across (``bridge.py``) instead of seeding both sides alike.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .mesh import axis_rank

__all__ = ["set_seed", "key_for_axis"]


def set_seed(seed: int = 42, device=None) -> torch.Generator:
    """Seed ``random``, numpy and torch, and return a generator on
    ``device`` (default: the CPU) seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device or "cpu").manual_seed(seed)


def key_for_axis(seed: int, axis_name="dp", device=None) -> torch.Generator:
    """This rank's generator along ``axis_name``: seeded from ``(seed,
    rank)`` through numpy's ``SeedSequence``, so each rank draws its own
    stream and the same rank always the same one."""
    rank = axis_rank(axis_name)
    sub = int(np.random.SeedSequence([int(seed), rank])
              .generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device or "cpu").manual_seed(sub)
