"""Functional per-leaf optimisers over the parameter tree.

Port of the JAX package's ``parallel/optim.py``: Adam with bias
correction (torch.optim.Adam's defaults), its f32 math cast back to
each parameter's dtype, the warmup-cosine schedule, and SGD.  The
reference is pure and donates its buffers to XLA
(``parallel/fsdp.py:461``); here ``adam_update`` writes the moments and
the parameters in place, which saves the second copy donation saves.
It returns the same tensors it was given.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: int


def tree_leaves(tree: dict, prefix=()):
    """``(path, leaf)`` of a dict tree, in insertion order (the order
    ``tree_map`` visits)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_get(tree: dict, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def adam_init(params: dict, state_dtype=None) -> AdamState:
    """Zero moments in ``state_dtype`` (default: each param's dtype)."""
    zeros = lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype)
    return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                     count=0)


@torch.no_grad()
def adam_update(grads: dict, state: AdamState, params: dict, *, lr=1e-3,
                b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step; the reference's arithmetic: the moments in their
    own dtype, ``b·m + (1 - b)·g``; the step
    ``lr · (m / bc1) / (sqrt(v / bc2) + eps)`` in f32 and the new
    parameter rounded to its dtype.  In place (see the module
    docstring); returns ``(params, new_state)``."""
    count = state.count + 1
    c = torch.tensor(float(count))   # the bias corrections in f32
    bc1 = 1 - torch.tensor(b1) ** c
    bc2 = 1 - torch.tensor(b2) ** c
    for path, p in tree_leaves(params):
        g = tree_get(grads, path)
        m, v = tree_get(state.mu, path), tree_get(state.nu, path)
        bc1, bc2 = bc1.to(p.device), bc2.to(p.device)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        step = (lr * (m.float() / bc1)) / (torch.sqrt(v.float() / bc2) + eps)
        p.copy_(p.float() - step)
    return params, AdamState(mu=state.mu, nu=state.nu, count=count)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, min_ratio: float = 0.1):
    """``count -> lr``: linear warmup to ``peak_lr`` over
    ``warmup_steps``, then cosine decay to ``min_ratio · peak_lr`` at
    ``total_steps``; ``count`` is the optimiser step counter (0 on the
    first update).  f32 arithmetic, as the reference's."""

    def sched(count) -> float:
        c = torch.tensor(float(count), dtype=torch.float32)
        if c < warmup_steps:
            return float(peak_lr * (c + 1.0) / max(warmup_steps, 1))
        span = max(total_steps - warmup_steps, 1)
        prog = torch.clamp((c - warmup_steps) / span, 0.0, 1.0)
        floor = min_ratio * peak_lr
        return float(floor + (peak_lr - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))

    return sched


class SGDState(NamedTuple):
    momentum: dict | None


def sgd_init(params: dict, momentum: float = 0.0) -> SGDState:
    return SGDState(momentum=tree_map(torch.zeros_like, params)
                    if momentum else None)


@torch.no_grad()
def sgd_update(grads: dict, state: SGDState, params: dict, *, lr=1e-3,
               momentum=0.0):
    """SGD with optional momentum ``buf = momentum · buf + g``; in
    place."""
    for path, p in tree_leaves(params):
        g = tree_get(grads, path)
        if momentum and state.momentum is not None:
            buf = tree_get(state.momentum, path)
            buf.copy_(momentum * buf + g)
            g = buf
        p.copy_(p - lr * g)
    return params, state
