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
    mu: dict | list
    nu: dict | list
    count: int


def _children(tree):
    """``(key, child)`` pairs of a dict (its keys), a list or a tuple (the
    indices); None for a leaf.  A NamedTuple (``QuantizedWeight``) or a
    ``torch.Size`` is a leaf."""
    if isinstance(tree, dict):
        return tree.items()
    if type(tree) in (list, tuple):
        return enumerate(tree)
    return None


def tree_leaves(tree, prefix=()):
    """``(path, leaf)`` of a tree of dicts, lists and tuples, in
    insertion and index order (the order ``tree_map`` visits); a list's
    or tuple's path key is the index."""
    for k, v in _children(tree):
        if _children(v) is None:
            yield prefix + (k,), v
        else:
            yield from tree_leaves(v, prefix + (k,))


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts, lists and tuples, the
    containers rebuilt as they were.  The one tree walk of the port
    (``ops.collectives`` and ``bridge`` map with it too)."""
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in kids}
    return type(tree)(tree_map(fn, v) for _, v in kids)


def tree_unflatten(like, flat):
    """``flat`` (in ``tree_leaves`` order) as a tree shaped like
    ``like``."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


def adam_init(params, state_dtype=None) -> AdamState:
    """Zero moments in ``state_dtype`` (default: each param's dtype)."""
    zeros = lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype)
    return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                     count=0)


@torch.no_grad()
def adam_update(grads, state: AdamState, params, *, lr=1e-3,
                b1=0.9, b2=0.999, eps=1e-8, lr_mults=None):
    """One Adam step; the reference's arithmetic: the moments in their
    own dtype, ``b·m + (1 - b)·g``; the step
    ``(lr · mult) · (m / bc1) / (sqrt(v / bc2) + eps)`` in f32 and the
    new parameter rounded to its dtype.  ``lr_mults``: a tree of
    per-leaf multipliers of ``lr`` shaped like ``params`` (the slow MoE
    router; grad scaling cannot do it, Adam divides it out), 1 when
    None.  In place (see the module docstring); returns ``(params,
    new_state)``."""
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
        mult = 1.0 if lr_mults is None else tree_get(lr_mults, path)
        step = ((lr * mult) * (m.float() / bc1)) / (
            torch.sqrt(v.float() / bc2) + eps)
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
    momentum: dict | list | None


def sgd_init(params, momentum: float = 0.0) -> SGDState:
    return SGDState(momentum=tree_map(torch.zeros_like, params)
                    if momentum else None)


@torch.no_grad()
def sgd_update(grads, state: SGDState, params, *, lr=1e-3,
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
