"""ZeRO-1/2/3 from scratch over a process group.

Port of the JAX package's ``parallel/zero.py``, as plain functions on
tensors over ``ops/collectives.py``.  The JAX package's design is kept:
  * the partition is the **flat per-param chunk**: each param flattened,
    zero-padded to a multiple of the world size ws, and every rank owns
    1/ws of *every* param (``partition_params`` and ``owner_of_param``
    keep the reference's whole-param ownership rule, for the tests);
  * ZeRO-1: per-leaf grad all_reduce and / ws, Adam on this rank's
    chunks, each param rebuilt from every rank's chunk:
    ``rebuild="broadcast"`` as a masked all_reduce (each rank's chunk at
    its offset, zeros elsewhere: the wire twin of a per-param owner
    broadcast, so the step issues 2n + 2 all_reduces), or
    ``rebuild="all_gather"``;
  * ZeRO-2: each padded flat grad reduce_scattered straight to the chunk
    and / ws (no ws-fold concatenation);
  * ZeRO-3: params at rest as chunks; each layer's ``w`` and ``b``
    gathered inside a non-reentrant ``torch.utils.checkpoint``, so the
    backward gathers them again (the last layer's ``b`` is gathered
    outside it, once, as the reference's compiled step gathers it); the
    grads arrive through the gather's backward, a reduce_scatter, and
    are divided by ws.

Adam (``optim.adam_update``) writes in place, so a chunk of a replicated
param is always a copy (:func:`local_chunk`): the update never touches
the full param that the rebuild replaces.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import collectives as C
from ..utils import mesh
from . import optim
from .fsdp import local_batch, microbatch_value_and_grad

REBUILD_MODES = ("broadcast", "all_gather")


# ---------------------------------------------------------------- partition

def partition_params(n_params: int, ws: int) -> list[list[int]]:
    """The reference's whole-param partition rule: contiguous param-index
    ranges, the remainder spread over the leading ranks."""
    base, rem = divmod(n_params, ws)
    out, start = [], 0
    for r in range(ws):
        size = base + (1 if r < rem else 0)
        out.append(list(range(start, start + size)))
        start += size
    return out


def owner_of_param(i: int, n_params: int, ws: int) -> int:
    """The owner rank of param ``i`` under :func:`partition_params`,
    by arithmetic."""
    base, rem = divmod(n_params, ws)
    boundary = rem * (base + 1)
    if i < boundary:
        return i // (base + 1)
    return rem + (i - boundary) // base if base else ws - 1


# ------------------------------------------------------------ chunk helpers

def _padded_size(size: int, ws: int) -> int:
    return -(-size // ws) * ws


def _pad_flat(x: torch.Tensor, ws: int) -> torch.Tensor:
    """Flatten and zero-pad to a multiple of ws: the one place the chunk
    alignment rule lives (local_chunk, ZeRO-2's reduce_scatter and
    chunk_shapes agree through it)."""
    flat = x.reshape(-1)
    pad = _padded_size(flat.numel(), ws) - flat.numel()
    return F.pad(flat, (0, pad)) if pad else flat


def chunk_of(full: torch.Tensor, rank: int, ws: int) -> torch.Tensor:
    """Rank ``rank``'s flat chunk of ``full`` over ``ws`` ranks (pad to
    ws, then slice), as a tensor of its own: no alias of ``full``."""
    flat = _pad_flat(full, ws)
    c = flat.numel() // ws
    return flat[rank * c:(rank + 1) * c].clone()


def local_chunk(full: torch.Tensor, axis="dp") -> torch.Tensor:
    """This rank's :func:`chunk_of` ``full``: pure data movement, no
    collective."""
    return chunk_of(full, mesh.axis_rank(axis), mesh.axis_size(axis))


def rebuild_param(chunk: torch.Tensor, shape, size: int, axis="dp",
                  mode: str = "broadcast") -> torch.Tensor:
    """The full param from every rank's chunk.  ``mode="broadcast"``: a
    masked all_reduce (this rank's chunk at its offset, zeros
    elsewhere); ``mode="all_gather"``: a tiled all_gather (less traffic,
    the same values)."""
    if mode == "all_gather":
        flat = C.all_gather(chunk, axis)
    elif mode == "broadcast":
        ws, idx = mesh.axis_size(axis), mesh.axis_rank(axis)
        c = chunk.numel()
        padded = chunk.new_zeros(c * ws)
        padded[idx * c:(idx + 1) * c] = chunk
        flat = C.all_reduce(padded, axis)
    else:
        raise ValueError(f"unknown rebuild mode {mode!r}")
    return flat[:size].reshape(shape)


def chunk_shapes(params, ws: int):
    """The per-rank chunk tree as meta tensors (shape and dtype, no
    storage)."""
    return optim.tree_map(
        lambda p: torch.empty((_padded_size(p.numel(), ws) // ws,),
                              dtype=p.dtype, device="meta"), params)


def _rebuild_tree(chunks, like, axis, mode):
    """Every param rebuilt from its chunk in ``chunks``, shaped as its leaf
    of ``like`` (the params, or meta tensors of their shapes)."""
    return optim.tree_unflatten(like, [
        rebuild_param(optim.tree_get(chunks, path), p.shape, p.numel(),
                      axis, mode)
        for path, p in optim.tree_leaves(like)])


# ------------------------------------------------------------- ZeRO-1 / -2

def make_zero_train_step(loss_fn: Callable, axis="dp", *, stage: int = 1,
                         lr: float = 1e-3, b1: float = 0.9,
                         b2: float = 0.999, eps: float = 1e-8,
                         rebuild: str = "broadcast"):
    """ZeRO-1 or ZeRO-2 step: ``(params, opt_state, batch) -> (params,
    opt_state, loss)``.  ``params`` replicated; ``opt_state`` an AdamState
    over this rank's flat chunks (:func:`init_zero_opt_state`); ``batch``
    the global batch, each rank taking its contiguous rows."""
    if stage not in (1, 2):
        raise ValueError("use make_zero3_train_step for stage 3")
    if rebuild not in REBUILD_MODES:
        raise ValueError(f"unknown rebuild mode {rebuild!r}")

    def step(params, opt_state, batch):
        ws = mesh.axis_size(axis)
        loss, grads = microbatch_value_and_grad(
            loss_fn, params, local_batch(batch, axis), 1)
        loss = C.all_reduce(loss, axis, mean=True)
        with torch.no_grad():
            if stage == 1:
                grads = C.tree_all_reduce(grads, axis, mean=True)
                grad_chunks = optim.tree_map(
                    lambda g: local_chunk(g, axis), grads)
            else:
                grad_chunks = optim.tree_map(
                    lambda g: C.reduce_scatter(_pad_flat(g, ws), axis) / ws,
                    grads)
            del grads
            param_chunks = optim.tree_map(lambda p: local_chunk(p, axis),
                                          params)
            new_chunks, opt_state = optim.adam_update(
                grad_chunks, opt_state, param_chunks, lr=lr, b1=b1, b2=b2,
                eps=eps)
            params = _rebuild_tree(new_chunks, params, axis, rebuild)
        loss = loss + 0.0 * C.barrier(axis)
        return params, opt_state, loss

    return step


def init_zero_opt_state(params, axis="dp") -> optim.AdamState:
    """AdamState over this rank's flat chunks: 1/ws of every param's
    moments, on the param's device."""
    ws = mesh.axis_size(axis)

    def zeros(p):
        return torch.zeros((_padded_size(p.numel(), ws) // ws,),
                           dtype=p.dtype, device=p.device)
    return optim.AdamState(mu=optim.tree_map(zeros, params),
                           nu=optim.tree_map(zeros, params), count=0)


# ------------------------------------------------------------------ ZeRO-3

def make_zero3_mlp_loss(shapes: list[dict], axis="dp"):
    """The layered MLP's loss over *chunked* params: each layer's ``w``
    and ``b`` gathered (all_gather) inside a non-reentrant checkpoint, so
    the backward gathers them again, except the last layer's ``b``.  That
    one is gathered before the last layer's checkpoint: the backward
    needs no recomputed value after ``x @ w`` there (no ReLU follows),
    so the recompute stops before any gather of ``b``, and a step issues
    the 2n - 1 gathers that the reference compiles.  ``shapes``:
    per-layer ``{"w": (in, out), "b": (out,)}`` shapes of the full
    params.  The gather's backward, a reduce_scatter, sums the ranks'
    grads into each chunk."""

    def gather(chunk, shape):
        return rebuild_param(chunk, shape, math.prod(shape), axis,
                             "all_gather")

    def layer_call(cw, b, x, meta, is_last):
        w = gather(cw, meta["w"])
        if not is_last:
            b = gather(b, meta["b"])
        x = x @ w + b
        return x if is_last else torch.relu(x)

    def loss_fn(chunk_params, batch):
        x, y = batch
        last = len(shapes) - 1
        for i, (layer, meta) in enumerate(zip(chunk_params, shapes)):
            b = gather(layer["b"], meta["b"]) if i == last else layer["b"]
            fn = partial(layer_call, meta=meta, is_last=i == last)
            x = checkpoint(fn, layer["w"], b, x, use_reentrant=False)
        return torch.mean((x - y) ** 2)

    return loss_fn


def make_zero3_train_step(chunk_loss_fn: Callable, axis="dp", *,
                          lr: float = 1e-3, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8):
    """ZeRO-3 step over chunked params: ``(chunk_params, opt_state, batch)
    -> (chunk_params, opt_state, loss)``.  ``chunk_loss_fn`` gathers the
    full params itself (:func:`make_zero3_mlp_loss`); its grads w.r.t.
    the chunks are the ranks' sum, divided here by ws."""

    def step(chunk_params, opt_state, batch):
        ws = mesh.axis_size(axis)
        loss, grad_chunks = microbatch_value_and_grad(
            chunk_loss_fn, chunk_params, local_batch(batch, axis), 1)
        loss = C.all_reduce(loss, axis, mean=True)
        grad_chunks = optim.tree_map(lambda g: g / ws, grad_chunks)
        chunk_params, opt_state = optim.adam_update(
            grad_chunks, opt_state, chunk_params, lr=lr, b1=b1, b2=b2,
            eps=eps)
        loss = loss + 0.0 * C.barrier(axis)
        return chunk_params, opt_state, loss

    return step


def shard_params_zero3(params, axis="dp"):
    """Replicated params → this rank's at-rest chunks."""
    return optim.tree_map(lambda p: local_chunk(p, axis), params)


@torch.no_grad()
def unshard_params_zero3(chunk_params, shapes: list[dict], axis="dp"):
    """This rank's chunks → the full params (one all_gather a leaf)."""
    like = [{k: torch.empty(s, device="meta") for k, s in meta.items()}
            for meta in shapes]
    return _rebuild_tree(chunk_params, like, axis, "all_gather")
