"""Data parallelism from scratch over a process group.

Port of the JAX package's ``parallel/ddp.py``, as plain functions on
tensors over ``ops/collectives.py`` (no ``shard_map``, no jit):
  * init: every param broadcast from rank 0 (:func:`broadcast_params`),
    then the divergence check :func:`params_sync_error`, exactly 0.0 iff
    every rank holds rank 0's values;
  * per step: this rank's contiguous rows of the global batch, local
    forward and backward, then :func:`sync_gradients`, one all_reduce a
    leaf and a division by the world size; or flat buckets
    (:func:`bucket_gradients`), or int8 buckets shipped as all_gathers
    (:func:`quantized_bucket_all_reduce`, with an optional error-feedback
    residual that each rank keeps for itself);
  * the loss averaged over the ranks (one all_reduce) and a one-element
    all_reduce as the step barrier, so the per-leaf step issues n + 2
    all_reduces, the ``ddp`` contract's count.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import collectives as C
from ..ops.quant import INV_127
from ..utils import mesh
from . import optim
from .fsdp import local_batch, microbatch_value_and_grad

# int8 grad sync: the flat-bucket size when none is given (the q8 path
# always buckets: a bucket's scale is the quantisation's granularity)
DEFAULT_Q8_BUCKET_MB = 25.0


def broadcast_params(params, axis="dp", root: int = 0):
    """Per-leaf broadcast from ``root`` (one collective a leaf)."""
    return C.broadcast(params, axis, root)


@torch.no_grad()
def params_sync_error(params, axis="dp") -> torch.Tensor:
    """Total squared divergence of every leaf from rank 0's value, summed
    over the ranks: exactly 0.0 iff all ranks hold identical values."""
    leaves = [p for _, p in optim.tree_leaves(params)]
    err = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for p in leaves:
        err = err + torch.sum((p - C.broadcast(p, axis, 0)) ** 2)
    return C.all_reduce(err, axis)


def sync_gradients(grads, axis="dp"):
    """Per-leaf all_reduce (sum), then / world size."""
    return C.tree_all_reduce(grads, axis, mean=True)


def _dtype_groups(leaves) -> dict:
    """Leaf indices by dtype, in order of first appearance."""
    groups: dict = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    return groups


def _bucket_cap(bucket_mb: float, dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in a ``bucket_mb``-MB bucket (at least 1)."""
    return max(max(int(bucket_mb * 2 ** 20), 1) // dtype.itemsize, 1)


@torch.no_grad()
def bucket_gradients(grads, axis="dp", bucket_mb: float = 25.0):
    """Bucketed gradient sync: the leaves of each dtype (in tree order)
    concatenated into one flat vector, split into exact-capacity
    ``bucket_mb``-MB chunks, one all_reduce a chunk, the means scattered
    back into the tree.  ``ceil(bytes / bucket)`` all_reduces in place of
    one a leaf."""
    leaves = [g for _, g in optim.tree_leaves(grads)]
    ws = mesh.axis_size(axis)
    out = list(leaves)
    for dt, idxs in _dtype_groups(leaves).items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        cap = _bucket_cap(bucket_mb, dt)
        chunks = [C.all_reduce(flat[s:s + cap], axis)
                  for s in range(0, flat.numel(), cap)]
        red = (torch.cat(chunks) if len(chunks) > 1 else chunks[0]) / ws
        off = 0
        for i in idxs:
            n = leaves[i].numel()
            out[i] = red[off:off + n].reshape(leaves[i].shape)
            off += n
    return optim.tree_unflatten(grads, out)


def init_grad_residual(params):
    """This rank's error-feedback residual for
    :func:`quantized_bucket_all_reduce`: an f32 zero tree shaped like
    ``params`` (each rank's quantisation error is its own; the JAX step
    stacks the ranks' trees on a leading axis)."""
    return optim.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def quantize_bucket(c: torch.Tensor):
    """``(int8 codes, f32 scale)`` of one flat f32 bucket: one absmax
    scale, ``amax · f32(1/127)`` (the jitted reference's form of
    ``amax / 127``; 1 for an all-zero bucket), codes ``round(c / scale)``
    half to even, clipped to ±127."""
    amax = c.abs().max()
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def quantized_bucket_all_reduce(grads, axis="dp", bucket_mb: float = 25.0,
                                *, residual=None):
    """int8 gradient sync over :func:`bucket_gradients`' flat buckets:
    each bucket quantised with one absmax scale (:func:`quantize_bucket`),
    the codes and the scale all_gathered (two all_gathers a bucket, ¼ of
    the f32 payload), dequantised, summed in ascending rank order and
    divided by the world size.

    ``residual`` (:func:`init_grad_residual`): the bucket quantises
    ``grad + residual`` and the new residual is what the quantisation
    dropped.  Returns ``(synced grads, new residual or None)``.  Per
    element the sync differs from the exact mean by at most
    ``mean_d(scale_d) / 2``."""
    leaves = [g for _, g in optim.tree_leaves(grads)]
    res_leaves = ([r for _, r in optim.tree_leaves(residual)]
                  if residual is not None else None)
    ws = mesh.axis_size(axis)
    out = list(leaves)
    new_res = list(res_leaves) if residual is not None else None
    for dt, idxs in _dtype_groups(leaves).items():
        flat = torch.cat([leaves[i].reshape(-1).float() for i in idxs])
        if residual is not None:
            flat = flat + torch.cat([res_leaves[i].reshape(-1)
                                     for i in idxs])
        cap = _bucket_cap(bucket_mb, dt)
        red_chunks, err_chunks = [], []
        for s in range(0, flat.numel(), cap):
            c = flat[s:s + cap]
            q, scale = quantize_bucket(c)
            qg = C.all_gather(q, axis).reshape(ws, c.numel())
            sg = C.all_gather(scale.reshape(1), axis)
            red = qg[0].float() * sg[0]
            for d in range(1, ws):
                red = red + qg[d].float() * sg[d]
            red_chunks.append(red / ws)
            if residual is not None:
                # the error exact (f64 holds q · scale and the difference)
                # and rounded once, as a fused multiply-subtract gives it
                err_chunks.append((c.double() - q.double() * scale.double()
                                   ).float())
        red = torch.cat(red_chunks) if len(red_chunks) > 1 else red_chunks[0]
        err = (torch.cat(err_chunks) if len(err_chunks) > 1
               else err_chunks[0]) if residual is not None else None
        off = 0
        for i in idxs:
            n, shape = leaves[i].numel(), leaves[i].shape
            out[i] = red[off:off + n].reshape(shape).to(dt)
            if err is not None:
                new_res[i] = err[off:off + n].reshape(shape)
            off += n
    synced = optim.tree_unflatten(grads, out)
    if residual is None:
        return synced, None
    return synced, optim.tree_unflatten(residual, new_res)


def shard_range(n: int, ws: int, rank: int) -> range:
    """Contiguous per-rank dataset shard, the remainder to the leading
    ranks."""
    base, rem = divmod(n, ws)
    start = rank * base + min(rank, rem)
    return range(start, start + base + (1 if rank < rem else 0))


def make_ddp_train_step(loss_fn: Callable, update_fn: Callable, axis="dp",
                        *, with_barrier: bool = True,
                        bucket_mb: float | None = None,
                        quantize_grads: bool = False,
                        error_feedback: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``.

    ``loss_fn(params, local_batch) -> scalar``; ``update_fn(grads,
    opt_state, params) -> (params, opt_state)`` (``parallel.optim``).
    ``batch`` is the GLOBAL batch; each rank takes its contiguous rows.
    ``with_barrier`` adds the one-element all_reduce step barrier;
    ``bucket_mb`` syncs through :func:`bucket_gradients`;
    ``quantize_grads`` through :func:`quantized_bucket_all_reduce` at
    ``bucket_mb`` (default :data:`DEFAULT_Q8_BUCKET_MB`), and with
    ``error_feedback`` the step takes and returns ``(opt_state,
    residual)``, the residual this rank's (:func:`init_grad_residual`).
    The loss returned is the mean over the ranks."""
    q8_bucket = bucket_mb or DEFAULT_Q8_BUCKET_MB
    ef = quantize_grads and error_feedback

    def step(params, opt_state, batch):
        residual = None
        if ef:
            opt_state, residual = opt_state
        loss, grads = microbatch_value_and_grad(
            loss_fn, params, local_batch(batch, axis), 1)
        if quantize_grads:
            grads, residual = quantized_bucket_all_reduce(
                grads, axis, q8_bucket, residual=residual)
        elif bucket_mb:
            grads = bucket_gradients(grads, axis, bucket_mb)
        else:
            grads = sync_gradients(grads, axis)
        loss = C.all_reduce(loss, axis, mean=True)
        params, opt_state = update_fn(grads, opt_state, params)
        if ef:
            opt_state = (opt_state, residual)
        if with_barrier:
            loss = loss + 0.0 * C.barrier(axis)
        return params, opt_state, loss

    return step
