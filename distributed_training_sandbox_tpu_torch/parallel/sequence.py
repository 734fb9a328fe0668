"""Sequence parallelism: FSDP over ``dp`` × ring attention over ``sp``.

Port of the JAX package's ``parallel/sequence.py``.  The batch's rows
shard over ``dp`` and its sequence over ``sp``; params are FSDP shards
over ``dp``, replicated over ``sp``.  Everything but attention is
token-local; attention is the K/V ring (``ops/ring_attention.py``), and
RoPE sees each rank's global positions (``models.transformer``).  The
backward: the dp gathers' reduce_scatters, the ring hops' reverse hops,
and one all_reduce over ``sp`` a leaf for the sp-replicated grads.  The
step is ``fsdp.make_fsdp_train_step`` with ``sp_axis`` (one
choreography, every FSDP knob); this module is its sequence-parallel
surface, with the zigzag layout's data shuffle.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import transformer as T
from .fsdp import make_fsdp_train_step


def sp_config(cfg: T.TransformerConfig, sp_axis="sp",
              layout: str = "contiguous") -> T.TransformerConfig:
    """The config switched to ring attention over ``sp_axis``;
    ``layout="zigzag"`` takes the balanced stripes (feed batches through
    :func:`zigzag_shuffle`)."""
    return dataclasses.replace(cfg, attention_impl="ring", sp_axis=sp_axis,
                               ring_layout=layout)


def _zigzag_perm(n_dev: int) -> np.ndarray:
    """Stripe order giving rank r stripes (r, 2D − 1 − r) under
    contiguous equal sharding: [0, 2D − 1, 1, 2D − 2, ...]."""
    return np.array([s for r in range(n_dev)
                     for s in (r, 2 * n_dev - 1 - r)])


def _stripes(x: torch.Tensor, n_dev: int, axis: int, order) -> torch.Tensor:
    S = x.shape[axis]
    if S % (2 * n_dev):
        raise ValueError(f"sequence length {S} must divide into "
                         f"2·{n_dev} zigzag stripes")
    w = S // (2 * n_dev)
    axis %= x.ndim
    stripes = x.reshape(*x.shape[:axis], 2 * n_dev, w, *x.shape[axis + 1:])
    idx = torch.as_tensor(order, device=x.device)
    return stripes.index_select(axis, idx).reshape(x.shape)


def zigzag_shuffle(x: torch.Tensor, n_dev: int, axis: int = 1
                   ) -> torch.Tensor:
    """Reorder a GLOBAL sequence dim into zigzag stripe order, so that
    contiguous equal sharding lands stripes (r, 2D − 1 − r) on rank r.
    Shuffle input_ids and labels alike: a token-mean loss does not
    change."""
    return _stripes(x, n_dev, axis, _zigzag_perm(n_dev))


def zigzag_unshuffle(x: torch.Tensor, n_dev: int, axis: int = 1
                     ) -> torch.Tensor:
    """The inverse of :func:`zigzag_shuffle`."""
    return _stripes(x, n_dev, axis, np.argsort(_zigzag_perm(n_dev)))


def make_sp_train_step(params_sharded: dict, cfg: T.TransformerConfig, *,
                       dp_axis="dp", sp_axis="sp", **kwargs):
    """The FSDP × SP step: ``step(shards, opt_state, batch) -> (shards,
    opt_state, loss)``, ``batch`` = (input_ids, labels), the GLOBAL (B,
    S) batch; each rank takes its dp rows and its sp chunk.
    ``params_sharded``: ``fsdp.shard_params_fsdp`` over ``dp_axis``.
    Takes every ``make_fsdp_train_step`` option."""
    return make_fsdp_train_step(params_sharded, cfg, dp_axis,
                                sp_axis=sp_axis, **kwargs)
