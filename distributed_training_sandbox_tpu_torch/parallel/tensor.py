"""Tensor parallelism: Megatron-sharded decoder layers over a ``tp``
axis, data parallel over ``dp`` and, with ``sp_axis``, the sequence
over ``sp`` too.

Port of the JAX package's ``parallel/tensor.py``.  Layout over ``tp``
(the column-then-row pairing):

* attention: wq, wk, wv shard their output dim, so each rank owns
  ``nq/tp`` query heads and ``nkv/tp`` KV heads (GQA groups intact,
  since both divide); wo shards its input dim, so each rank's product
  is a partial sum, rejoined over ``tp`` into the residual stream;
* MLP: w_gate, w_up shard the intermediate dim, w_down its input dim:
  one rejoin; an MoE layer's expert banks ``(L, E, …)`` split the same
  way inside each expert (the router replicated);
* norms, embedding, unembedding: replicated.

Two rejoins a layer (``models.transformer._layer_body`` with
``tp_axis``), each an ``all_reduce``, or with ``overlap="ring"`` a
``decomposed_all_reduce`` and with ``overlap="q8"`` the two-shot int8
all-reduce.  Specs are tuples of axis names or None a dim, as
``parallel.fsdp``'s.  An axis is a ``utils.mesh.Axis`` of one grid
(``utils.mesh.grid_axes``), so a leaf's grads sum over every axis it is
replicated on in one all_reduce (``utils.mesh.span``).
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable

import torch
from torch.profiler import record_function

from ..models import transformer as T
from ..ops import collectives as C
from ..utils import mesh
from . import optim
from .fsdp import microbatch_value_and_grad

COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
ROW = ("wo", "w_down")


def check_tp_divisibility(cfg: T.TransformerConfig, tp: int) -> None:
    """Raise unless ``tp`` divides the head counts and the MLP's hidden
    width (the experts' ``moe_ffn`` for an MoE config)."""
    dims = [("num_attention_heads", cfg.num_attention_heads),
            ("num_key_value_heads", cfg.num_key_value_heads)]
    if cfg.n_experts and cfg.moe_ffn:
        dims.append(("moe_ffn", cfg.moe_ffn))
    else:   # dense MLP, or experts defaulting to intermediate_size
        dims.append(("intermediate_size", cfg.intermediate_size))
    bad = [(n, v) for n, v in dims if v % tp]
    if bad:
        raise ValueError(f"tp={tp} must divide " + ", ".join(
            f"{n}={v}" for n, v in bad))


def _leaf_spec(key, ndim: int, name: str) -> tuple:
    if key in COLUMN:
        return (None,) * (ndim - 1) + (name,)
    if key in ROW:
        return (None,) * (ndim - 2) + (name, None)
    return ()


def tp_specs(params: dict, axis="tp") -> dict:
    """Spec tree of the Megatron layout: the stacked dense leaves (L,
    in, out) shard dim 2 (column) or dim 1 (row), the expert banks (L,
    E, in, out) one dim later; every other leaf is replicated."""
    name = mesh.resolve_axis(axis).name

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _leaf_spec(key, tree.ndim, name)
    return walk(params)


def shard_tree_tp(params: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s Megatron shards over a ``world``-rank axis: its
    contiguous chunk of each sharded dim, as its own tensor."""
    specs = tp_specs(params)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if not spec:
            return tree.clone()
        dim = spec.index("tp")
        if tree.shape[dim] % world:
            raise ValueError(f"dim {dim} of size {tree.shape[dim]} not "
                             f"divisible by tp={world}")
        chunk = tree.shape[dim] // world
        return tree.narrow(dim, rank * chunk, chunk).clone()
    return walk(params, specs)


def shard_params_tp(params: dict, axis="tp") -> dict:
    """Full (replicated) params → this rank's Megatron shards."""
    return shard_tree_tp(params, mesh.axis_rank(axis), mesh.axis_size(axis))


def tp_lm_loss(params: dict, batch, cfg: T.TransformerConfig, *,
               axis="tp", overlap: str = "none") -> torch.Tensor:
    """The causal-LM loss with Megatron layers: ``lm_loss`` with the
    shared layer body run on this rank's shards (``_layer_body`` with
    ``tp_axis``) through the ``layer_body`` seam, so the scaffold and
    the layer math exist once.  The embedding, norms and loss are
    replicated and equal on every tp rank.  With ``cfg.sp_axis`` (ring
    attention) the K/V ring runs over ``sp`` within each tp group,
    carrying the local heads only.  ``overlap``: the rejoins' form
    (``"none"``, ``"ring"``, ``"q8"``)."""
    return T.lm_loss(params, batch, cfg, layer_body=functools.partial(
        T._layer_body, tp_axis=axis, tp_overlap=overlap))


def make_tp_train_step(params_sharded: dict, cfg: T.TransformerConfig, *,
                       dp_axis="dp", tp_axis="tp", sp_axis=None,
                       overlap: str = "none", accum_steps: int = 1,
                       lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                       eps: float = 1e-8, loss_fn: Callable | None = None):
    """``step(shards, opt_state, batch) -> (shards, opt_state, loss)``
    over dp × tp, ``batch`` = (input_ids, labels), the GLOBAL batch: each
    rank takes its dp rows (the tp ranks of a row share them), and with
    ``sp_axis`` its sequence chunk too, which makes this the dp × sp ×
    tp step (ring attention over ``sp`` on the local heads).  Params are
    this rank's ``tp_specs`` shards, replicated over dp (and sp).

    ``overlap``: the rejoins as ``all_reduce`` (``"none"``),
    ``decomposed_all_reduce`` (``"ring"``) or the two-shot int8
    all-reduce (``"q8"``), for the default ``tp_lm_loss`` only.
    ``accum_steps``: microbatches of the rank's rows
    (``fsdp.microbatch_value_and_grad``).  ``loss_fn(params, batch,
    cfg)`` replaces the loss; one that declares ``axis`` gets
    ``tp_axis``.  The loss is the mean over every axis (one all_reduce);
    each leaf's grads are summed over every axis it is replicated on
    (one all_reduce) and divided by the grid's ranks; Adam runs in
    place."""
    ws_dp, ws_tp = mesh.axis_size(dp_axis), mesh.axis_size(tp_axis)
    check_tp_divisibility(cfg, ws_tp)
    if overlap not in T.TP_OVERLAPS:
        raise ValueError(f"overlap={overlap!r}; the tp step supports "
                         f"'none', 'ring' or 'q8'")
    if overlap != "none" and loss_fn is not None:
        raise ValueError(f"overlap={overlap!r} rewires tp_lm_loss's "
                         "rejoin psums; a custom loss_fn owns its own "
                         "collectives — rewire them there instead")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if sp_axis is None and cfg.sp_axis is not None:
        name = T._axis_name(cfg.sp_axis)
        raise ValueError(
            f"cfg.sp_axis={name!r} (ring attention) but make_tp_train_step "
            f"got sp_axis=None — the batch would replicate over {name!r} "
            f"and sp grads would never sync.  Pass sp_axis (the step sets "
            f"the ring config itself).")
    T.check_supported(cfg)
    n_total = ws_dp * ws_tp
    rep_axes = [dp_axis]
    if sp_axis is not None:
        cfg = dataclasses.replace(cfg, attention_impl="ring",
                                  sp_axis=sp_axis)
        n_total *= mesh.axis_size(sp_axis)
        rep_axes.append(sp_axis)
    if loss_fn is None:
        def base_loss(p, b, c):
            return tp_lm_loss(p, b, c, axis=tp_axis, overlap=overlap)
    elif "axis" in inspect.signature(loss_fn).parameters:
        def base_loss(p, b, c):
            return loss_fn(p, b, c, axis=tp_axis)
    else:
        base_loss = loss_fn
    specs = tp_specs(params_sharded, tp_axis)
    tp_name = mesh.resolve_axis(tp_axis).name
    everything = mesh.span(*rep_axes, tp_axis)
    replicated = mesh.span(*rep_axes)

    def local_batch(batch):
        rows = mesh.shard_rows(batch, dp_axis)
        return rows if sp_axis is None else mesh.shard_seq(rows, sp_axis)

    def step(shards, opt_state, batch):
        with record_function("forward_backward"):
            loss, grads = microbatch_value_and_grad(
                lambda p, b: base_loss(p, b, cfg), shards,
                local_batch(batch), accum_steps)
        with record_function("loss_mean"):
            loss = C.all_reduce(loss, everything, mean=True)
        with record_function("grad_sync"):
            # the copies summed over every axis the leaf is replicated
            # on, then normalised by the grid's ranks: grads of the
            # global-mean loss
            synced = [C.all_reduce(g, replicated if tp_name in
                                   optim.tree_get(specs, path)
                                   else everything) / n_total
                      for path, g in optim.tree_leaves(grads)]
            grads = optim.tree_unflatten(grads, synced)
        with record_function("opt_step"):
            shards, opt_state = optim.adam_update(
                grads, opt_state, shards, lr=lr, b1=b1, b2=b2, eps=eps)
        return shards, opt_state, loss

    return step
