"""Parameter bridge between the JAX reference and the port.

The port keeps the reference's parameter tree (same leaf paths, stacked
``(L, …)`` layer tensors, ``(in, out)`` projection layout), so crossing
over is one array copy per leaf.  The JAX side is handed over as numpy
arrays (``jax.tree.map(np.asarray, params)``): this module never
imports JAX.  bf16 leaves arrive as numpy arrays of ``ml_dtypes``'
bfloat16, which numpy cannot hand to torch directly; they cross as
their raw 16-bit patterns, so the copy is exact either way.

The toy MLP's params (a list of ``{"w", "b"}`` dicts) cross leaf for
leaf in their own dtype (:func:`mlp_params_from_jax`, back through
:func:`params_to_numpy`).  ZeRO's flat chunks are pure data movement:
:func:`zero_chunks_from_jax` cuts one rank's chunks from the full
params, and :func:`assemble_zero_chunks` concatenates every rank's in
rank order into the padded flat leaves that ``np.asarray`` makes of the
reference's ``shard_params_zero3`` output.  DDP's error-feedback
residual is stacked on a leading rank axis in the reference and one
tree a rank in the port (:func:`residual_from_jax`,
:func:`stack_residuals`).

FSDP shards cross the same way: :func:`shards_from_jax` carries the
reference's full parameters into one rank's shards (the rows
``parallel.fsdp.shard_params_fsdp`` keeps), and :func:`assemble_shards`
concatenates every rank's shards, in rank order, back into the full
tree.

Tensor-parallel shards cross the same way: :func:`tp_shards_from_jax`
cuts one tp rank's Megatron shards (``parallel.tensor.tp_specs``) from
the reference's full parameters, and :func:`assemble_tp_shards` puts the
tp ranks' shards back together; sequence parallelism keeps the FSDP
shards (:func:`shards_from_jax`).

MoE params cross leaf for leaf as well (the router ``(L, H, E)``, the
expert banks ``(L, E, H, F)`` and ``(L, E, F, H)``); one rank of a dp ×
ep layout keeps its ``E / ep`` slice of each bank
(:func:`moe_shards_from_jax`, back through :func:`assemble_moe_shards`),
and the toy layer's ``MoEParams`` cross field for field
(:func:`moe_params_from_jax`).

The classifier's tree crosses as its trunk and its head
(:func:`classifier_params_from_jax`, :func:`classifier_params_to_numpy`).

A pipeline's stages cross one by one: :func:`pipeline_stages_to_numpy`
gives each stage's params and Adam state as numpy trees in the
reference's layout (the MLP stages' lists of ``{"w", "b"}``, the
transformer stages' dicts), and :func:`load_pipeline_stages` writes a
JAX pipeline's per-stage state into the port's stages in place.

int8 decode params (``quantize_decode_params`` on either side) hold
``QuantizedWeight`` leaves, a NamedTuple ``(q, s)`` in both packages:
they cross field for field, ``q`` as int8 and ``s`` as f32, whatever
``cfg.dtype`` is, and ``unembed_q`` with them.  int8 Adam moments
(``parallel.optim8``) hold ``Q8`` leaves, a NamedTuple ``(q, scale)``
in both packages, and cross the same way (:func:`adam_state_from_jax`,
:func:`adam_state_to_numpy`, the pipeline's per-stage state).  One
rank's FSDP state is one device's buffers of the reference's: read each
leaf of the JAX state from that device's ``addressable_shards``, never
through ``np.asarray``, which returns device 0's copy of a "replicated"
leaf.  That matters for the scales of the leaves sharded along their
last dim (ROADMAP.md C6), which differ from device to device;
:func:`assemble_shards` keeps those one a rank, stacked.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.quant import QuantizedWeight
from .parallel.optim import AdamState, tree_leaves, tree_map, tree_unflatten
from .parallel.optim8 import Q8


def _to_torch(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(a)   # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: a CPU tensor's ``numpy()`` shares its storage, which the
    in-place optimisers go on writing."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only callers that hold JAX arrays need this
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _is_quantized(leaf) -> bool:
    """A ``QuantizedWeight`` of either package (a NamedTuple (q, s))."""
    return getattr(leaf, "_fields", None) == ("q", "s")


def _is_q8(leaf) -> bool:
    """An int8 moment of either package (a NamedTuple (q, scale))."""
    return getattr(leaf, "_fields", None) == ("q", "scale")


def params_from_jax(np_tree: dict, cfg, device=None) -> dict:
    """Reference params (a dict tree of numpy arrays, ``QuantizedWeight``
    leaves holding numpy arrays) → the port's params on ``device``
    (default: CPU), leaf for leaf: float leaves in ``cfg.dtype``, a
    quantised weight as int8 codes and f32 scales."""
    def leaf(a):
        if _is_quantized(a):
            return QuantizedWeight(_to_torch(a.q, torch.int8, device),
                                   _to_torch(a.s, torch.float32, device))
        if _is_q8(a):
            return Q8(_to_torch(a.q, torch.int8, device),
                      _to_torch(a.scale, torch.float32, device))
        return _to_torch(a, cfg.dtype, device)
    return tree_map(leaf, np_tree)


def params_to_numpy(params: dict) -> dict:
    """The inverse: the port's params → a dict tree of numpy arrays in
    the reference's layout (``jax.numpy.asarray`` takes each leaf; a
    ``QuantizedWeight`` comes back as one holding numpy arrays)."""
    def leaf(t):
        if _is_quantized(t):
            return QuantizedWeight(_to_numpy(t.q), _to_numpy(t.s))
        if _is_q8(t):
            return Q8(_to_numpy(t.q), _to_numpy(t.scale))
        return _to_numpy(t)
    return tree_map(leaf, params)


def classifier_params_from_jax(np_tree: dict, cfg, device=None) -> dict:
    """The reference's classifier tree (``models/classifier.py``:
    ``{"trunk": <LM tree>, "cls_head": (H, num_labels)}``) → the port's:
    the trunk through :func:`params_from_jax`, the head one leaf in
    ``cfg.dtype``."""
    return {"trunk": params_from_jax(np_tree["trunk"], cfg, device),
            "cls_head": _to_torch(np_tree["cls_head"], cfg.dtype, device)}


def classifier_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`classifier_params_from_jax`."""
    return {"trunk": params_to_numpy(params["trunk"]),
            "cls_head": _to_numpy(params["cls_head"])}


def adam_state_from_jax(mu: dict, nu: dict, count: int, cfg, device=None):
    """The reference's ``AdamState`` (its ``mu`` and ``nu`` as dict
    trees of numpy arrays, its ``count`` as an int) → the port's
    ``parallel.optim.AdamState``, moments in ``cfg.dtype``; ``Q8``
    moments (``optim8``) as int8 codes and f32 scales."""
    return AdamState(mu=params_from_jax(mu, cfg, device),
                     nu=params_from_jax(nu, cfg, device), count=int(count))


def adam_state_to_numpy(state) -> tuple[dict, dict, int]:
    """The inverse: ``(mu, nu, count)`` with numpy trees in the
    reference's layout."""
    return params_to_numpy(state.mu), params_to_numpy(state.nu), \
        int(state.count)


def shards_from_jax(np_tree: dict, cfg, rank: int, world: int) -> dict:
    """Reference params (a dict tree of numpy arrays, full size) → rank
    ``rank``'s FSDP shards over a ``world``-rank axis, on the CPU, in
    ``cfg.dtype``."""
    from .parallel.fsdp import shard_tree
    return shard_tree(params_from_jax(np_tree, cfg), rank, world)


def assemble_shards(rank_trees: list) -> dict:
    """Every rank's shards as numpy trees, in rank order → the full
    numpy tree (dim 0 of plain leaves, dim 1 of stacked layer leaves
    concatenated, as ``fsdp_specs`` shards them).  A ``Q8`` leaf (int8
    moments) concatenates its codes so, and its scales too unless the
    sharded dim is the last: those are one a rank (ROADMAP.md C6), and
    come back stacked on a new leading rank axis."""
    from .parallel.fsdp import fsdp_specs
    specs = fsdp_specs(rank_trees[0])

    def cat(leaves, dim):
        return np.concatenate([np.asarray(t) for t in leaves], axis=dim)

    def walk(spec, leaves):
        if isinstance(spec, dict):
            return {k: walk(spec[k], [t[k] for t in leaves]) for k in spec}
        dim = len(spec) - 1
        if _is_q8(leaves[0]):
            scales = [np.asarray(t.scale) for t in leaves]
            last = dim == scales[0].ndim - 1
            return Q8(cat([t.q for t in leaves], dim),
                      np.stack(scales) if last else cat(scales, dim))
        return cat(leaves, dim)
    return walk(specs, rank_trees)


def tp_shards_from_jax(np_tree: dict, cfg, rank: int, tp: int) -> dict:
    """Reference params (numpy, full size) → tp rank ``rank``'s Megatron
    shards over a ``tp``-rank axis, on the CPU, in ``cfg.dtype``."""
    from .parallel.tensor import shard_tree_tp
    return shard_tree_tp(params_from_jax(np_tree, cfg), rank, tp)


def assemble_tp_shards(rank_trees: list) -> dict:
    """The tp ranks' shards (numpy trees, in tp order) → the full numpy
    tree: each sharded leaf concatenated along its ``tp_specs`` dim,
    every replicated leaf rank 0's."""
    from .parallel.tensor import tp_specs
    specs = tp_specs(rank_trees[0])

    def walk(spec, leaves):
        if isinstance(spec, dict):
            return {k: walk(spec[k], [t[k] for t in leaves]) for k in spec}
        if spec:
            return np.concatenate([np.asarray(t) for t in leaves],
                                  axis=spec.index("tp"))
        return np.asarray(leaves[0])
    return walk(specs, rank_trees)


def moe_shards_from_jax(np_tree: dict, cfg, ep_rank: int, ep: int) -> dict:
    """Reference MoE params (numpy, full size) → the params of a rank at
    ``ep_rank`` on a ``ep``-rank expert axis: its ``E / ep`` slice of
    each expert bank, every other leaf whole, on the CPU, in
    ``cfg.dtype``."""
    from .parallel.expert import shard_moe_lm_params
    return shard_moe_lm_params(params_from_jax(np_tree, cfg), "ep", ep_rank,
                               ep)


def assemble_moe_shards(rank_trees: list) -> dict:
    """The ranks of one dp row (one ep group), in ep order, as numpy
    trees → the full numpy tree: the expert banks concatenated along E,
    every other leaf rank 0's."""
    from .parallel.expert import moe_lm_specs
    specs = moe_lm_specs(rank_trees[0])

    def walk(spec, leaves):
        if isinstance(spec, dict):
            return {k: walk(spec[k], [t[k] for t in leaves]) for k in spec}
        if spec:
            return np.concatenate([np.asarray(t) for t in leaves],
                                  axis=spec.index("ep"))
        return np.asarray(leaves[0])
    return walk(specs, rank_trees)


def moe_params_from_jax(np_params, device=None):
    """The reference's toy ``MoEParams`` (numpy fields) → the port's,
    each field in its own dtype."""
    from .parallel.expert import MoEParams
    return MoEParams(*(_to_torch(a, None, device) for a in np_params))


def mlp_params_from_jax(np_tree, device=None):
    """A reference MLP tree (a list of ``{"w", "b"}`` dicts of numpy
    arrays, or any tree of them: chunks, residuals) → the port's, each
    leaf in its own dtype, on ``device`` (default: CPU)."""
    return tree_map(lambda a: _to_torch(a, None, device), np_tree)


def zero_chunks_from_jax(np_tree, rank: int, world: int, device=None):
    """Full reference params (numpy) → rank ``rank``'s flat ZeRO chunks
    over a ``world``-rank axis (``parallel.zero.chunk_of``)."""
    from .parallel.zero import chunk_of
    return tree_map(lambda t: chunk_of(t, rank, world),
                    mlp_params_from_jax(np_tree, device))


def _join(rank_trees: list, fn):
    """``fn`` of the rank-ordered list of each leaf across ``rank_trees``
    (trees of one structure), rebuilt as that structure."""
    columns = zip(*([x for _, x in tree_leaves(t)] for t in rank_trees))
    return tree_unflatten(rank_trees[0], [fn([np.asarray(x) for x in c])
                                          for c in columns])


def assemble_zero_chunks(rank_trees: list):
    """Every rank's chunk tree (numpy), in rank order → the padded flat
    leaves, as ``np.asarray`` gives the reference's chunk arrays."""
    return _join(rank_trees, np.concatenate)


def residual_from_jax(np_stacked, rank: int, device=None):
    """A tree stacked on a leading rank axis, as the reference keeps the
    error-feedback residual (or any per-device tree) → rank ``rank``'s
    own tree."""
    return tree_map(lambda a: _to_torch(np.asarray(a)[rank], None, device),
                    np_stacked)


def stack_residuals(rank_trees: list):
    """Every rank's tree (numpy), in rank order → the reference's
    stacked layout."""
    return _join(rank_trees, np.stack)


def pipeline_stages_to_numpy(stages) -> list[dict]:
    """Each stage of a port pipeline (``parallel.pipeline``) as
    ``{"params", "mu", "nu", "count"}``: numpy trees in the reference's
    layout (an ``opt8`` stage's moments with ``Q8`` leaves) and the Adam
    step count."""
    return [{"params": params_to_numpy(s.params),
             "mu": params_to_numpy(s.opt_state.mu),
             "nu": params_to_numpy(s.opt_state.nu),
             "count": int(s.opt_state.count)} for s in stages]


def load_pipeline_stages(stages, np_states: list[dict]) -> None:
    """Write a JAX pipeline's per-stage state into the port's stages of
    the same split, in place: ``np_states[s]`` holds stage s's
    ``"params"`` and, optionally, its Adam ``"mu"``, ``"nu"`` and
    ``"count"`` (numpy trees, as ``np.asarray`` gives the reference's
    ``stage.params`` and ``stage.opt_state``); each leaf is copied in the
    port leaf's dtype, a ``Q8`` moment (an ``opt8`` stage) field by
    field."""
    for stage, st in zip(stages, np_states, strict=True):
        with torch.no_grad():
            for key, tree in (("params", stage.params),
                              ("mu", stage.opt_state.mu),
                              ("nu", stage.opt_state.nu)):
                if key not in st:
                    continue
                for path, t in tree_leaves(tree):
                    a = st[key]
                    for k in path:
                        a = a[k]
                    pairs = zip(t, a) if _is_q8(t) else ((t, a),)
                    for dst, src in pairs:
                        dst.copy_(_to_torch(src, dst.dtype, dst.device))
        if "count" in st:
            stage.opt_state = stage.opt_state._replace(count=int(st["count"]))
