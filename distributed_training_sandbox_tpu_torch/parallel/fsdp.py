"""Fully-sharded data parallel training of the transformer LM.

Port of the JAX package's ``parallel/fsdp.py`` explicit step
(``make_fsdp_train_step``) over ``torch.distributed``: every parameter
sharded at rest, each rank keeping its contiguous rows of dim 0 (plain
leaves: embedding, final norm) or dim 1 (the stacked ``(L, …)`` layer
leaves); the root leaves gathered up front; each layer's leaves gathered
by the model's ``layer_hook`` inside the checkpointed layer body, so
remat re-gathers them in the backward (``reshard_after_forward=True``,
ZeRO-3), or every layer gathered once and kept (``False``, ZeRO-2).
Gradients need no separate choreography: each gather's backward is a
reduce_scatter, which sums the ranks' contributions into the shards;
the step divides them by the world size and runs Adam on the shards.

``overlap`` (``OVERLAP_MODES``): ``"none"`` gathers each leaf with one
``all_gather``; ``"ring"`` with ``ring_all_gather`` (the same values and
grads from n - 1 hops); the ring_fused modes leave the 2-D projection
weights sharded (``ops.collectives.RingShard``) and run their products
as ``all_gather_matmul`` (``"ring_fused"``) or through K7
(``"ring_fused_pallas"``).  Each rank takes its contiguous rows of the
global batch, as the reference's ``P("dp")`` does.

The precision knobs: ``quantized_gather`` sends every leaf of two or
more dims over the wire as int8 codes and f32 scales
(``ops.quant.quantized_all_gather``; 1-D norm scales stay full
precision), ``quantized_grads`` puts those gathers' backward
reduce_scatter on int8 too (``quantized_reduce_scatter``), and
``state_precision="int8"`` keeps Adam's moments int8 at rest
(``parallel.optim8``, :func:`init_fsdp_opt_state8`).  Not ported:
the optimizer and activation offload (``offload``, A12), sequence
parallelism (A10) and the auto (jit + sharding) variant; they raise.

Without a process group the axis has one rank, every plain gather is
the identity (a quantised one the int8 round-trip) and the step is
value-and-grad of ``lm_loss`` and Adam: the one-card flagship's step
(``train/flagship.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import transformer as T
from ..ops import collectives as C
from ..ops.quant import quantized_all_gather
from ..utils import mesh
from . import optim, optim8

# the ROADMAP.md queue A item that holds each option not ported yet
_ROADMAP_ITEMS = {"offload": "A12 (memory_plan/)",
                  "sp_axis": "A10 (sequence parallelism)"}
OVERLAP_MODES = ("none", "ring", "ring_fused", "ring_fused_pallas")
OFFLOAD_MODES = ("none", "opt", "opt_act")
STATE_PRECISIONS = ("full", "int8")


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _map_with_path(fn, tree: dict, prefix=()):
    return {k: _map_with_path(fn, v, prefix + (k,)) if isinstance(v, dict)
            else fn(prefix + (k,), v) for k, v in tree.items()}


# ------------------------------------------------------------------ layout

def fsdp_specs(params: dict, axis="dp") -> dict:
    """Spec tree (a tuple of axis names or None per dim, as a
    ``PartitionSpec``): dim 0 of plain leaves, dim 1 of stacked
    ``(L, …)`` layer leaves (dim 0 is the layer dim) over ``axis``."""
    name = mesh.resolve_axis(axis).name
    return _map_with_path(
        lambda path, _: (None, name) if "layers" in path else (name,),
        params)


def check_divisibility(params: dict, specs: dict, sizes: dict) -> None:
    """Raise unless every sharded dim divides by its axis size
    (``sizes``: axis name → ranks)."""
    def chk(path, leaf):
        spec = optim.tree_get(specs, path)
        for dim, name in enumerate(spec):
            if name is None:
                continue
            ws = int(sizes[name])
            if leaf.shape[dim] % ws:
                raise ValueError(
                    f"param {_keystr(path)} dim {dim} of size "
                    f"{leaf.shape[dim]} not divisible by mesh axis "
                    f"{name!r}={ws}")
    _map_with_path(chk, params)


def shard_tree(params: dict, rank: int, world: int, axis="dp") -> dict:
    """Rank ``rank``'s shards of ``params`` over a ``world``-rank axis:
    its contiguous chunk of each leaf's sharded dim, as its own
    tensor."""
    specs = fsdp_specs(params, axis)
    check_divisibility(params, specs, {mesh.resolve_axis(axis).name: world})

    def leaf(path, x):
        dim = len(optim.tree_get(specs, path)) - 1
        chunk = x.shape[dim] // world
        return x.narrow(dim, rank * chunk, chunk).clone()
    return _map_with_path(leaf, params)


def shard_params_fsdp(params: dict, axis="dp") -> dict:
    """Full (replicated) params → this rank's shards: the
    ``fully_shard(module)`` moment."""
    return shard_tree(params, mesh.axis_rank(axis), mesh.axis_size(axis),
                      axis)


def init_fsdp_opt_state(params_sharded: dict,
                        state_dtype=None) -> optim.AdamState:
    """Adam state for the shards it tracks: moments in the params'
    dtype unless ``state_dtype`` says otherwise (the reference's bf16
    AdamW state)."""
    return optim.adam_init(params_sharded, state_dtype)


def init_fsdp_opt_state8(params_sharded: dict) -> optim.AdamState:
    """int8-at-rest Adam moments for the shards (``optim8.adam8_init``):
    each rank quantises its own shard, per row along the last dim.  For
    the stacked norm scales, sharded along that dim, each rank's scale
    is its own (ROADMAP.md C6: the reference declares it replicated,
    yet each device holds its own)."""
    return optim8.adam8_init(params_sharded)


# ---------------------------------------------------------------- explicit

def _gather_leaf(x, spec, axis, quantized: bool = False,
                 overlap: str = "none", fuse_matmul=False,
                 quantized_grads: bool = False):
    """Gather a shard back to full size along its sharded dim (no-op for
    leaves ``axis`` does not shard).  ``quantized``: a leaf of two or
    more dims goes over the wire as int8 codes and scales
    (``quantized_all_gather``; 1-D leaves stay full precision, as
    torchao casts only Linear weights), its backward reduce_scatter
    quantised too under ``quantized_grads``.  ``overlap="ring"``:
    through the ring (``C.ring_all_gather``).  ``fuse_matmul``
    (ring_fused modes, layer-hook leaves only; False or the
    chunk-matmul impl name): a 2-D projection weight sharded along its
    contraction dim is NOT gathered but returned as a
    :class:`C.RingShard` for the model's collective matmul."""
    name = mesh.resolve_axis(axis).name
    for dim, n in enumerate(spec):
        if n == name:
            if quantized and x.ndim > 1:
                return quantized_all_gather(x, axis, dim, quantized_grads)
            if fuse_matmul and x.ndim == 2 and dim == 0:
                return C.RingShard(
                    x, axis, "pallas" if fuse_matmul == "pallas" else "xla")
            if overlap in ("ring", "ring_fused", "ring_fused_pallas"):
                return C.ring_all_gather(x, axis, dim)
            return C.all_gather(x, axis, axis=dim)
    return x


def microbatch_value_and_grad(loss_fn, params: dict, batch,
                              accum_steps: int):
    """``(mean loss, mean grads)`` of ``loss_fn(params, batch)`` over
    ``accum_steps`` leading-dim splits of the batch, grads summed and
    divided once at the end, as the reference's scan does."""
    leaves = [p for _, p in optim.tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    try:
        if accum_steps == 1:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), optim.tree_unflatten(params, grads)
        B = batch[0].shape[0]
        if B % accum_steps:
            raise ValueError(
                f"accum_steps={accum_steps} must divide the per-device "
                f"batch {B} (global batch / dp axis size)")
        m = B // accum_steps
        g_sum = [torch.zeros_like(p) for p in leaves]
        l_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum_steps):
            micro = tuple(t[i * m:(i + 1) * m] for t in batch)
            loss = loss_fn(params, micro)
            for acc, g in zip(g_sum, torch.autograd.grad(loss, leaves)):
                acc.add_(g)
            l_sum += loss.detach().float()
        return (l_sum / accum_steps,
                optim.tree_unflatten(params, [g / accum_steps for g in g_sum]))
    finally:
        for p in leaves:
            p.requires_grad_(False)


def local_batch(batch, axis="dp"):
    """This rank's contiguous rows of the global ``batch``."""
    n, r = mesh.axis_size(axis), mesh.axis_rank(axis)
    B = batch[0].shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows is not divisible by mesh axis "
                         f"{mesh.resolve_axis(axis).name!r} size {n}")
    m = B // n
    return tuple(t[r * m:(r + 1) * m] for t in batch)


def make_fsdp_value_and_grad(params_sharded: dict, cfg: T.TransformerConfig,
                             axis="dp", *, reshard_after_forward: bool = True,
                             overlap: str = "none", accum_steps: int = 1,
                             quantized_gather: bool = False,
                             quantized_grads: bool = False):
    """``(shards, global batch) -> (loss, grad shards)``: the loss
    averaged over the ranks (one all_reduce) and the grads of the
    shards, summed over the ranks by the gathers' reduce_scatters and
    divided by the world size — the step before its Adam update."""
    ax = mesh.resolve_axis(axis)
    specs = fsdp_specs(params_sharded, ax)
    layer_specs = specs["layers"]
    # a layer's leaves have lost the layer dim: the sharded dim is 0
    hook_specs = {k: s[1:] for k, s in layer_specs.items()}
    fuse = {"ring_fused": "xla", "ring_fused_pallas": "pallas"}.get(
        overlap, False)

    q, qg = quantized_gather, quantized_grads

    def layer_hook(layer):
        return {k: _gather_leaf(v, hook_specs[k], ax, q, overlap, fuse, qg)
                for k, v in layer.items()}

    def sharded_loss(shards, batch):
        # root leaves gathered up front; never matmul-fused (embed is a
        # lookup table, not a projection operand)
        outer = {k: _gather_leaf(v, specs[k], ax, q, overlap,
                                 quantized_grads=qg)
                 for k, v in shards.items() if k != "layers"}
        if reshard_after_forward:
            return T.lm_loss({**outer, "layers": shards["layers"]}, batch,
                             cfg, layer_hook=layer_hook)
        # ZeRO-2: every layer gathered once, kept through the backward
        full_layers = {k: _gather_leaf(v, layer_specs[k], ax, q, overlap,
                                       quantized_grads=qg)
                       for k, v in shards["layers"].items()}
        return T.lm_loss({**outer, "layers": full_layers}, batch, cfg)

    def value_and_grad(shards, batch):
        ws = mesh.axis_size(ax)
        loss, grads = microbatch_value_and_grad(
            sharded_loss, shards, local_batch(batch, ax), accum_steps)
        loss = C.all_reduce(loss, ax, mean=True)
        if ws > 1:   # the ranks' sum → their mean, in place
            for _, g in optim.tree_leaves(grads):
                g.div_(ws)
        return loss, grads

    return value_and_grad


def make_fsdp_train_step(params_sharded: dict, cfg: T.TransformerConfig,
                         axis="dp", *, reshard_after_forward: bool = True,
                         quantized_gather: bool = False,
                         quantized_grads: bool = False,
                         overlap: str = "none", accum_steps: int = 1,
                         offload: str = "none", sp_axis=None,
                         lr: float = 3e-4,
                         lr_schedule: Callable | None = None,
                         b1: float = 0.9, b2: float = 0.95,
                         eps: float = 1e-8,
                         state_precision: str = "full"):
    """``step(shards, opt_state, batch) -> (shards, opt_state, loss)``
    with ``batch`` = (input_ids, labels), the GLOBAL batch on this
    rank's device; ``axis`` names the data-parallel process group
    (``utils.mesh``).  The options are the reference's; see the module
    docstring.  ``lr_schedule(count)`` is evaluated on the optimiser's
    step counter before the update increments it.  The update runs in
    place: ``optim.adam_update``, or with ``state_precision="int8"``
    ``optim8.adam8_update`` on the state of
    :func:`init_fsdp_opt_state8`."""
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"overlap={overlap!r}; choose from "
                         f"{OVERLAP_MODES}")
    if overlap.startswith("ring_fused"):
        if quantized_gather:
            raise ValueError(f"overlap={overlap!r} fuses full-precision "
                             "collective matmuls; it does not compose "
                             "with quantized_gather (use overlap='ring')")
        if not reshard_after_forward:
            raise ValueError(f"overlap={overlap!r} needs the per-layer "
                             "gather seam — reshard_after_forward=False "
                             "keeps gathered weights live, which "
                             "contradicts fused re-ringing")
        if getattr(cfg, "n_experts", 0):
            raise ValueError(f"overlap={overlap!r} covers dense "
                             "projection leaves only; MoE expert leaves "
                             "shard their expert dim, not a contraction "
                             "dim (use overlap='ring')")
    if quantized_grads and not quantized_gather:
        raise ValueError("quantized_grads quantizes the backward "
                         "reduce-scatter of the quantized gathers; it "
                         "requires quantized_gather=True")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if offload not in OFFLOAD_MODES:
        raise ValueError(f"offload={offload!r}; choose from {OFFLOAD_MODES}")
    if state_precision not in STATE_PRECISIONS:
        raise ValueError(f"state_precision={state_precision!r}; choose "
                         f"from {STATE_PRECISIONS}")
    for name, value, default in (("offload", offload, "none"),
                                 ("sp_axis", sp_axis, None)):
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r}: not ported yet — see ROADMAP.md, queue "
                f"A item {_ROADMAP_ITEMS[name]}")
    T.check_supported(cfg)
    value_and_grad = make_fsdp_value_and_grad(
        params_sharded, cfg, axis, reshard_after_forward=reshard_after_forward,
        overlap=overlap, accum_steps=accum_steps,
        quantized_gather=quantized_gather, quantized_grads=quantized_grads)
    update = (optim8.adam8_update if state_precision == "int8"
              else optim.adam_update)

    def step(shards, opt_state, batch):
        loss, grads = value_and_grad(shards, batch)
        lr_t = lr_schedule(opt_state.count) if lr_schedule else lr
        shards, opt_state = update(grads, opt_state, shards, lr=lr_t, b1=b1,
                                   b2=b2, eps=eps)
        return shards, opt_state, loss

    return step
