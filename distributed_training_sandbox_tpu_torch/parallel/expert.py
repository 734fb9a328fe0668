"""Expert parallelism: the switch-MoE MLP with ``all_to_all`` dispatch.

Port of the JAX package's ``parallel/expert.py``, in its order: the
grouped dispatch's helpers (``_resolve_group``, ``_grouped_caps``,
``_group_slot_positions``, ``grouped_drop_fraction``), the router
(``_route_topk``, ``router_z_loss``), ``moe_mlp`` with its three
dispatches, the toy layer (``MoEParams``, ``init_moe_params``,
``moe_specs``, ``moe_layer``, ``moe_reference``), the MoE transformer's
sharding rule (``moe_lm_specs``) and the two train steps
(``make_moe_lm_train_step`` over dp × ep, ``make_ep_train_step`` on
the toy regression over ep).

Experts shard over the ``ep`` axis (a name or a ``utils.mesh.Axis``):
rank d owns experts ``[d·E/ep, (d+1)·E/ep)``.  Every rank routes its own
tokens into per-expert buckets of fixed capacity, one ``all_to_all``
moves the buckets to their experts' owners, a second brings the outputs
back (``ops.collectives.all_to_all``, whose backward is the inverse
all_to_all, the transpose ``lax.all_to_all`` gets under ``shard_map``).
The Switch load-balance aux loss averages its two statistics over the
ep group with ``all_reduce`` (whose backward is an ``all_reduce``, as
the reference's ``psum`` transposes under ``check_vma=False``).

Where the port differs in form, not in value:

  * top-k: ``lax.top_k`` takes the lower expert index first among equal
    probabilities; ``torch.topk`` promises no order among ties, so
    :func:`_topk_lowest_index` picks by repeated max, the lowest index
    among equal values (real at bf16 router logits);
  * the dispatch and combine keep the reference's one-hot products
    (``torch.einsum``): each output has at most one nonzero term, so
    they move data exactly in any dtype;
  * the per-expert products run one expert at a time through
    ``ops.quant.resolve_quantized_dense`` (the reference vmaps it over
    the expert dim), so each expert's int8 and fp8 scales are its own;
    at ``"bf16"`` one batched ``torch.matmul`` does them, as the
    reference's vmap of a plain matmul does.

``record_function`` ranges carry the reference's scope names
(``moe_route``, ``moe_dispatch``, ``moe_a2a_out``, ``moe_expert_mlp``,
``moe_a2a_back``, ``moe_combine``, ``moe_aux_loss``), so a
``torch.profiler`` trace splits the dispatch from the experts.  The
MoE transformer's step runs over dp × ep, or with ``sp_axis`` over dp ×
sp × ep (ring attention over the sequence chunks).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops import collectives as C
from ..ops.quant import resolve_quantized_dense
from ..utils import mesh
from . import optim

__all__ = ["MoEParams", "init_moe_params", "moe_specs", "shard_moe_params",
           "grouped_drop_fraction", "router_z_loss", "moe_mlp", "moe_layer",
           "moe_reference", "moe_lm_specs", "shard_moe_lm_params",
           "make_moe_lm_train_step", "make_ep_train_step", "EXPERT_LEAVES"]

# the stacked (L, E, …) leaves of the MoE transformer that shard on E
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


class MoEParams(NamedTuple):
    """The toy layer's params: router replicated, experts ep-sharded on
    dim 0 (a rank holds ``E_local`` of them)."""
    w_router: torch.Tensor   # (H, E)
    w_gate: torch.Tensor     # (E_local, H, F)
    w_up: torch.Tensor       # (E_local, H, F)
    w_down: torch.Tensor     # (E_local, F, H)


def init_moe_params(generator: torch.Generator, *, hidden: int, ffn: int,
                    n_experts: int, dtype=torch.float32,
                    device=None) -> MoEParams:
    """Full (unsharded) init, normal at ``hidden^-½`` (``ffn^-½`` for
    ``w_down``), drawn on ``generator``'s device; shard with
    :func:`shard_moe_params`.  The stream differs from
    ``jax.random``'s; parity tests bridge the reference's weights."""
    gdev = generator.device

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=gdev) * std
        return t.to(device=device or gdev, dtype=dtype)

    s_in, s_ff = hidden ** -0.5, ffn ** -0.5
    return MoEParams(
        w_router=normal((hidden, n_experts), s_in),
        w_gate=normal((n_experts, hidden, ffn), s_in),
        w_up=normal((n_experts, hidden, ffn), s_in),
        w_down=normal((n_experts, ffn, hidden), s_ff))


def moe_specs(axis="ep") -> MoEParams:
    """Spec per leaf (a tuple of axis names or None per dim, as a
    ``PartitionSpec``): the router replicated, the experts on dim 0."""
    name = mesh.resolve_axis(axis).name
    return MoEParams(w_router=(), w_gate=(name,), w_up=(name,),
                     w_down=(name,))


def _take_shard(x: torch.Tensor, spec: tuple, name: str, rank: int,
                world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous chunk of ``x`` along the dim ``spec``
    gives ``name`` (a copy; ``x`` itself when ``spec`` does not)."""
    if name not in spec:
        return x
    dim = spec.index(name)
    if x.shape[dim] % world:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible "
                         f"by mesh axis {name!r}={world}")
    chunk = x.shape[dim] // world
    return x.narrow(dim, rank * chunk, chunk).clone()


def shard_moe_params(params: MoEParams, axis="ep", rank: int | None = None,
                     world: int | None = None) -> MoEParams:
    """This rank's (or ``rank``'s of ``world``) toy params: its
    ``E / ep`` experts, the router whole."""
    name = mesh.resolve_axis(axis).name
    rank = mesh.axis_rank(axis) if rank is None else rank
    world = mesh.axis_size(axis) if world is None else world
    return MoEParams(*(_take_shard(p, s, name, rank, world)
                       for p, s in zip(params, moe_specs(axis))))


# --------------------------------------------------- grouped-dispatch helpers

def _resolve_group(n_tokens: int, group_size: int) -> int:
    """Largest divisor of ``n_tokens`` that is <= ``group_size``: the
    grouped dispatch must tile the local chunk exactly, so an awkward
    token count shrinks the group rather than raising."""
    g = min(group_size, n_tokens)
    while n_tokens % g:
        g -= 1
    return g


def _grouped_caps(n_tokens: int, group_size: int, capacity_factor: float,
                  n_experts: int) -> tuple[int, int, int]:
    """(G, NG, capg) of the grouped dispatch: the one place its group
    and per-group capacity rule (``capg = ceil(cf · G / E)``) lives."""
    G = _resolve_group(n_tokens, group_size)
    capg = int(-(-G * capacity_factor // n_experts))
    return G, n_tokens // G, capg


def _group_slot_positions(eg: torch.Tensor, n_experts: int):
    """Per-(group, expert) bucket position of each assignment: ``onehot``
    (NG, A, E) int32 and ``pos`` (NG, A, E), -1 off the assignment's
    expert; shared by the dispatch and its drop-rate report."""
    onehot = F.one_hot(eg.long(), n_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot - 1
    return onehot, pos


def grouped_drop_fraction(expert: torch.Tensor, n_experts: int,
                          group_size: int, capacity_factor: float
                          ) -> torch.Tensor:
    """Fraction of (token, assignment) pairs the grouped dispatch drops,
    with the same helpers as ``moe_mlp``'s ``"grouped"`` branch.
    ``expert``: (N,) top-1 assignments or (N, k) top-k (choice-major
    priority, capacity ``cf · k · G / E``, the dispatch's rule)."""
    if expert.ndim == 1:
        expert = expert[:, None]
    N, k = expert.shape
    G, NG, capg = _grouped_caps(N, group_size, capacity_factor * k,
                                n_experts)
    eg = expert.reshape(NG, G, k).transpose(1, 2).reshape(NG, k * G)
    _, pos = _group_slot_positions(eg, n_experts)
    return torch.mean((pos.amax(dim=-1) >= capg).float())


# ------------------------------------------------------------------ router

def _topk_lowest_index(probs: torch.Tensor, k: int):
    """``lax.top_k`` of the rows of ``probs``: the k largest values in
    descending order, the lowest index first among equal values, and
    their indices (int64).  The values are gathered from ``probs``, so
    they carry its gradient."""
    E = probs.shape[-1]
    col = torch.arange(E, device=probs.device)
    work = probs.detach()
    picks = []
    for _ in range(k):
        top = work.amax(dim=-1, keepdim=True)
        e = torch.where(work == top, col, E).amin(dim=-1)
        picks.append(e)
        work = work.scatter(-1, e[:, None], float("-inf"))
    experts = torch.stack(picks, dim=-1)
    return probs.gather(-1, experts), experts


def _route_topk(x2d: torch.Tensor, w_router: torch.Tensor, k: int):
    """(N, H) tokens → (gates (N, k), experts (N, k), probs (N, E)).
    The logits are ``x2d @ w_router`` in the tokens' dtype, cast to f32.
    k = 1 keeps the Switch convention (gate = the raw top probability);
    k >= 2 normalises the gates over the chosen experts (GShard)."""
    logits = (x2d @ w_router).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _topk_lowest_index(probs, k)
    if k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, experts, probs


def router_z_loss(x2d: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """ST-MoE router z-loss: the mean over tokens of
    ``logsumexp(logits)²`` (the router product computed again)."""
    logits = (x2d @ w_router).float()
    return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)


# ------------------------------------------------------------------ the MLP

def _bank_dense(dense, toks: torch.Tensor, bank: torch.Tensor
                ) -> torch.Tensor:
    """(E, M, K) tokens · (E, K, N) weights → (E, M, N), one expert at a
    time through ``dense``: each expert's quantisation scales are its
    own, as the reference's vmap over the expert dim gives them."""
    return torch.stack([dense(toks[e], bank[e]) for e in range(len(bank))])


def _expert_mlp(toks, w_gate, w_up, w_down, matmul_precision: str):
    """Every local expert's SwiGLU on its (E_local, M, H) tokens."""
    if matmul_precision == "bf16":
        # one batched product, the reference's vmap of a plain matmul
        h = F.silu(torch.matmul(toks, w_gate)) * torch.matmul(toks, w_up)
        return torch.matmul(h, w_down)
    dense = resolve_quantized_dense(matmul_precision)
    h = (F.silu(_bank_dense(dense, toks, w_gate))
         * _bank_dense(dense, toks, w_up))
    return _bank_dense(dense, h, w_down)


def moe_mlp(x, w_router, w_gate, w_up, w_down, *, axis="ep",
            capacity_factor: float = 2.0, dispatch: str = "grouped",
            group_size: int = 128, top_k: int = 1,
            matmul_precision: str = "bf16", router_z_ratio: float = 0.0):
    """The switch-MoE MLP on local tokens ``x`` (B, S, H) →
    ``(y, aux_loss)``.  ``w_gate``/``w_up``/``w_down`` hold this rank's
    ``E_local`` experts on dim 0; ``axis=None`` means no expert
    parallelism (all experts local, no collectives).

    ``dispatch``: how tokens reach their (E, C, H) buckets.
      * ``"grouped"`` (default): groups of ``group_size`` tokens (shrunk
        to the largest divisor of the token count), each routing its
        tokens into per-group buckets with a one-hot product; capacity
        is enforced per group, ``capg = ceil(cf · k · G / E)``, first
        choices claiming it before any second choice;
      * ``"sort"``: a stable sort of the tokens by expert, the kept ones
        scattered into their slots and gathered back (global capacity);
      * ``"einsum"``: the whole-chunk one-hot dispatch, the semantics
        oracle (``"grouped"`` with one group computes the same).

    ``top_k``: experts per token (1 = Switch; 2+ = normalised GShard
    gates, ``"grouped"`` only).  ``router_z_ratio``: the z-loss rides
    the aux channel pre-divided by the balance weight."""
    ep = mesh.axis_size(axis) if axis else 1
    B, S, H = x.shape
    N = B * S
    E = w_router.shape[1]
    E_local = w_gate.shape[0]
    if E_local * ep != E:
        raise ValueError(f"router knows {E} experts but ep={ep} devices "
                         f"hold {E_local} each")
    if dispatch not in ("grouped", "einsum", "sort"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if top_k > 1 and dispatch != "grouped":
        raise ValueError(f"top_k={top_k} requires dispatch='grouped' "
                         f"(got {dispatch!r})")
    cap = int(-(-N * capacity_factor // E))
    x2d = x.reshape(N, H)

    with record_function("moe_route"):
        gates, experts, probs = _route_topk(x2d, w_router, top_k)
        gate, expert = gates[:, 0], experts[:, 0]   # the k = 1 paths' view

    if dispatch == "grouped":
        G, NG, capg = _grouped_caps(N, group_size, capacity_factor * top_k,
                                    E)
        cap = NG * capg   # the all_to_alls see one (E, cap, H)
        with record_function("moe_dispatch"):
            # assignments choice-major within each group: index j·G + t,
            # so every first choice claims capacity before any second
            eg = experts.reshape(NG, G, top_k).transpose(1, 2).reshape(
                NG, top_k * G)
            onehot, pos = _group_slot_positions(eg, E)
            kept = (pos < capg) & (onehot > 0)
            slotoh = F.one_hot(pos.clamp(0, capg - 1).long(), capg).bool()
            disp = (kept[..., None] & slotoh).reshape(
                NG, top_k, G, E * capg).to(x.dtype)          # (NG, k, G, S)
            buckets = torch.einsum("gkts,gth->gsh", disp,
                                   x2d.reshape(NG, G, H))
            buckets = buckets.reshape(NG, E, capg, H).transpose(
                0, 1).reshape(E, cap, H)
    elif dispatch == "einsum":
        with record_function("moe_dispatch"):
            onehot = F.one_hot(expert, E).to(torch.int32)          # (N, E)
            pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot - 1
            kept = (pos < cap) & (onehot > 0)
            disp = (kept[..., None] & F.one_hot(
                pos.clamp(0, cap - 1).long(), cap).bool()).to(x.dtype)
            buckets = torch.einsum("nec,nh->ech", disp, x2d)    # (E, C, H)
    else:
        with record_function("moe_dispatch"):
            # a stable sort keeps each expert's tokens in their order, so
            # the position within the run is the cumsum position the
            # drop rule is defined by
            order = torch.argsort(expert, stable=True)
            sorted_e = expert[order]
            counts = torch.bincount(expert, minlength=E)
            starts = torch.cumsum(counts, 0) - counts
            pos = torch.arange(N, device=x.device) - starts[sorted_e]
            keep = pos < cap
            # dropped tokens land in a trash row that is cut off
            slot = torch.where(keep, sorted_e * cap + pos.clamp(max=cap - 1),
                               E * cap)
            buckets = x2d.new_zeros((E * cap + 1, H)).index_put(
                (slot,), x2d[order])[:E * cap].reshape(E, cap, H)

    with record_function("moe_a2a_out"):
        # buckets by owning rank: (ep, E_local, C, H) split on the rank
        # dim; every rank receives its experts' buckets from the group
        recv = buckets.reshape(ep, E_local, cap, H)
        if axis:
            recv = C.all_to_all(recv, axis, split_axis=0, concat_axis=0,
                                tiled=False)

    with record_function("moe_expert_mlp"):
        toks = recv.transpose(0, 1).reshape(E_local, ep * cap, H)
        out = _expert_mlp(toks, w_gate, w_up, w_down, matmul_precision)

    with record_function("moe_a2a_back"):
        back = out.reshape(E_local, ep, cap, H).transpose(0, 1)
        if axis:
            back = C.all_to_all(back, axis, split_axis=0, concat_axis=0,
                                tiled=False)
        ret = back.reshape(E * cap, H)

    with record_function("moe_combine"):
        if dispatch == "grouped":
            back_g = ret.reshape(E, NG, capg, H).transpose(0, 1).reshape(
                NG, E * capg, H)
            ya = torch.einsum("gkts,gsh->gkth", disp, back_g)
            gates_g = gates.reshape(NG, G, top_k).transpose(1, 2)
            y2d = torch.sum(ya * gates_g[..., None].to(ya.dtype),
                            dim=1).reshape(N, H)
        elif dispatch == "einsum":
            y2d = torch.einsum("nec,ech->nh", disp,
                               ret.reshape(E, cap, H)) * gate[:, None]
        else:
            pulled = torch.cat([ret, ret.new_zeros((1, H))])
            y_sorted = pulled[slot] * keep[:, None].to(ret.dtype)
            inv = torch.empty_like(order)
            inv[order] = torch.arange(N, device=x.device)
            y2d = y_sorted[inv] * gate[:, None]

    with record_function("moe_aux_loss"):
        # Switch load balance: E · Σ_e fraction_e · mean prob_e, each
        # averaged over the ep group
        frac = (torch.bincount(experts.reshape(-1), minlength=E)
                / (N * top_k)).float()
        mean_p = probs.mean(dim=0)
        if axis:
            frac = C.all_reduce(frac, axis, mean=True)
            mean_p = C.all_reduce(mean_p, axis, mean=True)
        aux = E * torch.sum(frac * mean_p)
        if router_z_ratio:
            z = router_z_loss(x2d, w_router)
            if axis:
                z = C.all_reduce(z, axis, mean=True)
            aux = aux + router_z_ratio * z
    return y2d.reshape(B, S, H).to(x.dtype), aux


def moe_layer(params: MoEParams, x, axis="ep", *,
              capacity_factor: float = 2.0, dispatch: str = "grouped",
              group_size: int = 128, top_k: int = 1,
              router_z_ratio: float = 0.0):
    """The expert-parallel MoE MLP of the toy params on local tokens
    ``x`` (B, S, H): ``(y, aux_loss)``."""
    return moe_mlp(x, params.w_router, params.w_gate, params.w_up,
                   params.w_down, axis=axis,
                   capacity_factor=capacity_factor, dispatch=dispatch,
                   group_size=group_size, top_k=top_k,
                   router_z_ratio=router_z_ratio)


def moe_reference(params: MoEParams, x, *, capacity_factor: float = 2.0):
    """Single-device oracle of the global-capacity drop rule (``"sort"``
    and ``"einsum"``, and ``"grouped"`` when the chunk is one group),
    computed densely with the full expert weights, no collectives."""
    B, S, H = x.shape
    N = B * S
    E = params.w_router.shape[1]
    cap = int(-(-N * capacity_factor // E))
    x2d = x.reshape(N, H)
    gates, experts, _ = _route_topk(x2d, params.w_router, 1)
    gate, expert = gates[:, 0], experts[:, 0]
    onehot = F.one_hot(expert, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1
    kept = ((pos < cap) & (onehot > 0)).any(dim=1)
    h_g = torch.einsum("nh,nhf->nf", x2d, params.w_gate[expert])
    h_u = torch.einsum("nh,nhf->nf", x2d, params.w_up[expert])
    out = torch.einsum("nf,nfh->nh", F.silu(h_g) * h_u,
                       params.w_down[expert])
    y = out * gate[:, None] * kept[:, None]
    return y.reshape(B, S, H).to(x.dtype)


# ---------------------------------------------------------- the MoE LM

def moe_lm_specs(params: dict, axis="ep") -> dict:
    """Spec tree of the MoE transformer: the stacked expert leaves
    ``(L, E, …)`` shard E over ``axis``; the router and every dense leaf
    are replicated."""
    name = mesh.resolve_axis(axis).name

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if key in EXPERT_LEAVES and tree.ndim == 4:
            return (None, name)
        return ()
    return walk(params)


def shard_moe_lm_params(params: dict, axis="ep", rank: int | None = None,
                        world: int | None = None) -> dict:
    """This rank's (or ``rank``'s of ``world``) MoE transformer params:
    its ``E / ep`` slice of each expert bank, every other leaf whole."""
    name = mesh.resolve_axis(axis).name
    rank = mesh.axis_rank(axis) if rank is None else rank
    world = mesh.axis_size(axis) if world is None else world

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return _take_shard(tree, spec, name, rank, world)
    return walk(params, moe_lm_specs(params, axis))


def router_lr_mults(params: dict, mult: float):
    """The per-leaf learning-rate multipliers of ``moe_router_lr_mult``:
    ``mult`` on every ``w_router`` leaf, 1 elsewhere; None when
    ``mult`` is 1 (the reference's ``lr_mults``)."""
    if mult == 1.0:
        return None
    return {k: (router_lr_mults(v, mult) if isinstance(v, dict)
                else (mult if k == "w_router" else 1.0))
            for k, v in params.items()}


def make_moe_lm_train_step(params_sharded: dict, cfg, *, dp_axis="dp",
                           ep_axis="ep", sp_axis=None, lr: float = 3e-4,
                           b1: float = 0.9, b2: float = 0.95,
                           eps: float = 1e-8):
    """``step(shards, opt_state, batch) -> (shards, opt_state, loss)``
    for the MoE transformer over dp × ep, ``batch`` = (input_ids,
    labels), the GLOBAL batch: every rank routes its rows of it (the
    batch sharded over the flattened ``("dp", "ep")`` axes) and each
    layer's MoE MLP all_to_alls tokens to the experts' owners across
    its ep group and back.  Grad sync: the expert leaves' grads, whose
    other ranks' tokens already arrived through the all_to_all
    backwards, sum over dp only; the replicated leaves' (router, dense)
    over dp and ep (one all_reduce over the whole group); every leaf is
    then divided by the dp · ep ranks.  The loss is their mean (one
    all_reduce).  ``cfg.moe_router_lr_mult`` sets the router's
    learning rate multiplier.  Adam runs in place.

    ``sp_axis`` makes it the dp × sp × ep step: each rank also takes its
    sequence chunk and attention is the ring over ``sp_axis``; routing
    is per token, so the expert choreography is unchanged (each rank
    routes its B_local × S_local tokens).  The grads sum over dp and sp
    for the expert leaves, over the whole grid for the rest, and divide
    by every rank.  The axes are those of one ``utils.mesh.grid_axes``
    grid (``("dp", "sp", "ep")``; ``dp_ep_axes`` without sp), which
    fills the process group."""
    from ..models import transformer as T
    from .fsdp import microbatch_value_and_grad

    if not cfg.n_experts:
        raise ValueError("cfg.n_experts must be > 0 for the MoE step")
    ws_dp, ws_ep = mesh.axis_size(dp_axis), mesh.axis_size(ep_axis)
    if cfg.n_experts % ws_ep:
        raise ValueError(f"n_experts={cfg.n_experts} must be divisible "
                         f"by ep={ws_ep}")
    if sp_axis is None and cfg.sp_axis is not None:
        name = T._axis_name(cfg.sp_axis)
        raise ValueError(
            f"cfg.sp_axis={name!r} (ring attention) but "
            f"make_moe_lm_train_step got sp_axis=None — the batch would "
            f"replicate over {name!r} and sp grads would never sync.  "
            f"Pass sp_axis (the step sets the ring config itself).")
    T.check_supported(cfg)
    cfg = dataclasses.replace(cfg, ep_axis=ep_axis)
    n_total = ws_dp * ws_ep
    rep_axes = [dp_axis]
    if sp_axis is not None:
        cfg = dataclasses.replace(cfg, attention_impl="ring",
                                  sp_axis=sp_axis)
        n_total *= mesh.axis_size(sp_axis)
        rep_axes.append(sp_axis)
    world = mesh.span(*rep_axes, ep_axis)
    experts_sync = mesh.span(*rep_axes)
    specs = moe_lm_specs(params_sharded, ep_axis)
    ep_name = mesh.resolve_axis(ep_axis).name
    lr_mults = router_lr_mults(params_sharded, cfg.moe_router_lr_mult)

    def step(shards, opt_state, batch):
        local = mesh.shard_rows(batch, dp_axis, ep_axis)
        if sp_axis is not None:
            local = mesh.shard_seq(local, sp_axis)
        with record_function("forward_backward"):
            loss, grads = microbatch_value_and_grad(
                lambda p, b: T.lm_loss(p, b, cfg), shards, local, 1)
        with record_function("loss_mean"):
            loss = C.all_reduce(loss, world, mean=True)
        with record_function("grad_sync"):
            synced = [C.all_reduce(g, experts_sync if ep_name in
                                   optim.tree_get(specs, path) else world)
                      / n_total
                      for path, g in optim.tree_leaves(grads)]
            grads = optim.tree_unflatten(grads, synced)
        with record_function("opt_step"):
            shards, opt_state = optim.adam_update(
                grads, opt_state, shards, lr=lr, b1=b1, b2=b2, eps=eps,
                lr_mults=lr_mults)
        return shards, opt_state, loss

    return step


def make_ep_train_step(params_sharded: MoEParams, *, axis="ep",
                       capacity_factor: float = 2.0,
                       aux_weight: float = 0.01, lr: float = 1e-3):
    """``step(params, opt_state, (x, y)) -> (params, opt_state, loss)``
    on the toy MoE regression (mean squared error + ``aux_weight`` ·
    aux), the GLOBAL batch sharded on ``axis`` (each rank routes its own
    rows).  The expert leaves' grads stay local (the all_to_all
    backwards returned the other ranks' cotangents) and are divided by
    the ranks; the router's are averaged over the group.  ``opt_state``:
    ``optim.adam_init`` of ``params._asdict()``."""
    ws = mesh.axis_size(axis)
    specs = moe_specs(axis)._asdict()
    name = mesh.resolve_axis(axis).name

    def step(p, opt_state, batch):
        x, y = mesh.shard_rows(batch, axis)
        tree = p._asdict()
        leaves = list(tree.values())
        for t in leaves:
            t.requires_grad_(True)
        try:
            with record_function("forward_backward"):
                out, aux = moe_layer(MoEParams(**tree), x, axis,
                                     capacity_factor=capacity_factor)
                loss = torch.mean((out - y) ** 2) + aux_weight * aux
                grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        with record_function("loss_mean"):
            loss = C.all_reduce(loss.detach(), axis, mean=True)
        with record_function("grad_sync"):
            grads = {k: (g / ws if name in specs[k]
                         else C.all_reduce(g, axis, mean=True))
                     for k, g in zip(tree, grads)}
        with record_function("opt_step"):
            tree, opt_state = optim.adam_update(grads, opt_state, tree,
                                                lr=lr)
        return MoEParams(**tree), opt_state, loss

    return step
