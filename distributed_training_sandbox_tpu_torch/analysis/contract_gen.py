"""Each strategy's collective calls a step, derived from its RuleSet.

Port of the JAX package's ``analysis/contract_gen.py``.  The reference
derives each strategy's compiled *sites* from its rules; the port
derives the *calls* one step makes, as the shim
``ops.collectives.COLLECTIVES`` counts them (``parallel/contracts.py``
says how the two differ).  What the derivation reads from the rules:

* which leaves a strategy shards at rest over its data axis: each is
  gathered where it is used (once for a root leaf, once a layer for a
  stacked one, and again in the recompute under remat), and each
  gather's backward is a reduce_scatter;
* the ``weight_update_sharding`` level of the data family, which moves
  the grad reduction (all_reduce, reduce_scatter, or the gathers'
  backward) and the rebuild;
* the row-parallel leaves a layer holds (their spec names the tp axis on
  the dim the product contracts): each leaves a partial sum that one
  rejoin adds over tp, forward, in the recompute and in the backward;
* the expert-sharded leaves: a layer that has them dispatches over ep
  (two all_to_alls and their inverses);
* the axes a leaf is replicated on: one grad all_reduce a leaf;
* for the serving steps (inference, the layer stack unrolled): only
  the forward's rejoins, once a step;

and the config (``overlap``, the wire format) rewrites the calls.

:func:`diff_all_contracts` holds every generated count against the
hand-written functions of ``parallel/contracts.py`` over a grid of
world sizes, depths, overlaps, remat and microbatches; the tests pin
the diff empty.  ``composable_dp_fsdp_tp`` has no hand formula: the
generator is its only source (``GENERATED_STRATEGIES``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch

from ..ops.collectives import CollectiveCounts
from ..parallel import contracts as HC
from ..parallel.ddp import DEFAULT_Q8_BUCKET_MB
from .rules import RULESETS, RuleSet, named_leaf_paths, spec_axes

KINDS = CollectiveCounts.KINDS
GENERATED_STRATEGIES = ("composable_zero1", "composable_dp_fsdp_tp")


@dataclass(frozen=True)
class Ctx:
    """What a step's counts depend on beyond the rules: the axis sizes,
    remat, microbatches, and the knobs a family reads."""
    axis_sizes: dict
    remat: bool = True
    accum_steps: int = 1
    reshard_after_forward: bool = True
    overlap: str | None = None       # None: the ruleset's own
    rebuild: str = "broadcast"
    bucket_mb: float | None = None
    quantized_grads: bool = False
    z_loss: bool = False


@dataclass(frozen=True)
class _Leaf:
    path: str
    ndim: int
    spec: tuple

    @property
    def layer(self) -> bool:
        return self.path.startswith("layers/")


def _leaves(rs: RuleSet, params) -> list[_Leaf]:
    specs = rs.match("params", params).spec_by_path()
    return [_Leaf(p, len(getattr(x, "shape", ())), specs[p])
            for p, x in named_leaf_paths(params)]


def _n_layers(params) -> int:
    return next(iter(params["layers"].values())).shape[0]


def _zero() -> dict:
    return dict.fromkeys(KINDS, 0)


def _param_bytes(params) -> int:
    return sum(x.numel() * x.element_size()
               for _, x in named_leaf_paths(params))


# ------------------------------------------------------------ the families

def _data(rs: RuleSet, params, c: Ctx) -> dict:
    """The toy MLP's data-parallel family (the W axis of
    arXiv:2004.13336).  A leaf sharded at rest (W3) is gathered in its
    layer's forward and again in the backward's recompute, but for the
    last layer's bias (nothing after its product needs it again); a
    step also means the loss and runs a barrier (two all_reduces)."""
    leaves = _leaves(rs, params)
    n, axis = len(leaves), rs.axes[0]
    w, comm = rs.weight_update_sharding, rs.config.get("grad_comm")
    out = _zero()
    out["all_reduce"] = 2                       # the loss mean, the barrier
    gather = c.rebuild == "all_gather"
    if w == 0:
        if comm == "q8":
            out["all_gather"] = 2 * HC.ddp_bucket_count(
                _param_bytes(params), c.bucket_mb or DEFAULT_Q8_BUCKET_MB)
        elif comm == "bucketed" or c.bucket_mb:
            out["all_reduce"] += HC.ddp_bucket_count(
                _param_bytes(params), c.bucket_mb or 25.0)
        else:
            out["all_reduce"] += n              # a grad all_reduce a leaf
    elif w in (1, 2):
        if w == 1:
            out["all_reduce"] += n              # grads all_reduced
        else:
            out["reduce_scatter"] = n           # grads scattered to chunks
        # the rebuild of every leaf from the updated chunks
        if gather:
            out["all_gather"] = n
        else:
            out["all_reduce"] += n
    else:
        at_rest = [x for x in leaves if axis in spec_axes(x.spec)]
        out["all_gather"] = 2 * len(at_rest) - 1
        out["reduce_scatter"] = len(at_rest)
    return out


def _fsdp_gathers(leaves, axis, L, c: Ctx, overlap, quantized, ws):
    """The FSDP mechanism's calls: ``leaves`` sharded over ``axis``
    gathered (root once, a stacked leaf each layer, again under remat;
    all at once without ``reshard_after_forward``), each gather's
    backward a reduce_scatter, every microbatch again."""
    out = _zero()
    fwd = 2 if c.remat else 1
    # (gathered rank, forward calls, backward calls) a leaf
    sites = []
    for x in leaves:
        if axis not in spec_axes(x.spec):
            continue
        if not x.layer:
            sites.append((x, x.ndim, 1, 1))
        elif c.reshard_after_forward:
            sites.append((x, x.ndim - 1, L * fwd, L))
        else:
            sites.append((x, x.ndim, 1, 1))
    ring = overlap in ("ring", "ring_fused", "ring_fused_pallas")
    for x, rank, f, b in sites:
        # a stacked 3-D leaf sharded on the dim its product contracts
        fused = (overlap in ("ring_fused", "ring_fused_pallas") and x.layer
                 and x.ndim == 3 and x.spec[1] == axis)
        if quantized:
            q = 2 if rank > 1 else 1           # codes and scales
            out["all_gather"] += q * f
            if rank > 1 and c.quantized_grads:
                out["all_to_all"] += 2 * b
            else:
                out["reduce_scatter"] += b
        elif ring:
            if ws > 1:
                hops = f + (b if fused else 0)
                out["collective_permute"] += hops * (ws - 1)
                if not fused:
                    out["reduce_scatter"] += b
        else:
            out["all_gather"] += f
            out["reduce_scatter"] += b
    return {k: v * c.accum_steps for k, v in out.items()}


def _fsdp(rs: RuleSet, params, c: Ctx) -> dict:
    """FSDP over the data axis, and the loss mean."""
    axis = rs.axes[0]
    overlap = c.overlap or rs.config.get("overlap", "none")
    out = _fsdp_gathers(_leaves(rs, params), axis, _n_layers(params), c,
                        overlap, rs.config.get("precision") == "int8",
                        c.axis_sizes.get(axis, 1))
    out["all_reduce"] += 1
    return out


def _ring_hops(L: int, sp: int, remat: bool) -> int:
    """The K/V ring over sp: a layer's K and V each sp - 1 hops forward,
    as many back, and the forward's again under remat."""
    return L * 2 * (sp - 1) * (2 + int(remat))


def _sp(rs: RuleSet, params, c: Ctx) -> dict:
    """FSDP over dp, the ring over sp, and the loss and every leaf's
    grads averaged over sp (one all_reduce each)."""
    out = _fsdp(rs, params, c)
    L = _n_layers(params)
    out["all_reduce"] += 1 + len(_leaves(rs, params))
    out["collective_permute"] += c.accum_steps * _ring_hops(
        L, c.axis_sizes.get(rs.config["sp_axis"], 1), c.remat)
    return out


def _rejoins(rs: RuleSet, leaves, L, c: Ctx, tp_axis, overlap) -> dict:
    """A layer's rejoins, one for each row-parallel leaf (tp on the dim
    its product contracts: a partial sum), forward and again in the
    recompute, and their backward all_reduces; ``"ring"`` a
    reduce_scatter and tp - 1 hops each (none at one rank), ``"q8"``
    two all_gathers (codes, scales)."""
    rows = sum(1 for x in leaves if x.layer and len(x.spec) > 1
               and x.spec[1] == tp_axis)
    tp = c.axis_sizes.get(tp_axis, 1)
    fwd = 1 + int(c.remat)
    out = _zero()
    if overlap == "none":
        out["all_reduce"] = L * rows * (fwd + 1)
    elif overlap == "ring":
        if tp > 1:
            out["reduce_scatter"] = L * rows * fwd
            out["collective_permute"] = L * rows * (tp - 1) * fwd
            out["all_reduce"] = L * rows
    elif overlap == "q8":
        out["all_gather"] = L * rows * 2 * fwd
        out["all_reduce"] = L * rows
    else:
        raise ValueError(f"overlap={overlap!r}")
    return out


def _tp(rs: RuleSet, params, c: Ctx) -> dict:
    """Megatron TP (dp × tp, or dp × sp × tp with an ``sp`` axis size):
    the rejoins and the ring each microbatch, then the loss mean and
    one grad all_reduce a leaf over the axes it is replicated on."""
    leaves, L = _leaves(rs, params), _n_layers(params)
    out = _rejoins(rs, leaves, L, c, rs.axes[1],
                   c.overlap or rs.config.get("overlap", "none"))
    out["collective_permute"] += _ring_hops(L, c.axis_sizes.get("sp", 1),
                                            c.remat)
    out = {k: v * c.accum_steps for k, v in out.items()}
    out["all_reduce"] += 1 + len(leaves)
    return out


def _moe(rs: RuleSet, params, c: Ctx) -> dict:
    """dp × ep MoE: a layer with expert-sharded leaves sends its buckets
    out and its outputs back (two all_to_alls) and means the aux loss's
    two statistics over ep (a third with the z-loss); the backward
    inverts both all_to_alls and means ``mean_p`` (and ``z``); the
    recompute repeats the forward; then the loss mean and a grad
    all_reduce a leaf."""
    leaves, L = _leaves(rs, params), _n_layers(params)
    ep = rs.axes[1]
    if not any(x.layer and ep in spec_axes(x.spec) for x in leaves):
        raise ValueError(f"{rs.strategy}: no expert-sharded leaf")
    z, r = int(c.z_loss), int(c.remat)
    out = _zero()
    out["all_to_all"] = L * (4 + 2 * r)
    out["all_reduce"] = L * ((2 + z) * (1 + r) + 1 + z) + 1 + len(leaves)
    out["collective_permute"] = _ring_hops(L, c.axis_sizes.get("sp", 1),
                                           c.remat)
    return out


def _composable(rs: RuleSet, params, c: Ctx) -> dict:
    """dp × fsdp × tp (``parallel.composable``): the FSDP mechanism over
    fsdp (every leaf names it), the rejoins over tp, each microbatch;
    then the loss mean over the three axes and one grad all_reduce a
    leaf (over dp, and tp where the leaf is tp-replicated)."""
    dp_axis, fsdp_axis, tp_axis = rs.axes
    leaves, L = _leaves(rs, params), _n_layers(params)
    out = _fsdp_gathers(leaves, fsdp_axis, L, c, "none", False,
                        c.axis_sizes.get(fsdp_axis, 1))
    rejoin = _rejoins(rs, leaves, L, c, tp_axis,
                      c.overlap or rs.config.get("overlap", "none"))
    for k, v in rejoin.items():
        out[k] += v * c.accum_steps
    out["all_reduce"] += 1 + len(leaves)
    return out


def _serve(rs: RuleSet, params, c: Ctx) -> dict:
    """A serving step (the reference's ``_serve_counts``): inference
    only, the layer stack unrolled, so a layer's rejoins — one a
    row-parallel leaf — are made once a step and nothing else is."""
    leaves, L = _leaves(rs, params), _n_layers(params)
    out = _zero()
    out["all_reduce"] = L * sum(1 for x in leaves if x.layer
                                and len(x.spec) > 1
                                and x.spec[1] == rs.axes[0])
    return out


def _pipeline(rs: RuleSet, params, c: Ctx) -> dict:
    return _zero()      # stages hand activations over by device copies


_FAMILY = {"data": _data, "fsdp": _fsdp, "sp": _sp, "tp": _tp,
           "moe": _moe, "serve": _serve, "composable": _composable,
           "pipeline": _pipeline}


def generate_counts(strategy: str, params, ctx: Ctx | None = None,
                    **kw) -> dict:
    """Every kind of ``CollectiveCounts.KINDS`` one step of ``strategy``
    calls on ``params`` (the full tree or the shards: only leaf paths,
    ranks and, for the bucketed wire, bytes count), derived from
    ``RULESETS[strategy]``.  ``ctx`` (or its fields as keywords): the
    axis sizes and the knobs."""
    rs = RULESETS.get(strategy)
    if rs is None:
        raise KeyError(f"no RuleSet registered for {strategy!r}; "
                       f"have {sorted(RULESETS)}")
    ctx = dataclasses.replace(ctx, **kw) if ctx else Ctx(**kw)
    return _FAMILY[rs.family](rs, params, ctx)


# --------------------------------------------- the hand-written functions

def _hand_data(kind, q8=False, bucketed=False):
    def counts(params, c: Ctx):
        n = len(named_leaf_paths(params))
        return HC.step_collectives(
            kind, n, _param_bytes(params), q8=q8, rebuild=c.rebuild,
            bucket_mb=(c.bucket_mb or 25.0) if bucketed else c.bucket_mb)
    return counts


def _hand_fsdp(overlap):
    def counts(params, c: Ctx):
        ws = c.axis_sizes.get("dp", 1)
        return HC.fsdp_step_collectives(
            params, ws, overlap=c.overlap or overlap,
            reshard_after_forward=c.reshard_after_forward, remat=c.remat,
            accum_steps=c.accum_steps)
    return counts


def _hand_fsdp_q8(params, c: Ctx):
    return HC.fsdp_quantized_step_collectives(
        params, reshard_after_forward=c.reshard_after_forward,
        remat=c.remat, accum_steps=c.accum_steps,
        quantized_grads=c.quantized_grads)


def _hand_sp(params, c: Ctx):
    return HC.sp_step_collectives(
        params, c.axis_sizes.get("dp", 1), c.axis_sizes.get("sp", 1),
        overlap=c.overlap or "none", remat=c.remat,
        accum_steps=c.accum_steps)


def _hand_tp(overlap):
    def counts(params, c: Ctx):
        return HC.tp_step_collectives(
            params, c.axis_sizes.get("tp", 1), sp=c.axis_sizes.get("sp", 1),
            overlap=c.overlap or overlap, remat=c.remat,
            accum_steps=c.accum_steps)
    return counts


def _hand_moe(params, c: Ctx):
    return HC.moe_step_collectives(params, remat=c.remat, z_loss=c.z_loss,
                                   sp=c.axis_sizes.get("sp", 1))


def _hand_pipeline(kind):
    return lambda params, c: HC.step_collectives(kind, 0)


# strategy -> the hand-written count of ``parallel/contracts.py``
HAND = {
    "ddp": _hand_data("ddp"),
    "ddp_bucketed": _hand_data("ddp", bucketed=True),
    "ddp_q8": _hand_data("ddp", q8=True),
    "zero1": _hand_data("zero1"),
    "zero2": _hand_data("zero2"),
    "zero3": _hand_data("zero3"),
    "fsdp": _hand_fsdp("none"),
    "fsdp_ring": _hand_fsdp("ring"),
    "fsdp_ring_fused_pallas": _hand_fsdp("ring_fused_pallas"),
    "fsdp_q8": _hand_fsdp_q8,
    "sp": _hand_sp,
    "tp": _hand_tp("none"),
    "tp_ring": _hand_tp("ring"),
    "tp_q8": _hand_tp("q8"),
    "moe": _hand_moe,
    **{k: lambda params, c: HC.serve_step_collectives(params)
       for k in HC.SERVE_STRATEGIES},
    "gpipe": _hand_pipeline("gpipe"),
    "1f1b": _hand_pipeline("1f1b"),
    # the replay exemplar: the generator's own, held against zero1's
    "composable_zero1": _hand_data("zero1"),
}


# ------------------------------------------------------------------ differ

def _tiny_tree(L: int, *, experts: int = 0, tied: bool = True) -> dict:
    """A TINY_LM-shaped parameter tree on the meta device (shapes only):
    hidden 64, 4 query and 2 KV heads of 16, MLP 160 (experts of 32)."""
    def t(*shape):
        return torch.empty(shape, device="meta")
    h, F = 64, 160
    layers = {"ln1": t(L, h), "wq": t(L, h, 64), "wk": t(L, h, 32),
              "wv": t(L, h, 32), "wo": t(L, 64, h), "ln2": t(L, h)}
    if experts:
        layers.update(w_router=t(L, h, experts),
                      w_gate=t(L, experts, h, 32), w_up=t(L, experts, h, 32),
                      w_down=t(L, experts, 32, h))
    else:
        layers.update(w_gate=t(L, h, F), w_up=t(L, h, F), w_down=t(L, F, h))
    tree = {"embed": t(512, h), "layers": layers, "final_norm": t(h)}
    if not tied:
        tree["lm_head"] = t(h, 512)
    return tree


def _mlp_tree(sizes) -> list:
    return [{"w": torch.empty((a, b), device="meta"),
             "b": torch.empty((b,), device="meta")}
            for a, b in zip(sizes[:-1], sizes[1:])]


def context_grid(strategy: str) -> list:
    """``(params, Ctx)`` pairs exercising every branch a strategy's
    counts can take: world sizes, depths, overlaps, remat, microbatches,
    rebuilds, buckets."""
    rs = RULESETS[strategy]
    out = []
    if rs.family == "data":
        for dp in (1, 2, 8):
            for sizes in ((48, 48, 48), (30, 44, 18), (400, 400, 400, 400)):
                tree = _mlp_tree(sizes)
                for rebuild in ("broadcast", "all_gather"):
                    out.append((tree, Ctx({"dp": dp}, rebuild=rebuild)))
                out.append((tree, Ctx({"dp": dp}, bucket_mb=0.05)))
    elif rs.family in ("fsdp", "sp"):
        for L in (1, 2, 4):
            for tied in (True, False):
                tree = _tiny_tree(L, tied=tied)
                for ws in (1, 2, 4):
                    for remat in (True, False):
                        for accum in (1, 2):
                            sizes = ({"dp": ws} if rs.family == "fsdp"
                                     else {"dp": ws, "sp": 2})
                            c = Ctx(sizes, remat=remat, accum_steps=accum)
                            out.append((tree, c))
                            if rs.family == "sp":
                                out.append((tree, dataclasses.replace(
                                    c, overlap="ring")))
                            else:
                                out.append((tree, dataclasses.replace(
                                    c, reshard_after_forward=False)))
                            if rs.config.get("precision") == "int8":
                                out.append((tree, dataclasses.replace(
                                    c, quantized_grads=True)))
        if rs.config.get("overlap", "none").startswith("ring_fused"):
            out = [(t, c) for t, c in out if c.reshard_after_forward]
    elif rs.family == "tp":
        for L in (1, 2, 4):
            for experts in (0, 4):
                tree = _tiny_tree(L, experts=experts)
                for tp in (1, 2, 4):
                    for sp in (1, 2):
                        for remat in (True, False):
                            for accum in (1, 2):
                                out.append((tree, Ctx(
                                    {"dp": 2, "sp": sp, "tp": tp},
                                    remat=remat, accum_steps=accum)))
    elif rs.family == "serve":
        for L in (1, 2, 4):
            for experts in (0, 4):
                for tied in (True, False):
                    tree = _tiny_tree(L, experts=experts, tied=tied)
                    for tp in (1, 2, 4):
                        out.append((tree, Ctx({"tp": tp}, remat=False)))
    elif rs.family == "moe":
        for L in (1, 2, 4):
            tree = _tiny_tree(L, experts=8)
            for sp in (1, 2):
                for remat in (True, False):
                    for z in (False, True):
                        out.append((tree, Ctx({"dp": 2, "sp": sp, "ep": 2},
                                              remat=remat, z_loss=z)))
    elif rs.family == "composable":
        for L in (1, 2, 4):
            for tied in (True, False):
                tree = _tiny_tree(L, tied=tied)
                for dp, f, tp in ((1, 1, 1), (1, 2, 2), (2, 2, 2), (2, 4, 2),
                                  (1, 1, 4)):
                    for overlap in ("none", "ring"):
                        for remat in (True, False):
                            for accum in (1, 2):
                                out.append((tree, Ctx(
                                    {"dp": dp, "fsdp": f, "tp": tp},
                                    overlap=overlap, remat=remat,
                                    accum_steps=accum)))
    else:
        out = [(_tiny_tree(2), Ctx({}))]
    return out


@dataclass
class ContractDiff:
    """The divergences of the generated counts from the hand-written
    ones for one strategy (empty: they agree)."""
    strategy: str
    divergences: list = field(default_factory=list)
    checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.divergences

    def describe(self) -> str:
        head = f"[{self.strategy}] " + ("agree" if self.ok else "DIVERGE")
        return "\n".join([head] + [f"  {d}" for d in self.divergences])


def diff_contract(strategy: str, grid=None) -> ContractDiff:
    """Generated against hand-written counts for one strategy, every
    kind, over :func:`context_grid`."""
    diff = ContractDiff(strategy)
    hand = HAND.get(strategy)
    if hand is None:
        diff.divergences.append("no hand-written count")
        return diff
    for params, c in (grid if grid is not None else context_grid(strategy)):
        g = generate_counts(strategy, params, c)
        h = hand(params, c)
        diff.checked += 1
        for kind in KINDS:
            if g.get(kind, 0) != h.get(kind, 0):
                diff.divergences.append(
                    f"{kind} @ {c}: generated {g.get(kind, 0)} vs hand "
                    f"{h.get(kind, 0)}")
    return diff


def diff_all_contracts() -> dict:
    """Every strategy of either registry; a one-sided one diverges (the
    generated-only strategies excepted)."""
    out = {}
    for strategy in sorted(set(HAND) | set(RULESETS)):
        if strategy in GENERATED_STRATEGIES and strategy not in HAND:
            continue
        if strategy not in RULESETS:
            d = ContractDiff(strategy)
            d.divergences.append("hand count has no RuleSet twin")
            out[strategy] = d
        else:
            out[strategy] = diff_contract(strategy)
    return out
