"""The composable N-D mesh step: one rule-driven train step a
:class:`MeshPlan`.

Port of the JAX package's ``parallel/composable.py``.

* :class:`MeshPlan` names the grid (the sizes of dp, fsdp, tp, sp) and
  the weight-update-sharding degree W0–W3 of arXiv:2004.13336, which
  folds DDP and the three ZeRO stages into one axis; ``w_layout`` picks
  W3's form (``"flat"``: ZeRO-3's owner chunks, ``"named"``: FSDP's
  named dims).
* :func:`make_composable_train_step` builds any supported plan.  A
  legacy plan (1-D data parallel at any W, dp × tp, dp × sp, fsdp) is
  the port's hand factory with that factory's own defaults
  (``parallel/ddp.py``, ``zero.py``, ``fsdp.py``, ``tensor.py``,
  ``sequence.py``), so a replayed plan is the same step, bit for bit.
  dp × fsdp × tp runs :func:`make_dp_fsdp_tp_step`, whose placement
  comes from ``analysis.rules.RULESETS["composable_dp_fsdp_tp"]`` and
  whose collective calls a step come from ``analysis.contract_gen``
  only.

The 3-axis step composes the port's pinned mechanisms: the FSDP
gathers over ``fsdp`` in the layer hook inside the checkpointed layer
(the backward re-gathers; each gather's backward reduce_scatters the
grads over fsdp), the Megatron layer body over ``tp`` (two rejoins a
layer), the batch's rows over ``(dp, fsdp)`` jointly, and one grad
all_reduce a leaf over the axes it is replicated on, divided by the
grid's ranks.

The grid is ``utils.mesh.grid_axes`` over the plan's axes in the
reference mesh's device order (row-major, the last axis fastest); every
rank builds it in one order.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Callable

from torch.profiler import record_function

from ..analysis import rules as R
from ..models import transformer as T
from ..ops import collectives as C
from ..utils import mesh
from . import fsdp, optim, sequence, tensor, zero
from .ddp import make_ddp_train_step

MESH_PLAN_AXES = ("dp", "fsdp", "tp", "sp")
W_LAYOUTS = ("flat", "named")
THREE_AXES = ("dp", "fsdp", "tp")
THREE_AXIS_RULES = R.RULESETS["composable_dp_fsdp_tp"]

_PLAN_TOKEN = re.compile(r"^(dp|fsdp|tp|sp)(\d+)$|^w([0-3])(flat|named)?$")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Named grid-axis sizes and the weight-update-sharding degree.

    Grammar (:meth:`parse`): ``x``- or ``,``-separated tokens, each
    ``<axis><size>`` or ``w<degree>[flat|named]``: ``"dp8xw1"`` (ZeRO-1),
    ``"dp2xfsdp2xtp2"`` (the 3-axis step), ``"dp8xw3named"`` (FSDP).
    Omitted axes are 1; an omitted W degree 0 (DDP).  The W degree
    applies to ``dp``; an ``fsdp`` axis above 1 is named-dim W3 over its
    own axis and so needs ``w == 0``."""
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    w: int = 0
    w_layout: str = "flat"

    def __post_init__(self):
        for name in MESH_PLAN_AXES:
            size = getattr(self, name)
            if not isinstance(size, int) or size < 1:
                raise ValueError(f"MeshPlan.{name}={size!r}: axis sizes "
                                 f"must be integers >= 1")
        if self.w not in (0, 1, 2, 3):
            raise ValueError(f"MeshPlan.w={self.w!r}: the weight-update-"
                             f"sharding degree is W0..W3")
        if self.w_layout not in W_LAYOUTS:
            raise ValueError(f"MeshPlan.w_layout={self.w_layout!r}: "
                             f"choose from {W_LAYOUTS}")
        if self.w and self.fsdp > 1:
            raise ValueError(
                f"MeshPlan(dp={self.dp}, fsdp={self.fsdp}, w={self.w}): "
                f"an fsdp axis IS named-dim W3 over its own axis; a "
                f"nonzero W degree on dp does not compose with it")
        if self.w_layout == "named" and self.w not in (0, 3):
            raise ValueError(
                f"MeshPlan.w_layout='named' is the FSDP representation "
                f"of W3; it is meaningless at w={self.w} (zero{self.w} "
                f"state is flat owner chunks by construction)")

    # ------------------------------------------------------------ grammar

    @classmethod
    def parse(cls, text: str) -> "MeshPlan":
        """``"dp2xfsdp2xtp2"`` / ``"dp8,w1"`` / ``"dp8xw3named"`` → plan."""
        sizes = {}
        w, w_layout = 0, None
        for tok in re.split(r"[x,×]", text.strip().lower()):
            if not tok:
                continue
            m = _PLAN_TOKEN.match(tok)
            if not m:
                raise ValueError(
                    f"bad MeshPlan token {tok!r} in {text!r}; tokens are "
                    f"<axis><size> (axes {MESH_PLAN_AXES}) or "
                    f"w<0-3>[flat|named]")
            if m.group(1):
                if m.group(1) in sizes:
                    raise ValueError(f"duplicate axis {m.group(1)!r} "
                                     f"in {text!r}")
                sizes[m.group(1)] = int(m.group(2))
            else:
                w = int(m.group(3))
                w_layout = m.group(4)
        return cls(w=w, w_layout=w_layout or "flat", **sizes)

    def describe(self) -> str:
        toks = [f"{a}{getattr(self, a)}" for a in MESH_PLAN_AXES
                if getattr(self, a) > 1] or ["dp1"]
        if self.w:
            toks.append(f"w{self.w}"
                        + ("named" if self.w == 3
                           and self.w_layout == "named" else ""))
        return "x".join(toks)

    # ----------------------------------------------------------- geometry

    @property
    def ways(self) -> int:
        """The ranks the plan spans."""
        return self.dp * self.fsdp * self.tp * self.sp

    def axis_sizes(self) -> dict:
        return {a: getattr(self, a) for a in MESH_PLAN_AXES}

    def mesh_axes(self) -> dict:
        """Axis name → size of the grid: the size-1 axes dropped, dp
        kept when nothing else is left."""
        active = {a: getattr(self, a) for a in MESH_PLAN_AXES
                  if getattr(self, a) > 1}
        return active or {"dp": 1}

    @property
    def param_shard_ways(self) -> int:
        """The ways the params at rest divide."""
        return self.fsdp * self.tp * (self.dp if self.w >= 3 else 1)

    @property
    def opt_shard_ways(self) -> int:
        """The ways the optimizer state divides."""
        return self.fsdp * self.tp * (self.dp if self.w >= 1 else 1)

    @property
    def data_ways(self) -> int:
        """The ways the global batch's rows divide (sp divides the
        sequence)."""
        return self.dp * self.fsdp

    # --------------------------------------------------------- resolution

    def normalized(self) -> "MeshPlan":
        """The canonical form: an ``fsdp`` axis with nothing else is
        FSDP, named-dim W3 over an axis called ``dp``."""
        if self.fsdp > 1 and self.dp == 1 and self.tp == 1 \
                and self.sp == 1 and self.w == 0:
            return MeshPlan(dp=self.fsdp, w=3, w_layout="named")
        return self

    def strategy_name(self) -> str:
        """The strategy (= RuleSet = contract) the plan runs as; raises
        for an unsupported combination."""
        p = self.normalized()
        if p.fsdp > 1:
            if p.tp > 1 and p.sp == 1:
                return "composable_dp_fsdp_tp"
            raise ValueError(
                f"MeshPlan {self.describe()!r}: unsupported axis combo — "
                f"an fsdp axis currently composes with tp only "
                f"(dp×fsdp×tp); dp×fsdp alone or ×sp is future work")
        if p.tp > 1:
            if p.sp > 1:
                raise ValueError(
                    f"MeshPlan {self.describe()!r}: dp×tp×sp runs through "
                    f"the hand tp driver (make_tp_train_step sp_axis=); "
                    f"it is not yet folded into the composable surface")
            if p.w:
                raise ValueError(f"MeshPlan {self.describe()!r}: W>0 on "
                                 f"dp does not compose with tp yet")
            return "tp"
        if p.sp > 1:
            if p.w not in (0, 3):
                raise ValueError(f"MeshPlan {self.describe()!r}: sp rides "
                                 f"fsdp-over-dp (W3 named); w={p.w} does "
                                 f"not apply")
            return "sp"
        if p.w == 0:
            return "ddp"
        if p.w == 1:
            return "composable_zero1"
        if p.w == 2:
            return "zero2"
        return "fsdp" if p.w_layout == "named" else "zero3"

    def validate(self, n_devices: int | None = None,
                 model_cfg: T.TransformerConfig | None = None,
                 seq_len: int | None = None) -> None:
        """The axis product equals the ranks, tp divides the heads (and
        the MLP), sp divides the sequence."""
        if n_devices is not None and self.ways != n_devices:
            raise ValueError(
                f"MeshPlan {self.describe()!r} spans {self.ways} devices; "
                f"{n_devices} available (axis product must match exactly)")
        if model_cfg is not None and self.tp > 1:
            tensor.check_tp_divisibility(model_cfg, self.tp)
        if seq_len is not None and self.sp > 1 and seq_len % self.sp:
            raise ValueError(f"MeshPlan sp={self.sp} must divide the "
                             f"sequence length {seq_len}")


def plan_feasible(dp: int, fsdp: int, tp: int, sp: int, *,
                  n_devices: int, n_heads: int | None = None,
                  n_kv_heads: int | None = None,
                  seq_len: int | None = None) -> bool:
    """:meth:`MeshPlan.validate` over plain ints, as a boolean."""
    if dp * fsdp * tp * sp != n_devices:
        return False
    if tp > 1:
        for heads in (n_heads, n_kv_heads):
            if heads is not None and heads % tp:
                return False
    if sp > 1 and seq_len is not None and seq_len % sp:
        return False
    return True


# -------------------------------------------------------------- the build

@dataclasses.dataclass
class ComposableBuild:
    """What a driver needs to run one plan: the step, this rank's state
    at rest, the grid's axes, the strategy its rules and contract are
    keyed on, and the knobs its generated contract reads
    (``analysis.contract_gen.Ctx``)."""
    plan: MeshPlan               # normalized
    strategy: str                # RuleSet / contract name
    axes: dict                   # axis name -> utils.mesh.Axis
    step: Callable
    params: Any                  # this rank's shards (or the full params)
    opt_state: Any
    contract_kwargs: dict = dataclasses.field(default_factory=dict)


def grid_names(plan: MeshPlan) -> tuple:
    """The grid's axis names for ``plan``: dp × fsdp × tp for the 3-axis
    step, (dp, tp) and (dp, sp) for the two-axis steps (size-1 axes
    too, as their hand factories take them), else the active axes."""
    p = plan.normalized()
    strategy = p.strategy_name()
    if strategy == "composable_dp_fsdp_tp":
        return THREE_AXES
    if strategy in ("tp", "sp"):
        return ("dp", strategy)
    return tuple(p.mesh_axes())


def plan_grid(plan: MeshPlan) -> dict:
    """``utils.mesh.grid_axes`` over :func:`grid_names`, in the
    reference mesh's order."""
    names = grid_names(plan)
    return mesh.grid_axes(names, [getattr(plan.normalized(), a)
                                  for a in names])


def _index_over(axes) -> tuple[int, int]:
    """This rank's index and the count of a dim sharded over ``axes``
    flattened in order (``utils.mesh.shard_rows``)."""
    index, count = 0, 1
    for ax in axes:
        index = index * mesh.axis_size(ax) + mesh.axis_rank(ax)
        count *= mesh.axis_size(ax)
    return index, count


def shard_params_by_rules(params: dict, strategy: str, axes: dict,
                          role: str = "params"):
    """A full (replicated) tree → this rank's shards, as the strategy's
    rules place them: each sharded dim cut to this rank's contiguous
    chunk over the axes its spec names (``axes``: name → Axis)."""
    specs = R.RULESETS[strategy].partition_specs(params, role)

    def cut(x, spec):
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, (tuple, list)) else (entry,)
            idx, n = _index_over([axes[a] for a in names])
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {x.shape[dim]} not "
                                 f"divisible by {names} = {n}")
            m = x.shape[dim] // n
            x = x.narrow(dim, idx * m, m)
        return x.clone()

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return cut(tree, spec)
    return walk(params, specs)


def _mlp_chunk_loss(params, axis):
    """ZeRO-3's chunked loss for the toy-MLP tree (a list of ``{"w",
    "b"}`` layers)."""
    if not (isinstance(params, (list, tuple)) and params
            and all(isinstance(layer, dict) and set(layer) == {"w", "b"}
                    for layer in params)):
        raise ValueError(
            "MeshPlan w=3 w_layout='flat' (zero3) auto-builds its chunked "
            "loss for the toy-MLP tree only (list of {'w','b'} layers); "
            "pass a transformer plan w_layout='named' instead, or use "
            "zero.make_zero3_train_step directly with a custom chunk loss")
    shapes = [{k: tuple(v.shape) for k, v in layer.items()}
              for layer in params]
    return zero.make_zero3_mlp_loss(shapes, axis)


def make_composable_train_step(
    params,
    plan: MeshPlan,
    *,
    axes: dict | None = None,
    model_cfg: T.TransformerConfig | None = None,
    loss_fn: Callable | None = None,
    rebuild: str = "broadcast",
    overlap: str = "none",
    accum_steps: int = 1,
) -> ComposableBuild:
    """Resolve ``plan`` to one build on this rank.

    ``params`` enter full (replicated); the build places them at rest
    itself.  ``axes``: the grid (:func:`plan_grid`, made here when
    None).  ``model_cfg`` is needed by the transformer plans (fsdp,
    tp, sp, dp × fsdp × tp), ``loss_fn`` by the replicated-param data
    plans (ddp, zero1, zero2).  Legacy plans run the hand factories with
    their own defaults; dp × fsdp × tp runs :func:`make_dp_fsdp_tp_step`.
    """
    p = plan.normalized()
    strategy = p.strategy_name()
    axes = plan_grid(p) if axes is None else axes
    want = grid_names(p)
    got = {a: mesh.axis_size(axes[a]) for a in want if a in axes}
    if got != {a: getattr(p, a) for a in want}:
        raise ValueError(f"axes {got} do not realize MeshPlan "
                         f"{p.describe()!r} (want {want})")
    kw: dict = {}

    if strategy in ("composable_dp_fsdp_tp", "tp", "sp", "fsdp"):
        if model_cfg is None:
            raise ValueError(f"a {strategy} plan is a transformer plan; "
                             f"pass model_cfg")
        kw = {"accum_steps": accum_steps}
        if strategy == "composable_dp_fsdp_tp":
            shards = shard_params_by_rules(params, strategy, axes)
            step = make_dp_fsdp_tp_step(
                shards, model_cfg, dp_axis=axes["dp"],
                fsdp_axis=axes["fsdp"], tp_axis=axes["tp"],
                overlap=overlap, accum_steps=accum_steps, loss_fn=loss_fn)
            kw["overlap"] = overlap
        elif strategy == "tp":
            shards = tensor.shard_params_tp(params, axes["tp"])
            step = tensor.make_tp_train_step(
                shards, model_cfg, dp_axis=axes["dp"], tp_axis=axes["tp"],
                overlap=overlap, accum_steps=accum_steps, loss_fn=loss_fn)
            kw["overlap"] = overlap
        elif strategy == "sp":
            shards = fsdp.shard_params_fsdp(params, axes["dp"])
            step = sequence.make_sp_train_step(
                shards, model_cfg, dp_axis=axes["dp"], sp_axis=axes["sp"],
                accum_steps=accum_steps)
        else:
            shards = fsdp.shard_params_fsdp(params, axes["dp"])
            step = fsdp.make_fsdp_train_step(
                shards, model_cfg, axes["dp"], overlap=overlap,
                accum_steps=accum_steps)
            kw["overlap"] = overlap
        return ComposableBuild(p, strategy, axes, step, shards,
                               fsdp.init_fsdp_opt_state(shards), kw)

    # -------- 1-D data parallel: the W degree is the strategy ----------
    axis = axes["dp"]
    if strategy == "zero3":
        chunk_loss = _mlp_chunk_loss(params, axis) if loss_fn is None \
            else loss_fn
        opt_state = zero.init_zero_opt_state(params, axis)
        step = zero.make_zero3_train_step(chunk_loss, axis)
        chunks = zero.shard_params_zero3(params, axis)
        return ComposableBuild(p, strategy, axes, step, chunks, opt_state)
    if loss_fn is None:
        raise ValueError(f"a replicated-param data-parallel plan "
                         f"({strategy}) needs loss_fn")
    if strategy in ("composable_zero1", "zero2"):
        stage = 1 if strategy == "composable_zero1" else 2
        step = zero.make_zero_train_step(loss_fn, axis, stage=stage,
                                         rebuild=rebuild)
        return ComposableBuild(p, strategy, axes, step, params,
                               zero.init_zero_opt_state(params, axis),
                               {"rebuild": rebuild})
    assert strategy == "ddp", strategy
    step = make_ddp_train_step(
        loss_fn, lambda g, s, p_: optim.adam_update(g, s, p_), axis)
    return ComposableBuild(p, strategy, axes, step, params,
                           optim.adam_init(params))


# ------------------------------------------------- the new 3-axis step

def make_dp_fsdp_tp_value_and_grad(
    shards: dict,
    cfg: T.TransformerConfig,
    *,
    dp_axis="dp",
    fsdp_axis="fsdp",
    tp_axis="tp",
    overlap: str = "none",
    accum_steps: int = 1,
    loss_fn: Callable | None = None,
):
    """``(shards, global batch) -> (loss, grads)`` over dp × fsdp × tp:
    the step of :func:`make_dp_fsdp_tp_step` before its Adam update,
    the loss meaned and the grads synced."""
    tensor.check_tp_divisibility(cfg, mesh.axis_size(tp_axis))
    if overlap not in ("none", "ring"):
        raise ValueError(f"overlap={overlap!r}: the 3-axis step composes "
                         f"'none' or 'ring' tp rejoins")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    T.check_supported(cfg)
    rs = THREE_AXIS_RULES
    named = dict(zip(rs.axes, (dp_axis, fsdp_axis, tp_axis)))
    # the rules' axis names, as the axes call themselves
    rename = {a: mesh.resolve_axis(ax).name for a, ax in named.items()}

    def renamed(spec):
        if isinstance(spec, dict):
            return {k: renamed(v) for k, v in spec.items()}
        return tuple(rename.get(e, e) if isinstance(e, str) else e
                     for e in spec)

    specs = renamed(rs.partition_specs(shards, "params"))
    # inside a layer each stacked leaf has lost its layer dim
    hook_specs = {k: s[1:] for k, s in specs["layers"].items()}
    tp_name = rename["tp"]
    n_total = (mesh.axis_size(dp_axis) * mesh.axis_size(fsdp_axis)
               * mesh.axis_size(tp_axis))
    everything = mesh.span(dp_axis, fsdp_axis, tp_axis)
    dp_tp = mesh.span(dp_axis, tp_axis)
    base_loss = loss_fn or T.lm_loss
    layer_body = functools.partial(T._layer_body, tp_axis=tp_axis,
                                   tp_overlap=overlap)

    def layer_hook(layer):
        with record_function("fsdp_layer_gather"):
            return {k: fsdp._gather_leaf(v, hook_specs[k], fsdp_axis)
                    for k, v in layer.items()}

    def sharded_loss(shards_, batch):
        with record_function("fsdp_root_gather"):
            outer = {k: fsdp._gather_leaf(v, specs[k], fsdp_axis)
                     for k, v in shards_.items() if k != "layers"}
        return base_loss({**outer, "layers": shards_["layers"]}, batch, cfg,
                         layer_hook=layer_hook, layer_body=layer_body)

    def value_and_grad(shards_, batch):
        with record_function("forward_backward"):
            loss, grads = fsdp.microbatch_value_and_grad(
                sharded_loss, shards_,
                mesh.shard_rows(batch, dp_axis, fsdp_axis), accum_steps)
        with record_function("loss_mean"):
            loss = C.all_reduce(loss, everything, mean=True)
        with record_function("grad_sync"):
            # fsdp's sum arrived through the gathers' reduce_scatters;
            # the dp replicas, and the tp replicas of a tp-replicated
            # leaf, are summed here; then the mean over the grid
            synced = [C.all_reduce(g, dp_axis if tp_name in R.spec_axes(
                optim.tree_get(specs, path)) else dp_tp) / n_total
                for path, g in optim.tree_leaves(grads)]
        return loss, optim.tree_unflatten(grads, synced)

    return value_and_grad


def make_dp_fsdp_tp_step(
    shards: dict,
    cfg: T.TransformerConfig,
    *,
    dp_axis="dp",
    fsdp_axis="fsdp",
    tp_axis="tp",
    overlap: str = "none",
    accum_steps: int = 1,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    loss_fn: Callable | None = None,
):
    """``step(shards, opt_state, batch) -> (shards, opt_state, loss)``
    over dp × fsdp × tp, ``batch`` = (input_ids, labels), the GLOBAL
    batch; ``shards`` this rank's, as :func:`shard_params_by_rules`
    places them.

    Each rank takes its rows of the batch over ``(dp, fsdp)`` jointly;
    the root leaves are gathered over fsdp up front and each layer's
    leaves in ``model.layer_hook`` inside the checkpointed layer (the
    recompute gathers again; each gather's backward reduce_scatters the
    grads over fsdp); the layer body is Megatron's over ``tp`` with the
    ``overlap`` rejoins (``"none"`` or ``"ring"``).  The loss is the
    mean over the three axes; each grad is summed over dp, and over tp
    too where the leaf is tp-replicated (a tp-sharded leaf's grad
    already carries the rejoins' backward all_reduce over tp), then
    divided by dp · fsdp · tp; Adam runs in place."""
    value_and_grad = make_dp_fsdp_tp_value_and_grad(
        shards, cfg, dp_axis=dp_axis, fsdp_axis=fsdp_axis, tp_axis=tp_axis,
        overlap=overlap, accum_steps=accum_steps, loss_fn=loss_fn)

    def step(shards_, opt_state, batch):
        loss, grads = value_and_grad(shards_, batch)
        with record_function("opt_step"):
            shards_, opt_state = optim.adam_update(
                grads, opt_state, shards_, lr=lr, b1=b1, b2=b2, eps=eps)
        return shards_, opt_state, loss

    return step
