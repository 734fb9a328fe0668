"""Rule-based sharding: ordered regex partition rules as the source of
truth for where every leaf lives.

Port of the JAX package's ``analysis/rules.py``.  Every strategy the
port runs is described by a :class:`RuleSet`: ordered ``(regex, spec)``
partition rules over ``/``-joined leaf paths (``layers/wq``,
``mu/0/w``) on a ``dp × fsdp × tp × sp × ep × pp`` grid, from which the
spec trees of the params, the optimizer state and the batch
(:meth:`RuleSet.partition_specs`) and the collective calls a step
(``analysis.contract_gen``) are derived.

A spec is the port's spec: a tuple with one entry a dim, None
(unsharded), an axis name, or a tuple of axis names (a dim sharded over
several axes flattened in order, as ``utils.mesh.shard_rows`` takes
them), as ``parallel.fsdp.fsdp_specs`` makes them.  The reference's
``to_partition_spec`` (its only jax contact) has no counterpart.

The ZeRO family is one ``weight_update_sharding`` axis (arXiv:2004.13336):
W0 replicates the update (ddp), W1 shards the optimizer state (zero1),
W2 the gradient reduction too (zero2), W3 the weights at rest (zero3 in
flat owner chunks, fsdp by named dims).

Matching is first match wins; scalars are never partitioned.  Rule
hygiene is part of it: an **unmatched leaf** is an error, a rule that
**never matches** a warning, a rule every one of whose hits an earlier
rule already claimed (**shadowed**) an error;
:meth:`MatchReport.describe` dumps which rule claimed each leaf.

Trees are the port's: dicts (walked in sorted key order, as the
reference's flatten walks them), lists and tuples (the index), and
``optim.AdamState`` (``mu``, ``nu``, ``count``).  Only ``.shape`` is
read.  The serving rulesets (``serve_decode``, ``serve_decode_paged_
kernel``, ``serve_decode_spec``, ``serve_prefill_flash``) place the
tensor-parallel serving engine's weights (``serving/engine.py`` with
``mesh``).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Mapping

# a spec: one entry a dim, None, an axis name or a tuple of axis names
Spec = tuple


@dataclass(frozen=True)
class Rule:
    """One ordered partition rule: leaves whose ``/``-joined path matches
    ``pattern`` (``re.search``) take ``spec``, first match wins."""
    pattern: str
    spec: Spec
    note: str = ""

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


def spec_axes(spec: Spec) -> set:
    """Every mesh axis a spec names."""
    out = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            out.update(entry)
        else:
            out.add(entry)
    return out


def tile_dims(spec: Spec, ndim: int, axis_sizes: Mapping[str, int]
              ) -> tuple:
    """The tile factor of each of ``ndim`` dims under ``spec`` on a grid
    of ``axis_sizes``: how many ways each dim is split."""
    tiles = []
    for d in range(ndim):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            tiles.append(1)
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        tiles.append(int(math.prod(int(axis_sizes.get(a, 1))
                                   for a in axes)))
    return tuple(tiles)


def spec_str(spec: Spec) -> str:
    """Human form of a spec tuple: ``P('dp', None)``."""
    inner = ", ".join(
        "None" if e is None
        else ("(" + ",".join(repr(a) for a in e) + ")"
              if isinstance(e, (tuple, list)) else repr(e))
        for e in spec)
    return f"P({inner})"


# ---------------------------------------------------------------- paths

def _children(tree):
    """``(key, child)`` pairs of a container, None for a leaf: dicts in
    sorted key order, lists and tuples by index, ``AdamState`` by
    field."""
    if isinstance(tree, dict):
        return sorted(tree.items())
    if hasattr(tree, "_fields") and hasattr(tree, "mu"):   # AdamState
        return [(f, getattr(tree, f)) for f in tree._fields]
    if type(tree) in (list, tuple):
        return list(enumerate(tree))
    return None


def _walk(tree, prefix=()):
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _walk(v, prefix + (k,))


def named_leaf_paths(tree) -> list:
    """``[(path, leaf), ...]``: every leaf of ``tree`` under its
    ``/``-joined path, in the reference's flatten order."""
    return [("/".join(map(str, p)), leaf) for p, leaf in _walk(tree)]


def _leaf_shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()) or ())


def _is_scalar(leaf) -> bool:
    shape = _leaf_shape(leaf)
    return len(shape) == 0 or math.prod(shape) <= 1


# ---------------------------------------------------------------- matching

@dataclass(frozen=True)
class MatchedLeaf:
    path: str
    shape: tuple
    spec: Spec
    rule_index: int          # -1: the scalar default (never partitioned)


@dataclass
class MatchReport:
    """One role's tree matched against one rule list, with the hygiene
    verdicts."""
    strategy: str
    role: str                              # "params" | "opt" | "batch"
    matches: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    warnings: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors

    def spec_by_path(self) -> dict:
        return {m.path: m.spec for m in self.matches}

    def describe(self) -> str:
        """Which rule claimed each leaf."""
        lines = [f"[{self.strategy}:{self.role}]"]
        for m in self.matches:
            claim = ("scalar default" if m.rule_index < 0
                     else f"rule #{m.rule_index}")
            lines.append(f"  {m.path:40s} {spec_str(m.spec):24s}"
                         f" <- {claim}")
        for w in self.warnings:
            lines.append(f"  warn: {w}")
        for e in self.errors:
            lines.append(f"  ERROR: {e}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"strategy": self.strategy, "role": self.role,
                "ok": self.ok,
                "leaves": {m.path: spec_str(m.spec)
                           for m in self.matches},
                "errors": list(self.errors),
                "warnings": list(self.warnings)}


def match_partition_rules(rules, named_leaves, *, strategy: str = "",
                          role: str = "params") -> MatchReport:
    """First-match-wins over ``(path, leaf)`` pairs
    (:func:`named_leaf_paths`), with the three hygiene checks."""
    rules = tuple(rules)
    report = MatchReport(strategy=strategy, role=role)
    hits = [[] for _ in rules]       # leaves each rule's regex matches
    claims = [[] for _ in rules]     # leaves each rule claimed
    nonscalar = 0
    for path, leaf in named_leaves:
        if _is_scalar(leaf):
            report.matches.append(
                MatchedLeaf(path, _leaf_shape(leaf), (), -1))
            continue
        nonscalar += 1
        claimed = None
        for i, rule in enumerate(rules):
            if rule.matches(path):
                hits[i].append(path)
                if claimed is None:
                    claimed = i
                    claims[i].append(path)
        if claimed is None:
            report.errors.append(
                f"unmatched leaf {path!r} (shape "
                f"{list(_leaf_shape(leaf))}): no partition rule places "
                f"it — every non-scalar leaf must be claimed")
        else:
            report.matches.append(MatchedLeaf(
                path, _leaf_shape(leaf), rules[claimed].spec, claimed))
    # hygiene of the rule list: only a tree with leaves to claim says
    # anything about the rules
    if nonscalar:
        for i, rule in enumerate(rules):
            if not hits[i]:
                report.warnings.append(
                    f"dead rule #{i} /{rule.pattern}/ -> "
                    f"{spec_str(rule.spec)}: matches no leaf")
            elif not claims[i]:
                shadowers = sorted({
                    j for j in range(i)
                    for p in hits[i] if rules[j].matches(p)
                    and p in claims[j]})
                report.errors.append(
                    f"shadowed rule #{i} /{rule.pattern}/ -> "
                    f"{spec_str(rule.spec)}: every leaf it matches "
                    f"({', '.join(hits[i][:4])}"
                    f"{'…' if len(hits[i]) > 4 else ''}) was already "
                    f"claimed by earlier rule(s) "
                    f"{', '.join(f'#{j} /{rules[j].pattern}/' for j in shadowers)}"
                    f" — reorder or delete it")
    return report


# ---------------------------------------------------------------- rule sets

def mirror_opt_rules(param_rules) -> tuple:
    """Optimizer-state rules from param rules: the Adam moments mirror
    their param's placement (``mu/``, ``nu/`` paths are the param paths
    one level down); the step count falls to the scalar default."""
    out = []
    for r in param_rules:
        body = r.pattern.lstrip("^")
        if body in (r".*", r".+"):
            mp = r"^(mu|nu|momentum)(/|$)"
        else:
            mp = r"^(mu|nu|momentum)/" + body
        out.append(Rule(mp, r.spec, note=f"mirrors param rule "
                                         f"/{r.pattern}/"))
    return tuple(out)


def _rebuild(tree, by_path: dict, prefix=()):
    """``tree``'s structure with every leaf replaced by its spec."""
    kids = _children(tree)
    if kids is None:
        return by_path["/".join(map(str, prefix))]
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, prefix + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "_fields") and hasattr(tree, "mu"):
        return type(tree)(*(_rebuild(v, by_path, prefix + (k,))
                            for k, v in kids))
    return type(tree)(_rebuild(v, by_path, prefix + (k,)) for k, v in kids)


@dataclass(frozen=True)
class RuleSet:
    """One strategy's partition rules a role, and the config knobs its
    contract generation keys on.  ``weight_update_sharding``: 0 the
    replicated update (ddp), 1 sharded optimizer state (zero1), 2 also
    sharded grad reduction (zero2), 3 sharded weights at rest (zero3,
    fsdp)."""
    strategy: str
    family: str              # "data" | "fsdp" | "tp" | "sp" | "moe"
    #                          | "serve" | "composable" | "pipeline"
    axes: tuple              # the axes the strategy's collectives span
    param_rules: tuple
    opt_rules: tuple = ()
    batch_rules: tuple = ()
    weight_update_sharding: int = 0
    config: Mapping = field(default_factory=dict)
    description: str = ""

    def rules_for(self, role: str) -> tuple:
        return {"params": self.param_rules, "opt": self.opt_rules,
                "batch": self.batch_rules}[role]

    def match(self, role: str, tree) -> MatchReport:
        return match_partition_rules(
            self.rules_for(role), named_leaf_paths(tree),
            strategy=self.strategy, role=role)

    def partition_specs(self, tree, role: str = "params"):
        """The spec tree of ``tree`` (raises on a hygiene error: an
        unmatched leaf must not silently replicate)."""
        report = self.match(role, tree)
        if not report.ok:
            raise ValueError(
                f"{self.strategy}:{role} rule hygiene failed:\n"
                + "\n".join(report.errors))
        return _rebuild(tree, report.spec_by_path())


# -- constructors: one a family, the ZeRO variants one config axis -------

def data_parallel_ruleset(strategy: str, *,
                          weight_update_sharding: int = 0,
                          grad_comm: str = "allreduce",
                          axis: str = "dp") -> RuleSet:
    """The toy-MLP data-parallel family: ``weight_update_sharding``
    folds ddp (W0) and zero1/2/3 (W1/W2/W3) into one axis; ``grad_comm``
    the W0 grads' wire (a leaf each, flat buckets, int8 buckets)."""
    w = weight_update_sharding
    if w >= 3:
        param_rules = (Rule(r".*", (axis,),
                            "W3: params at rest are flat owner chunks"),)
    else:
        param_rules = (Rule(r".*", (), "params replicated at rest"),)
    if w >= 1:
        opt_rules = (Rule(r"^(mu|nu|momentum)(/|$)", (axis,),
                          "owner-chunk optimizer moments (ZeRO)"),)
    else:
        opt_rules = mirror_opt_rules(param_rules)
    return RuleSet(
        strategy=strategy, family="data", axes=(axis,),
        param_rules=param_rules, opt_rules=opt_rules,
        batch_rules=(Rule(r".*", (axis,)),),
        weight_update_sharding=w,
        config={"grad_comm": grad_comm},
        description=f"data-parallel, weight_update_sharding=W{w}, "
                    f"grad_comm={grad_comm}")


def fsdp_ruleset(strategy: str, *, axis: str = "dp",
                 overlap: str = "none", offload: str | None = None,
                 precision: str | None = None) -> RuleSet:
    """FSDP: W3 by named dims: stacked ``(L, …)`` layer leaves shard dim
    1 (dim 0 is the layer), plain leaves dim 0.  ``overlap``,
    ``offload`` and ``precision`` change the wire or the memory, never
    the placement."""
    param_rules = (
        Rule(r"^layers/", (None, axis),
             "stacked (L, ...) layer leaves: shard dim 1"),
        Rule(r".*", (axis,), "plain leaves (embed, final_norm): dim 0"),
    )
    return RuleSet(
        strategy=strategy, family="fsdp", axes=(axis,),
        param_rules=param_rules,
        opt_rules=mirror_opt_rules(param_rules),
        batch_rules=(Rule(r".*", (axis,)),),
        weight_update_sharding=3,
        config={"overlap": overlap, "offload": offload,
                "precision": precision},
        description=f"fsdp (W3 by named dim), overlap={overlap}"
                    + (f", offload={offload}" if offload else "")
                    + (f", precision={precision}" if precision else ""))


# the Megatron column / row split of the dense projections
TP_COL_LEAVES = ("wq", "wk", "wv", "w_gate", "w_up")
TP_ROW_LEAVES = ("wo", "w_down")


def tp_ruleset(strategy: str, *, axis: str = "tp", dp_axis: str = "dp",
               overlap: str = "none") -> RuleSet:
    """Megatron TP over the stacked dense layers: column-parallel
    ``(L, in, out)`` leaves shard out, row-parallel in, the rest
    (embedding, norms) replicated."""
    col = "|".join(TP_COL_LEAVES)
    row = "|".join(TP_ROW_LEAVES)
    param_rules = (
        Rule(rf"^layers/({col})$", (None, None, axis),
             "column-parallel projections: shard the out dim"),
        Rule(rf"^layers/({row})$", (None, axis, None),
             "row-parallel projections: shard the in dim"),
        Rule(r".*", (), "embed/norms replicated"),
    )
    return RuleSet(
        strategy=strategy, family="tp", axes=(dp_axis, axis),
        param_rules=param_rules,
        opt_rules=mirror_opt_rules(param_rules),
        batch_rules=(Rule(r".*", (dp_axis,)),),
        weight_update_sharding=0,
        config={"overlap": overlap},
        description=f"megatron tp, overlap={overlap}")


def sp_ruleset(strategy: str, *, axis: str = "sp",
               dp_axis: str = "dp") -> RuleSet:
    """FSDP over dp and ring attention over sp: params and optimizer
    state are the fsdp rules; the batch splits its sequence dim too."""
    base = fsdp_ruleset(strategy, axis=dp_axis)
    return RuleSet(
        strategy=strategy, family="sp", axes=(dp_axis, axis),
        param_rules=base.param_rules, opt_rules=base.opt_rules,
        batch_rules=(Rule(r".*", (dp_axis, axis),
                          "batch split on both dp and sequence"),),
        weight_update_sharding=3,
        config={"sp_axis": axis},
        description="fsdp over dp + ring attention over sp")


def moe_ruleset(strategy: str, *, axis: str = "ep",
                dp_axis: str = "dp") -> RuleSet:
    """Switch-MoE: the expert banks ``(L, E, …)`` shard E; the router
    and every dense leaf replicated; the batch over (dp, ep)."""
    param_rules = (
        Rule(r"^layers/(w_gate|w_up|w_down)$", (None, axis),
             "expert-stacked (L, E, ...) FFN leaves: shard dim 1 (E)"),
        Rule(r".*", (), "router + dense leaves replicated"),
    )
    return RuleSet(
        strategy=strategy, family="moe", axes=(dp_axis, axis),
        param_rules=param_rules,
        opt_rules=mirror_opt_rules(param_rules),
        batch_rules=(Rule(r".*", ((dp_axis, axis),),
                          "batch over the flattened (dp, ep) axis"),),
        weight_update_sharding=0,
        config={},
        description="switch-moe, experts sharded over ep")


def serve_ruleset(strategy: str, *, axis: str = "tp",
                  paged_kernel: bool = False,
                  step: str = "decode") -> RuleSet:
    """Serving steps: the Megatron weights at rest over tp, inference
    only (no optimizer state; the KV pool and the request vectors ride
    outside the rule universe).  ``step`` names the engine step —
    "decode" (one token a slot), "spec_verify" (the (B, k+1)
    speculative verify) or "prefill_flash" (the batched flash prefill
    chunk); all share the layer body's two rejoins, unrolled over
    depth."""
    base = tp_ruleset(strategy, axis=axis)
    return RuleSet(
        strategy=strategy, family="serve", axes=(axis,),
        param_rules=base.param_rules,
        weight_update_sharding=0,
        config={"paged_kernel": paged_kernel, "step": step},
        description=f"serving {step} over tp"
                    + (", paged-attention kernel" if paged_kernel else ""))


def composable_ruleset(strategy: str, *, dp_axis: str = "dp",
                       fsdp_axis: str = "fsdp", tp_axis: str = "tp",
                       overlap: str = "none") -> RuleSet:
    """The dp × fsdp × tp step (``parallel.composable``): the Megatron
    role on the dim each projection contracts last, FSDP's named-dim W3
    on the other — column-parallel ``(L, in⊘fsdp, out⊘tp)``,
    row-parallel ``(L, in⊘tp, out⊘fsdp)`` — norms and plain leaves
    fsdp only, the batch over ``(dp, fsdp)`` jointly (tp sees
    replicas)."""
    col = "|".join(TP_COL_LEAVES)
    row = "|".join(TP_ROW_LEAVES)
    param_rules = (
        Rule(rf"^layers/({col})$", (None, fsdp_axis, tp_axis),
             "column-parallel (L, in, out): fsdp shards in, tp shards "
             "out"),
        Rule(rf"^layers/({row})$", (None, tp_axis, fsdp_axis),
             "row-parallel (L, in, out): tp shards in, fsdp shards out"),
        Rule(r"^layers/", (None, fsdp_axis),
             "other stacked leaves (norms): fsdp shards dim 1"),
        Rule(r".*", (fsdp_axis,),
             "plain leaves (embed, final_norm): fsdp shards dim 0"),
    )
    return RuleSet(
        strategy=strategy, family="composable",
        axes=(dp_axis, fsdp_axis, tp_axis),
        param_rules=param_rules,
        opt_rules=mirror_opt_rules(param_rules),
        batch_rules=(Rule(r".*", ((dp_axis, fsdp_axis),),
                          "batch over the flattened (dp, fsdp) axis, "
                          "replicated over tp"),),
        weight_update_sharding=3,
        config={"overlap": overlap},
        description="composable dp×fsdp×tp (named-dim W3 × megatron tp)"
                    + (f", overlap={overlap}" if overlap != "none"
                       else ""))


def pipeline_ruleset(strategy: str, *, schedule: str | None = None
                     ) -> RuleSet:
    """Pipeline stages: every leaf stage-local, no collectives."""
    return RuleSet(
        strategy=strategy, family="pipeline", axes=(),
        param_rules=(Rule(r".*", (), "stage-local, no mesh"),),
        weight_update_sharding=0,
        config={"schedule": schedule or strategy},
        description="pipeline stage programs (host-mediated transfers)")


RULESETS: dict[str, RuleSet] = {
    "ddp": data_parallel_ruleset("ddp", weight_update_sharding=0),
    "ddp_bucketed": data_parallel_ruleset(
        "ddp_bucketed", weight_update_sharding=0, grad_comm="bucketed"),
    "ddp_q8": data_parallel_ruleset(
        "ddp_q8", weight_update_sharding=0, grad_comm="q8"),
    "zero1": data_parallel_ruleset("zero1", weight_update_sharding=1),
    "zero2": data_parallel_ruleset("zero2", weight_update_sharding=2),
    "zero3": data_parallel_ruleset("zero3", weight_update_sharding=3),
    "fsdp": fsdp_ruleset("fsdp"),
    "fsdp_q8": fsdp_ruleset("fsdp_q8", precision="int8"),
    "fsdp_ring_fused_pallas": fsdp_ruleset(
        "fsdp_ring_fused_pallas", overlap="ring_fused_pallas"),
    "fsdp_ring": fsdp_ruleset("fsdp_ring", overlap="ring"),
    "tp_ring": tp_ruleset("tp_ring", overlap="ring"),
    "tp_q8": tp_ruleset("tp_q8", overlap="q8"),
    "tp": tp_ruleset("tp"),
    "sp": sp_ruleset("sp"),
    "moe": moe_ruleset("moe"),
    "serve_decode": serve_ruleset("serve_decode"),
    "serve_decode_paged_kernel": serve_ruleset(
        "serve_decode_paged_kernel", paged_kernel=True),
    "serve_decode_spec": serve_ruleset(
        "serve_decode_spec", step="spec_verify"),
    "serve_prefill_flash": serve_ruleset(
        "serve_prefill_flash", paged_kernel=True, step="prefill_flash"),
    "gpipe": pipeline_ruleset("gpipe"),
    "1f1b": pipeline_ruleset("1f1b"),
    # the composable step's: their contracts come from the generator
    # only; composable_zero1 replays zero1's wire, composable_dp_fsdp_tp
    # is the 3-axis step
    "composable_zero1": data_parallel_ruleset(
        "composable_zero1", weight_update_sharding=1),
    "composable_dp_fsdp_tp": composable_ruleset("composable_dp_fsdp_tp"),
}


# ---------------------------------------------------------------- verdict

def rules_manifest_verdict(strategy: str, *, params=None, opt=None,
                           batch=None, full=None,
                           axis_sizes: Mapping[str, int] | None = None
                           ) -> dict:
    """The verdict a run records in its manifest: rule hygiene over the
    live trees, and each live shard's tile factors (``full``'s dim over
    the shard's, ``full`` the unsharded params) against its rule spec's
    on a grid of ``axis_sizes``.  The reference reads each leaf's
    ``NamedSharding``; a shard here knows only its shape, so the full
    shapes stand in for the sharding."""
    rs = RULESETS.get(strategy)
    if rs is None:
        return {"strategy": strategy, "ok": False,
                "error": f"no RuleSet registered for {strategy!r}"}
    verdict: dict = {"strategy": strategy, "ok": True, "checked": 0,
                     "mismatches": [], "hygiene": []}
    whole = dict(named_leaf_paths(full)) if full is not None else {}
    for role, tree in (("params", params), ("opt", opt),
                       ("batch", batch)):
        if tree is None:
            continue
        report = rs.match(role, tree)
        verdict["hygiene"].append(report.to_dict())
        if not report.ok:
            verdict["ok"] = False
            continue
        if role != "params" or not whole:
            continue
        by_path = report.spec_by_path()
        for path, leaf in named_leaf_paths(tree):
            if path not in whole or _is_scalar(leaf):
                continue
            got, want_shape = _leaf_shape(leaf), _leaf_shape(whole[path])
            if len(got) != len(want_shape):   # flat chunks: compare sizes
                got_tiles = (-(-math.prod(want_shape)
                               // max(math.prod(got), 1)),)
                want_tiles = (math.prod(tile_dims(
                    by_path[path], 1, axis_sizes or {})),)
            else:
                got_tiles = tuple(w // max(g, 1)
                                  for w, g in zip(want_shape, got))
                want_tiles = tile_dims(by_path[path], len(got),
                                       axis_sizes or {})
            verdict["checked"] += 1
            if got_tiles != want_tiles:
                verdict["ok"] = False
                verdict["mismatches"].append(
                    f"{role}/{path}: live shard {list(got)} of "
                    f"{list(want_shape)} (tiles {list(got_tiles)}), rules "
                    f"derive {spec_str(by_path[path])} (tiles "
                    f"{list(want_tiles)})")
    return verdict
