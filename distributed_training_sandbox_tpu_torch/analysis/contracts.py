"""Per-strategy collective contracts and their verdict.

Port of the JAX package's ``analysis/contracts.py``.  A
:class:`CollectiveContract` states what one optimizer step of a strategy
may put on the wire: how many calls of each collective kind, over which
axes, and roughly how many bytes.  The reference counts the *sites* of
one compiled step; the port counts the *calls* one step makes, as the
shim ``ops.collectives.COLLECTIVES`` records them, so each contract's
counts are the port's call formulas: ``parallel/contracts.py`` for the
hand-written strategies (through ``analysis.contract_gen.HAND``, which
maps each strategy to its formula) and the generator of
``analysis/contract_gen.py`` for the composable ones.  On the toy-MLP
strategies, which have no layer loop, calls and sites agree, and the
reference's own contracts judge the port's calls.

The verdict half is the reference's: :func:`check_counts` compares
observed counts with a contract's expectation (an int exact, a ``(lo,
hi)`` range inclusive, None unchecked; a kind the contract omits must be
0) and returns a :class:`ContractVerdict` whose ``summary()`` and
``to_dict()`` are the reference's, strings and serialisation (``"lo..hi"``,
``"any"``) alike.  The shim has one kind the reference lacks
(``broadcast``); it follows the reference's kinds, and a verdict names it
only where the contract expects it or a step made it, so on the
reference's kinds a verdict serialises as the reference's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import torch

from ..ops.collectives import CollectiveCounts
from ..parallel import contracts as HC
from ..parallel.optim import tree_map
from ..utils import mesh
from . import contract_gen as G
from .rules import RULESETS, named_leaf_paths

KINDS = CollectiveCounts.KINDS
# the reference's kinds, in its order (its verdicts and ledgers list them
# so); a kind only the shim has follows them
REFERENCE_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
                   "collective_permute", "all_to_all")
_ORDER = REFERENCE_KINDS + tuple(k for k in KINDS
                                 if k not in REFERENCE_KINDS)
# the knobs of ``contract_gen.Ctx`` a context's ``extra`` may set
_KNOBS = ("remat", "accum_steps", "reshard_after_forward", "overlap",
          "rebuild", "bucket_mb", "quantized_grads", "z_loss")
A12B = "ROADMAP.md queue A item A12b (memory_plan/)"


def meta_tree(params):
    """A shapes-only copy of a tensor tree: what a contract reads, none of
    the tensors' storage."""
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta")
                    if isinstance(x, torch.Tensor) else x, params)


@dataclass(frozen=True)
class ContractContext:
    """Everything a contract may depend on, captured from the run being
    checked: world size, axis sizes, the parameter tree's leaf count and
    bytes, and the strategy's knobs (``extra``: ``rebuild``,
    ``bucket_mb``, ``overlap``, ``remat``, ``accum_steps``, ...).

    ``tree`` is the port's addition: the param tree's shapes, which the
    call formulas read (a call count depends on the layer count and each
    leaf's rank, where the reference's scanned sites do not).  Without
    one, a contract reads a TINY_LM-shaped tree of ``n_layers`` layers
    (``contract_gen._tiny_tree``), or for the toy-MLP family an MLP of
    ``n_leaves`` leaves."""
    ws: int = 1
    axis_sizes: Mapping[str, int] = field(default_factory=dict)
    n_leaves: int = 0
    n_layers: int = 0
    param_bytes: int = 0
    extra: Mapping[str, Any] = field(default_factory=dict)
    tree: Any = field(default=None, repr=False, compare=False)

    @classmethod
    def capture(cls, *, params=None, axes=None, n_layers: int = 0,
                **extra) -> "ContractContext":
        """From a torch param tree (full or this rank's shards) and the
        port's axes (``utils.mesh``: a ``{name: axis}`` dict, as
        ``grid_axes`` returns, an axis being a name, an ``Axis`` or a
        size)."""
        n_leaves = param_bytes = 0
        tree = None
        if params is not None:
            leaves = [x for _, x in named_leaf_paths(params)
                      if hasattr(x, "shape")]
            n_leaves = len(leaves)
            param_bytes = int(sum(x.numel() * x.element_size()
                                  for x in leaves))
            tree = meta_tree(params)
        axis_sizes = {name: ax if isinstance(ax, int) else
                      mesh.axis_size(ax) for name, ax in (axes or {}).items()}
        ws = int(math.prod(axis_sizes.values())) if axis_sizes else 1
        return cls(ws=ws, axis_sizes=axis_sizes, n_leaves=n_leaves,
                   n_layers=n_layers, param_bytes=param_bytes, extra=extra,
                   tree=tree)


@dataclass(frozen=True)
class CollectiveContract:
    """Declarative choreography of one strategy's train step.

    ``counts(ctx)`` maps collective kind -> expected calls a step: an int
    (exact), a ``(lo, hi)`` range (inclusive), or None (unchecked).
    Kinds missing from the dict are expected to be 0.  ``axes``: the axes
    its collectives may span.  ``allows_full_param_gather``: strategies
    that materialise full params by design (ZeRO-3, FSDP, SP).
    ``payload_bytes(ctx)``: approximate bytes a step on the wire
    (informational).  ``host_transfers(ctx)``: a host-offload budget
    (``fsdp_offload``; the memory planner, A12b)."""
    strategy: str
    axes: tuple[str, ...]
    counts: Callable[[ContractContext], dict]
    allows_full_param_gather: bool = False
    payload_bytes: Callable[[ContractContext], int] | None = None
    host_transfers: Callable[[ContractContext], dict] | None = None
    description: str = ""


# ---------------------------------------------------------------- registry

def _gen_ctx(c: ContractContext) -> G.Ctx:
    return G.Ctx(dict(c.axis_sizes),
                 **{k: c.extra[k] for k in _KNOBS if k in c.extra})


def _lm_tree(c: ContractContext, experts: int = 0):
    if c.tree is not None:
        return c.tree
    return G._tiny_tree(c.n_layers or 4, experts=experts)


def _mlp_tree(c: ContractContext):
    if c.tree is not None:
        return c.tree
    return G._mlp_tree((8,) * (max(c.n_leaves, 2) // 2 + 1))


def _data(kind: str, *, q8: bool = False, bucketed: bool = False):
    """The toy-MLP family: ``parallel.contracts.step_collectives`` on the
    context's leaf count and bytes (the knobs ``rebuild`` and, for the
    bucketed wires, ``bucket_mb``)."""
    def counts(c: ContractContext) -> dict:
        bucket = c.extra.get("bucket_mb") if bucketed or q8 else None
        return HC.step_collectives(
            kind, c.n_leaves, c.param_bytes, q8=q8,
            rebuild=c.extra.get("rebuild", "broadcast"),
            bucket_mb=(bucket or 25.0) if bucketed else bucket)
    return counts


def _hand(formula: str, experts: int = 0):
    """A transformer strategy's calls: its ``contract_gen.HAND`` formula
    on the context's tree and knobs."""
    return lambda c: G.HAND[formula](_lm_tree(c, experts), _gen_ctx(c))


def _generated(strategy: str):
    """The calls ``contract_gen.generate_counts`` derives from the
    strategy's RuleSet."""
    family = RULESETS[strategy].family

    def counts(c: ContractContext) -> dict:
        tree = _mlp_tree(c) if family == "data" else _lm_tree(c)
        return G.generate_counts(strategy, tree, _gen_ctx(c))
    return counts


def _offload_host_transfers(c: ContractContext) -> dict:
    raise NotImplementedError(
        "fsdp_offload's host-transfer budget reads the memory planner's "
        f"OffloadPlan, which is not ported yet — see {A12B}")


def generated_contract(strategy: str) -> CollectiveContract:
    """The contract generated from ``RULESETS[strategy]`` (the reference's
    ``contract_gen.generate_contract``): the generator's calls, the
    RuleSet's axes, full-param gathers where weights are sharded at rest,
    the reference's payload estimate."""
    rs = RULESETS.get(strategy)
    if rs is None:
        raise KeyError(f"no RuleSet registered for {strategy!r}; "
                       f"have {sorted(RULESETS)}")
    payload = None
    if rs.family == "data":
        w = rs.weight_update_sharding
        if w == 0 and rs.config.get("grad_comm") == "q8":
            payload = lambda c: c.param_bytes // 4   # noqa: E731
        else:
            payload = ((lambda c: 2 * c.param_bytes) if w == 0
                       else (lambda c: 3 * c.param_bytes))
    elif rs.family == "fsdp":
        payload = lambda c: 3 * c.param_bytes   # noqa: E731
    return CollectiveContract(
        strategy, tuple(rs.axes), _generated(strategy),
        allows_full_param_gather=(rs.weight_update_sharding >= 3
                                  or rs.family in ("fsdp", "sp")),
        payload_bytes=payload,
        description=f"generated from RuleSet[{strategy}]: "
                    f"{rs.description}")


def _three(c):
    return 3 * c.param_bytes


CONTRACTS: dict[str, CollectiveContract] = {
    "ddp": CollectiveContract(
        "ddp", ("dp",), _data("ddp"),
        payload_bytes=lambda c: 2 * c.param_bytes,
        description="per-leaf grad all_reduce + loss mean + barrier; no "
                    "gathers (params replicated at rest)"),
    "ddp_bucketed": CollectiveContract(
        "ddp_bucketed", ("dp",), _data("ddp", bucketed=True),
        payload_bytes=lambda c: 2 * c.param_bytes,
        description="one grad all_reduce a flat bucket + loss mean + "
                    "barrier; no gathers"),
    "ddp_q8": CollectiveContract(
        "ddp_q8", ("dp",), _data("ddp", q8=True),
        payload_bytes=lambda c: c.param_bytes // 4,
        description="2 all_gathers (int8 codes + scale) a flat grad "
                    "bucket + loss mean + barrier"),
    "zero1": CollectiveContract(
        "zero1", ("dp",), _data("zero1"), payload_bytes=_three,
        description="n grad all_reduces + n param rebuilds + loss + "
                    "barrier"),
    "zero2": CollectiveContract(
        "zero2", ("dp",), _data("zero2"), payload_bytes=_three,
        description="n grad reduce_scatters + n param rebuilds + loss + "
                    "barrier"),
    "zero3": CollectiveContract(
        "zero3", ("dp",), _data("zero3"), allows_full_param_gather=True,
        payload_bytes=_three,
        description="2n - 1 gathers (forward, the checkpoint's recompute "
                    "but the last bias), n reduce_scatters, loss + "
                    "barrier"),
    "fsdp": CollectiveContract(
        "fsdp", ("dp",), _hand("fsdp"), allows_full_param_gather=True,
        payload_bytes=_three,
        description="a gather of each leaf where it is used (a layer "
                    "leaf once a layer, again in the recompute), a "
                    "reduce_scatter each gather's backward, one loss "
                    "mean"),
    "fsdp_offload": CollectiveContract(
        "fsdp_offload", ("dp",), _hand("fsdp"),
        allows_full_param_gather=True, payload_bytes=_three,
        host_transfers=_offload_host_transfers,
        description="fsdp's calls + the host-offload budget (A12b)"),
    "fsdp_fp8": CollectiveContract(
        "fsdp_fp8", ("dp",), _hand("fsdp"), allows_full_param_gather=True,
        payload_bytes=_three,
        description="fsdp's calls unchanged: fp8 scaling is local to the "
                    "projections, any call delta is a leak"),
    "fsdp_q8": CollectiveContract(
        "fsdp_q8", ("dp",), _hand("fsdp_q8"),
        allows_full_param_gather=True, payload_bytes=_three,
        description="fsdp with int8 gathers: codes + scales (2 "
                    "all_gathers) for a leaf of two dims or more"),
    "fsdp_ring_fused_pallas": CollectiveContract(
        "fsdp_ring_fused_pallas", ("dp",), _hand("fsdp_ring_fused_pallas"),
        allows_full_param_gather=True, payload_bytes=_three,
        description="the projections as fused ring matmuls (n - 1 hops "
                    "forward and backward), the ring gather + "
                    "reduce_scatter for the rest, one loss mean"),
    "fsdp_ring": CollectiveContract(
        "fsdp_ring", ("dp",), _hand("fsdp_ring"),
        allows_full_param_gather=True, payload_bytes=_three,
        description="n - 1 hops a gathered leaf, a reduce_scatter its "
                    "backward, one loss mean; an all_gather is a "
                    "fallback"),
    "tp_ring": CollectiveContract(
        "tp_ring", ("dp", "tp"), _hand("tp_ring"),
        description="the rejoins as reduce_scatter + (tp - 1) hops, "
                    "their backward all_reduces, a grad all_reduce a "
                    "leaf"),
    "tp_q8": CollectiveContract(
        "tp_q8", ("dp", "tp"), _hand("tp_q8"),
        description="the rejoins as 2 all_gathers each (int8 codes + "
                    "scales), full-precision backward and grads"),
    "tp": CollectiveContract(
        "tp", ("dp", "tp"), _hand("tp"),
        description="2 rejoin all_reduces a layer (forward, recompute, "
                    "backward) + a grad all_reduce a leaf; any "
                    "gather/scatter is a choreography break"),
    "sp": CollectiveContract(
        "sp", ("dp", "sp"), _hand("sp"), allows_full_param_gather=True,
        description="fsdp's calls over dp + the K/V ring's hops + a grad "
                    "all_reduce a leaf over sp"),
    "moe": CollectiveContract(
        "moe", ("dp", "ep"), _hand("moe", experts=8),
        description="4 all_to_alls a layer (dispatch/return × "
                    "forward/backward, the recompute's again) + the aux "
                    "means + a grad all_reduce a leaf"),
    **{name: CollectiveContract(
        name, ("tp",), _hand(name),
        description="2 rejoin all_reduces a layer (the stack unrolled) "
                    "over tp only; the kernels add no call")
       for name in HC.SERVE_STRATEGIES},
    "gpipe": CollectiveContract(
        "gpipe", (), lambda c: {},
        description="stages hand over by device copies: no collective"),
    "1f1b": CollectiveContract(
        "1f1b", (), lambda c: {},
        description="stages hand over by device copies: no collective"),
    **{name: generated_contract(name) for name in G.GENERATED_STRATEGIES},
}


# ---------------------------------------------------------------- checking

def parse_expected_spec(value) -> tuple[int, float]:
    """One value of a serialised verdict's ``expected`` dict
    (``ContractVerdict.to_dict``: int exact, ``"lo..hi"`` range,
    ``"any"``/None unchecked) -> an inclusive ``(lo, hi)`` bound.  The
    measured-side consumers (``telemetry.ledger``'s trace join) re-check
    ranges from a verdict already serialised, so the parse lives next to
    the serialiser."""
    if value is None or value == "any":
        return 0, math.inf
    if isinstance(value, str) and ".." in value:
        lo, hi = value.split("..", 1)
        return int(lo), int(hi)
    if isinstance(value, (tuple, list)):
        return int(value[0]), int(value[1])
    return int(value), int(value)


@dataclass
class ContractVerdict:
    """Outcome of checking observed counts against one contract."""
    strategy: str
    ok: bool
    expected: dict
    observed: dict
    violations: list[str]
    payload_bytes: int | None = None

    def summary(self) -> str:
        if self.ok:
            seen = ", ".join(f"{k}={v}" for k, v in
                             sorted(self.observed.items()) if v)
            return f"OK ({seen})" if seen else "OK (no collectives)"
        return "VIOLATED: " + "; ".join(self.violations)

    def to_dict(self) -> dict:
        return {"strategy": self.strategy, "ok": self.ok,
                "expected": self.expected, "observed": self.observed,
                "violations": self.violations,
                "payload_bytes": self.payload_bytes}


def check_counts(contract: CollectiveContract, observed: Mapping[str, int],
                 ctx: ContractContext) -> ContractVerdict:
    """Compare the shim's observed counts against the contract's
    expectation for ``ctx``.  Kinds the contract omits must be 0; int
    expectations are exact; ``(lo, hi)`` inclusive; None skipped."""
    expected = dict(contract.counts(ctx))
    violations = []
    exp_out, obs = {}, {}
    for kind in _ORDER:
        want = expected.get(kind, 0)
        got = int(observed.get(kind, 0))
        if kind not in REFERENCE_KINDS and not want and not got:
            continue
        obs[kind] = got
        if want is None:
            exp_out[kind] = "any"
            continue
        if isinstance(want, tuple):
            lo, hi = want
            exp_out[kind] = f"{lo}..{hi}"
            if not lo <= got <= hi:
                violations.append(
                    f"{kind}: {got} sites, contract allows {lo}..{hi}")
        else:
            exp_out[kind] = int(want)
            if got != want:
                violations.append(
                    f"{kind}: {got} sites, contract expects {want}")
    payload = (int(contract.payload_bytes(ctx))
               if contract.payload_bytes else None)
    return ContractVerdict(strategy=contract.strategy,
                           ok=not violations, expected=exp_out,
                           observed=obs, violations=violations,
                           payload_bytes=payload)


def evaluate_contract(strategy: str, observed: Mapping[str, int], *,
                      params=None, axes=None, n_layers: int = 0,
                      ctx: ContractContext | None = None,
                      **extra) -> ContractVerdict:
    """One-call form the twins use: look up the registry, capture a
    context from the live params and axes, check the shim's counts of a
    step."""
    if strategy not in CONTRACTS:
        raise KeyError(f"no contract registered for {strategy!r}; "
                       f"have {sorted(CONTRACTS)}")
    if ctx is None:
        ctx = ContractContext.capture(params=params, axes=axes,
                                      n_layers=n_layers, **extra)
    return check_counts(CONTRACTS[strategy], observed, ctx)
