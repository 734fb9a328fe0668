"""The port's contract verdict (``analysis/contracts.py``) against the
JAX package's, on the CPU, in one process.

- The verdict law, bitwise: for every contract of the reference's
  registry (its generated ones too), on one fixed context, observed
  counts that meet the expectation, miss it by one in each kind, and
  fall outside a range give the same ``to_dict()`` and ``summary()``
  from the port's ``check_counts`` as from the reference's, the port's
  contract carrying the reference's expected counts.  A contract with an
  unchecked kind (``"any"``) too.
- ``parse_expected_spec`` equal on every serialised form.
- The port's registry holds every reference strategy and is total over
  an arbitrary context; on the toy-MLP strategies its calls are the
  reference's sites.
- ``evaluate_contract``'s ``rebuild`` knob (reference
  ``tests/test_contracts.py:159``), a verdict in the manifest (``:140``)
  and rewritten there by ``file_contract``, a ``broadcast`` call named
  only where it happens, ``fsdp_offload``'s host budget refused (A12b).
"""

import json

import pytest
import torch

from distributed_training_sandbox_tpu.analysis import contract_gen as JG
from distributed_training_sandbox_tpu.analysis import contracts as JC
from distributed_training_sandbox_tpu_torch.analysis import contracts as PC
from distributed_training_sandbox_tpu_torch.telemetry import TelemetryRun
torch.set_num_threads(1)  # the suite's workers share the cores

assert JG.GENERATED_STRATEGIES[0] in JC.CONTRACTS   # installed at import
REF = sorted(JC.CONTRACTS)
JCTX = JC.ContractContext(ws=8, axis_sizes={"dp": 4, "tp": 2}, n_leaves=12,
                          n_layers=6, param_bytes=1 << 20,
                          extra={"bucket_mb": 0.25})


def _port_twin(ref: "JC.CollectiveContract") -> "PC.CollectiveContract":
    """The reference's contract as a port contract: its expected counts
    and payload on ``JCTX``."""
    counts = ref.counts(JCTX)
    payload = ref.payload_bytes(JCTX) if ref.payload_bytes else None
    return PC.CollectiveContract(
        ref.strategy, ref.axes, lambda c: dict(counts),
        payload_bytes=None if payload is None else (lambda c: payload))


def _observations(expected: dict) -> list[dict]:
    """Counts that meet ``expected``, miss it by one in each kind, and
    fall just outside each range."""
    meet = {}
    for k in JC.KINDS:
        want = expected.get(k, 0)
        meet[k] = want[0] if isinstance(want, tuple) else (want or 0)
    out = [meet]
    for k in JC.KINDS:
        out.append({**meet, k: meet[k] + 1})
        if meet[k]:
            out.append({**meet, k: meet[k] - 1})
        want = expected.get(k, 0)
        if isinstance(want, tuple):
            out.append({**meet, k: want[1]})
            out.append({**meet, k: want[1] + 1})
    return out


def _law(ref, observed):
    got = PC.check_counts(_port_twin(ref), observed, PC.ContractContext())
    want = JC.check_counts(ref, observed, JCTX)
    assert got.to_dict() == want.to_dict()
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert got.summary() == want.summary()
    return want


@pytest.mark.parametrize("strategy", REF)
def test_the_verdict_law_is_the_references(strategy):
    ref = JC.CONTRACTS[strategy]
    seen = set()
    for observed in _observations(ref.counts(JCTX)):
        seen.add(_law(ref, observed).ok)
    assert seen == {True, False}


def test_an_unchecked_kind_serialises_as_any():
    ref = JC.CollectiveContract(
        "x", ("dp",), lambda c: {"all_reduce": None, "all_gather": (2, 4),
                                 "reduce_scatter": 3})
    for observed in ({"all_reduce": 7, "all_gather": 2, "reduce_scatter": 3},
                     {"all_gather": 5, "reduce_scatter": 3},
                     {"all_gather": 1, "reduce_scatter": 2,
                      "all_to_all": 1}):
        _law(ref, observed)


@pytest.mark.parametrize("value", [None, "any", "3..7", "0..0", 5, 0,
                                   (2, 4), [1, 9]])
def test_parse_expected_spec_is_the_references(value):
    assert PC.parse_expected_spec(value) == JC.parse_expected_spec(value)


def test_the_registry_holds_every_reference_strategy_and_is_total():
    assert set(REF) <= set(PC.CONTRACTS)
    ctx = PC.ContractContext(ws=8, axis_sizes={"dp": 8}, n_leaves=12,
                             n_layers=6, param_bytes=1 << 20)
    for name, c in PC.CONTRACTS.items():
        counts = c.counts(ctx)
        assert isinstance(counts, dict), name
        assert set(counts) <= set(PC.KINDS), name
        assert c.strategy == name


@pytest.mark.parametrize("strategy", ["ddp", "ddp_bucketed", "ddp_q8",
                                      "zero1", "zero2", "zero3"])
@pytest.mark.parametrize("rebuild", ["broadcast", "all_gather"])
def test_toy_calls_are_the_references_sites(strategy, rebuild):
    extra = {"bucket_mb": 0.05, "rebuild": rebuild}
    pctx = PC.ContractContext(ws=2, axis_sizes={"dp": 2}, n_leaves=6,
                              n_layers=3, param_bytes=60_000, extra=extra)
    jctx = JC.ContractContext(ws=2, axis_sizes={"dp": 2}, n_leaves=6,
                              n_layers=3, param_bytes=60_000, extra=extra)
    got = PC.CONTRACTS[strategy].counts(pctx)
    want = JC.CONTRACTS[strategy].counts(jctx)
    assert {k: v for k, v in got.items() if v} == \
        {k: v for k, v in want.items() if v}
    assert PC.CONTRACTS[strategy].payload_bytes(pctx) == \
        JC.CONTRACTS[strategy].payload_bytes(jctx)


def test_evaluate_contract_rebuild_knob():
    ctx12 = PC.ContractContext(ws=8, axis_sizes={"dp": 8}, n_leaves=12)
    assert PC.evaluate_contract("zero1", {"all_reduce": 26}, ctx=ctx12).ok
    ag = PC.evaluate_contract(
        "zero1", {"all_reduce": 14, "all_gather": 12},
        ctx=PC.ContractContext(ws=8, axis_sizes={"dp": 8}, n_leaves=12,
                               extra={"rebuild": "all_gather"}))
    assert ag.ok
    bad = PC.evaluate_contract(
        "zero1", {"all_reduce": 26},
        ctx=PC.ContractContext(ws=8, axis_sizes={"dp": 8}, n_leaves=12,
                               extra={"rebuild": "all_gather"}))
    assert not bad.ok and bad.violations
    with pytest.raises(KeyError, match="no contract registered"):
        PC.evaluate_contract("nope", {})


def test_capture_reads_a_torch_tree_and_the_ports_axes():
    tree = [{"w": torch.zeros(4, 3), "b": torch.zeros(3)},
            {"w": torch.zeros(3, 2, dtype=torch.bfloat16),
             "b": torch.zeros(2, dtype=torch.bfloat16)}]
    c = PC.ContractContext.capture(params=tree, axes={"dp": 1, "tp": 2},
                                   n_layers=2, rebuild="all_gather")
    assert (c.ws, c.n_leaves, c.param_bytes) == (2, 4, (12 + 3) * 4
                                                 + (6 + 2) * 2)
    assert c.axis_sizes == {"dp": 1, "tp": 2}
    assert c.extra == {"rebuild": "all_gather"}
    assert all(x.device.type == "meta" for x in
               (c.tree[0]["w"], c.tree[1]["b"]))


def test_the_verdict_lands_in_the_manifest(tmp_path):
    verdict = PC.evaluate_contract(
        "ddp", {"all_reduce": 14},
        ctx=PC.ContractContext(ws=8, axis_sizes={"dp": 8}, n_leaves=12))
    assert verdict.ok
    with TelemetryRun("ddp", results_dir=str(tmp_path),
                      collective_counts={"all_reduce": 14},
                      contract=verdict.to_dict()) as run:
        run.step(loss=1.0)
    manifest = json.load(open(f"{run.run_dir}/manifest.json"))
    assert manifest["contract"]["ok"] is True
    assert manifest["contract"]["strategy"] == "ddp"
    assert manifest["contract"]["observed"]["all_reduce"] == 14
    # a twin's verdict comes after its first step: written again
    late = PC.evaluate_contract(
        "ddp", {"all_reduce": 13},
        ctx=PC.ContractContext(ws=8, axis_sizes={"dp": 8}, n_leaves=12))
    with TelemetryRun("ddp", results_dir=str(tmp_path)) as run:
        assert json.load(open(f"{run.run_dir}/manifest.json"))[
            "contract"] is None
        run.file_contract(late.to_dict())
        run.step(loss=1.0)
    manifest = json.load(open(f"{run.run_dir}/manifest.json"))
    assert manifest["contract"] == late.to_dict()
    assert late.summary() == ("VIOLATED: all_reduce: 13 sites, contract "
                              "expects 14")


def test_a_broadcast_is_named_only_where_it_happens():
    ctx = PC.ContractContext(ws=2, axis_sizes={"dp": 2}, n_leaves=4)
    quiet = PC.evaluate_contract("ddp", {"all_reduce": 6}, ctx=ctx)
    assert quiet.ok and "broadcast" not in quiet.to_dict()["expected"]
    loud = PC.evaluate_contract("ddp", {"all_reduce": 6, "broadcast": 4},
                                ctx=ctx)
    assert not loud.ok
    assert loud.expected["broadcast"] == 0 and loud.observed["broadcast"] == 4
    assert loud.violations == ["broadcast: 4 sites, contract expects 0"]


def test_fsdp_offload_is_registered_and_its_host_budget_refused():
    c = PC.CONTRACTS["fsdp_offload"]
    ctx = PC.ContractContext(ws=2, axis_sizes={"dp": 2}, n_layers=2)
    assert c.counts(ctx) == PC.CONTRACTS["fsdp"].counts(ctx)
    with pytest.raises(NotImplementedError, match="A12b"):
        c.host_transfers(ctx)
