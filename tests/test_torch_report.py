"""The port's report tier against the JAX package's, on the CPU, in one
process: ``telemetry.report`` and ``train/report.py`` against the
reference's ``telemetry/report.py`` and ``scripts/report.py`` (text,
``--json`` and exit codes, every regression gate passing and failing)
on port-written runs, synthetic ``collectives.json`` / ``memory.json``
in the reference's schema and the bench-style baselines
(``bench_matrix_tpu.json``, ``BENCH_r01.json``, read only); the ledger's
pure functions and ``interval_overlap_us`` bitwise against the
reference's on seeded inputs; the timeline's host rows against the
reference's ``span_events``; the port's timeline of a profiled run.
The two-rank ledger law is ``test_torch_ledger_ranks.py``'s.
"""

import gzip
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from distributed_training_sandbox_tpu.telemetry import ledger as JL
from distributed_training_sandbox_tpu.utils import trace_analysis as JTA
from distributed_training_sandbox_tpu_torch.telemetry import ledger as PL
from distributed_training_sandbox_tpu_torch.telemetry import memledger as PM
from distributed_training_sandbox_tpu_torch.telemetry.spans import SpanStream
from distributed_training_sandbox_tpu_torch.train import (
    export_timeline as PX)
from distributed_training_sandbox_tpu_torch.train import pipeline as TP
from distributed_training_sandbox_tpu_torch.train import report as PRS
from distributed_training_sandbox_tpu_torch.train.harness import (
    quiet_config)
from distributed_training_sandbox_tpu_torch.utils import (
    trace_analysis as PTA)
from distributed_training_sandbox_tpu_torch.utils.profiling import (
    ProfileSchedule)
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

REPO = Path(__file__).resolve().parent.parent
NCCL = str(REPO / "baselines" / "nccl_reference.json")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JRS = _script("report")
JX = _script("export_timeline")


# ---- run directories --------------------------------------------------------

def _write(d: Path, name: str, obj) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(json.dumps(obj, indent=1))


def _synthetic(root: Path, tag: str, busbw: float, peak_gb: float,
               overlap: float, step_ms: float) -> None:
    """A run dir in the reference's schema with a collective ledger and
    a memory ledger: two aggregates, a verdict, a memory breakdown."""
    d = root / f"20260101-000000-fsdp-{tag}"
    _write(d, "manifest.json", {
        "run_id": d.name, "strategy": "fsdp", "model": "tiny",
        "device_count": 2, "platform": "cpu",
        "config": {"sequence_length": 64, "batch_size": 4},
        "collective_counts": {"all_gather": 38, "reduce_scatter": 38},
        "contract": {"ok": True}})
    (d / "steps.jsonl").write_text("".join(
        json.dumps({"schema": 1, "step": i, "loss": 3.0 - i,
                    "step_time_s": step_ms / 1e3}) + "\n"
        for i in range(3)))
    aggs = {}
    for kind, bucket, us in (("all_gather", "≤64KiB", 40.0),
                             ("reduce_scatter", "≤1MiB", 90.0)):
        aggs[f"{kind}|{bucket}|dp"] = {
            "kind": kind, "payload_bucket": bucket, "axis": "dp",
            "sites": 4, "events": 12, "total_us": us, "bytes_moved": 4096,
            "bus_bytes_moved": 2048.0, "algbw_gbps": 2 * busbw,
            "busbw_gbps": busbw}
    _write(d, "collectives.json", {
        "schema": 1, "axis_sizes": {"dp": 2},
        "totals": {"measured_sites": 8, "busbw_gbps": busbw},
        "entries": [], "aggregates": aggs, "unmatched_events": {},
        "unmeasured_instances": [],
        "contract_join": {"ok": True, "violations": []}})
    _write(d, "memory.json", {
        "schema": 1, "measured_peak_gb": peak_gb,
        "categories_gb": {"params": peak_gb / 4, "opt_state": peak_gb / 2}})
    _write(d, "summary.json", {
        "run_id": d.name, "strategy": "fsdp", "model": "tiny",
        "status": "completed", "sequence_length": 64, "batch_size": 4,
        "step_time_ms": step_ms, "tokens_per_second": 256e3 / step_ms,
        "avg_loss": 2.0, "final_loss": 1.0,
        "comm_split": {"comm_fraction": 0.25, "overlap_fraction": overlap},
        "ledger": {"ok": True, "busbw_gbps": busbw},
        "memory": {"ok": True, "measured_gb": peak_gb}})


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """``cur`` and ``base`` synthetic roots (the current run slower,
    lower busbw, more memory, less overlap than its baseline), port
    pipeline runs (profiled, so with a comm split and an empty ledger,
    and one preempted and resumed, so with lineage), and a roofline in
    ``train/busbench.py``'s format."""
    root = tmp_path_factory.mktemp("report")
    _synthetic(root / "cur", "a", busbw=1.0, peak_gb=12.0, overlap=0.1,
               step_ms=130.0)
    _synthetic(root / "base", "a", busbw=2.0, peak_gb=8.0, overlap=0.5,
               step_ms=100.0)
    port = root / "port"
    kw = dict(num_epochs=5, batch_size=8, device="cpu",
              profile_schedule=ProfileSchedule(skip_first=1, wait=0,
                                               warmup=0, active=2),
              log=lambda *a: None)
    TP.run("1f1b", config=quiet_config(
        telemetry=True, profile=True, results_dir=str(port),
        trace_dir=str(root / "traces")), **kw)
    TP.run("gpipe", config=quiet_config(
        telemetry=True, results_dir=str(port),
        checkpoint_dir=str(root / "ck"), inject_fault="preempt@2",
        max_restarts=1), **kw)
    _write(root, "busbench.json", {
        "schema": 1, "platform": "cpu", "rows": [
            {"collective": k, "payload_bytes": 1 << 20, "n_devices": 2,
             "time_ms": 1.0, "algbw_gbps": 3.0, "busbw_gbps": 1.5}
            for k in ("all_gather", "reduce_scatter", "all_reduce")]})
    return root


def _both(capsys, argv):
    """``(rc, stdout)`` of the reference's ``scripts/report.py`` and of
    ``train/report.py`` on the same arguments."""
    outs = []
    for main in (JRS.main, PRS.main):
        rc = main(list(argv))
        outs.append((rc, capsys.readouterr().out))
    return outs


@pytest.mark.parametrize("which", ["synthetic", "port", "all"])
@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_report_renders_the_references_text_and_json(dirs, capsys, which,
                                                     as_json):
    paths = {"synthetic": [dirs / "cur", dirs / "base"],
             "port": [dirs / "port"],
             "all": [dirs / "cur", dirs / "port"]}[which]
    argv = [*map(str, paths), "--nccl-baseline", NCCL, "--roofline",
            str(dirs / "busbench.json"), "--steps"]
    (jrc, jout), (prc, pout) = _both(capsys, argv + ["--json"] * as_json)
    assert (prc, pout) == (jrc, jout)
    assert prc == 0
    if not as_json and which != "port":
        assert "Collective bus bandwidth" in pout
        assert "Memory ledger" in pout
    if which == "port":
        assert "Restart lineage" in pout or as_json


GATES = {
    "tolerance": (["--tolerance", "0.5"], ["--tolerance", "0.1"]),
    "bandwidth": (["--fail-on-bandwidth-regression", "60"],
                  ["--fail-on-bandwidth-regression", "20"]),
    "memory": (["--fail-on-memory-regression", "60"],
               ["--fail-on-memory-regression", "20"]),
    "overlap": (["--fail-on-overlap-regression", "50"],
                ["--fail-on-overlap-regression", "5"]),
}


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("trips", [False, True], ids=["passes", "fails"])
def test_regression_gates_exit_as_the_reference(dirs, capsys, gate, trips):
    flags = GATES[gate][trips]
    if gate != "tolerance":   # the step-time comparison stays in bounds
        flags = flags + ["--tolerance", "0.5"]
    argv = [str(dirs / "cur"), "--baseline", str(dirs / "base"),
            "--nccl-baseline", NCCL, "--roofline",
            str(dirs / "busbench.json"), *flags]
    (jrc, jout), (prc, pout) = _both(capsys, argv)
    assert (prc, pout) == (jrc, jout)
    assert prc == int(trips)


@pytest.mark.parametrize("baseline", ["bench_matrix_tpu.json",
                                      "BENCH_r01.json"])
def test_bench_style_baselines_read_as_the_reference(dirs, capsys, tmp_path,
                                                     baseline):
    """A run matching the bench file's first row's identity, against
    the bench-style JSON (read only)."""
    src = REPO / baseline
    rows = JRS.R.load_baseline_rows(str(src))
    assert rows and PRS.R.load_baseline_rows(str(src)) == rows
    row = rows[0]
    d = tmp_path / "20260101-000000-bench"
    _write(d, "summary.json", {
        "run_id": d.name, "strategy": row.get("strategy", "fsdp"),
        "model": row.get("model"), "status": "completed",
        "sequence_length": row.get("sequence_length"),
        "batch_size": row.get("batch_size"),
        "step_time_ms": 1.3 * float(row.get("step_time_ms") or 100.0),
        "tokens_per_second": 0.7 * float(row.get("tokens_per_second")
                                         or 1000.0)})
    argv = [str(d), "--baseline", str(src), "--nccl-baseline", NCCL,
            "--roofline", str(dirs / "busbench.json")]
    for extra in ([], ["--json"]):
        (jrc, jout), (prc, pout) = _both(capsys, argv + extra)
        assert (prc, pout) == (jrc, jout)


def test_port_runs_carry_a_comm_split_and_an_empty_ledger(dirs):
    (run,) = [d for d in (dirs / "port").iterdir()
              if (d / "collectives.json").exists()]
    summary = json.loads((run / "summary.json").read_text())
    sp = summary["comm_split"]
    assert "comm_split_error" not in summary and sp["source"] == "host"
    assert sp["compute_us"] > 0 and sp["comm_us"] == 0.0
    assert summary["ledger"]["ok"] and summary["ledger"]["traced_steps"] == 2
    led = json.loads((run / "collectives.json").read_text())
    assert led["entries"] == [] and led["contract_join"]["ok"]
    assert summary["memory"] is None
    # the library's own readers of the owned session agree with finalize
    session = summary["profile_sessions"][-1]
    again = PTA.split_from_trace(summary["trace_dir"], session=session)
    assert (again.comm_us, again.compute_us, again.trace_file) == \
        (sp["comm_us"], sp["compute_us"], sp["trace_file"])
    assert PL.ledger_from_trace(summary["trace_dir"], [], 2,
                                session=session).to_dict()["entries"] == []
    assert PTA.profile_session_dirs(summary["trace_dir"]) == [session]


def test_an_unparseable_trace_is_an_error_beside_the_null(tmp_path):
    from distributed_training_sandbox_tpu_torch.telemetry import TelemetryRun
    from distributed_training_sandbox_tpu_torch.utils.profiling import (
        Profiler)
    prof = Profiler(trace_dir=str(tmp_path / "t"), enabled=True,
                    schedule=ProfileSchedule(skip_first=1, wait=0,
                                             warmup=0, active=1))
    with TelemetryRun("ddp", results_dir=str(tmp_path / "r"), device="cpu",
                      profiler=prof) as telem:
        telem.attach_sites([], {}, "ddp")
        telem.step(loss=1.0)       # the window opens
        telem.step(loss=1.0)       # and closes
        Path(prof.trace_files[-1]).write_text("{not json")
    summary = json.loads(Path(telem.run_dir, "summary.json").read_text())
    assert summary["comm_split"] is None and summary["ledger"] is None
    assert summary["comm_split_error"].startswith("JSONDecodeError")
    assert summary["ledger_error"].startswith("JSONDecodeError")


# ---- the pure functions, bitwise --------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_interval_overlap_equals_the_reference(seed):
    rng = np.random.default_rng(seed)

    def ivs(n):
        s = rng.uniform(0, 1000, n)
        return [(float(a), float(a + d)) for a, d in
                zip(s, rng.uniform(0, 80, n))]
    for _ in range(20):
        comm, comp = ivs(rng.integers(0, 30)), ivs(rng.integers(0, 30))
        assert PTA.interval_overlap_us(comm, comp) == \
            JTA.interval_overlap_us(comm, comp)


def test_payload_bucket_and_axis_equal_the_reference():
    rng = np.random.default_rng(0)
    sizes = [0, -3, 1, 2, 3, 1023, 1024, 1025, 1 << 30, (1 << 30) + 1]
    sizes += [int(x) for x in rng.integers(1, 1 << 34, 200)]
    for n in sizes:
        assert PL.payload_bucket(n) == JL.payload_bucket(n)
    for _ in range(200):
        k = int(rng.integers(0, 4))
        axes = {f"a{i}": int(rng.choice([1, 2, 4, 8])) for i in range(k)}
        g = int(rng.choice([1, 2, 4, 8, 16, 3]))
        assert PL._axis_for_group(g, axes) == JL._axis_for_group(g, axes)


def _ledgers(rng):
    """The same random ledger built as the port's and the reference's."""
    kinds = list(JL_KINDS)
    entries = []
    for j in range(int(rng.integers(0, 12))):
        kind = kinds[int(rng.integers(len(kinds)))]
        entries.append(dict(
            name=f"{kind}.{j}", kind=kind,
            occurrences=int(rng.integers(1, 9)),
            total_us=float(rng.uniform(1, 500)),
            mean_us=float(rng.uniform(1, 50)),
            payload_bytes=int(rng.integers(1, 1 << 26)),
            group_size=int(rng.choice([2, 4])), axis="dp",
            algbw_gbps=float(rng.uniform(0, 40)),
            busbw_gbps=float(rng.uniform(0, 60))))
    unmeasured = [{"name": f"x.{i}", "kind": kinds[int(rng.integers(5))],
                   "payload_bytes": 8} for i in range(int(rng.integers(3)))]
    unmatched = {f"u.{i}": {"count": 1, "total_us": 2.0}
                 for i in range(int(rng.integers(2)))}
    out = []
    for M in (PL, JL):
        led = M.CollectiveLedger(
            entries=[M.LedgerEntry(**e) for e in entries],
            unmeasured_instances=[dict(u) for u in unmeasured],
            unmatched_events=dict(unmatched), axis_sizes={"dp": 4})
        out.append(led)
    return out


JL_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
            "collective_permute", "all_to_all")


@pytest.mark.parametrize("seed", range(4))
def test_join_contract_and_bandwidth_gate_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        pled, jled = _ledgers(rng)
        assert pled.to_dict() == jled.to_dict()
        expected = {}
        for k in JL_KINDS:
            c = int(rng.integers(0, 4))
            expected[k] = rng.choice([c, f"{c}..{c + 2}", "any"]).item() \
                if rng.random() < 0.8 else c
        assert PL.join_contract(pled, expected, "s") == \
            JL.join_contract(jled, expected, "s")
        other, _ = _ledgers(rng)
        a, b = pled.aggregates(), other.aggregates()
        for drop in (5.0, 20.0, 80.0):
            assert PL.check_bandwidth_regressions(a, b, drop, "x", "y") == \
                JL.check_bandwidth_regressions(a, b, drop, "x", "y")


def test_memory_read_back_equals_the_reference(dirs):
    from distributed_training_sandbox_tpu.telemetry import memledger as JM
    d = next((dirs / "cur").iterdir())
    doc = PM.load_memory_dict(str(d))
    assert doc == JM.load_memory_dict(str(d)) and doc is not None
    assert PM.memory_aggregates(doc) == JM.memory_aggregates(doc)
    base = PM.memory_aggregates(PM.load_memory_dict(
        str(next((dirs / "base").iterdir()))))
    for g in (10.0, 60.0):
        assert PM.check_memory_regressions(PM.memory_aggregates(doc), base,
                                           g) == \
            JM.check_memory_regressions(JM.memory_aggregates(doc), base, g)


# ---- the ledger's join on a synthetic trace ---------------------------------

def _trace(calls):
    """A host-side trace of c10d calls ``[(kind op, numel)]``."""
    evs, t = [], 0.0
    for name, numel in calls:
        evs.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": t,
                    "dur": 10.0, "pid": 1, "tid": 1,
                    "args": {"Input Dims": [[[numel]]]}})
        t += 20.0
    return evs


def test_build_ledger_joins_calls_to_sites_by_position():
    sites = [{"kind": "all_reduce", "numel": 8, "bytes": 32,
              "dtype": "float32", "group": 2},
             {"kind": "all_reduce", "numel": 1, "bytes": 4,
              "dtype": "float32", "group": 2}]
    step = [("c10d::allreduce_", 8), ("c10d::allreduce_", 1)]
    stats = PTA.collective_stats_from_events(_trace(step * 3))
    led = PL.build_ledger(stats, sites, steps=3, axis_sizes={"dp": 2})
    assert [e.occurrences for e in led.entries] == [3, 3]
    assert PL.join_contract(led, {"all_reduce": 2})["ok"]
    assert not PL.join_contract(led, {})["ok"]
    # a call too many, or one of another size, is outside the step
    stats = PTA.collective_stats_from_events(_trace(
        step * 3 + [("c10d::allreduce_", 8)]))
    assert not PL.join_contract(PL.build_ledger(stats, sites, 3),
                                {"all_reduce": 2})["ok"]
    stats = PTA.collective_stats_from_events(_trace(
        step * 2 + [("c10d::allreduce_", 9), ("c10d::allreduce_", 1)]))
    verdict = PL.join_contract(PL.build_ledger(stats, sites, 3),
                               {"all_reduce": 2})
    assert verdict["missing_from_trace"] == ["all_reduce.0"]
    assert verdict["unmatched_measured"] == ["all_reduce#4"]


def test_the_shim_keeps_sites_only_inside_a_capture():
    """Counts always; a site list only from ``capture()`` to ``sites()``
    or ``reset()``, so a caller that never resets keeps no list."""
    from distributed_training_sandbox_tpu_torch.ops.collectives import (
        CollectiveCounts)
    shim = CollectiveCounts()
    x = torch.zeros(3, 4, dtype=torch.bfloat16)
    for _ in range(100):
        shim.record("all_reduce", x, 2)
    assert shim.read()["all_reduce"] == 100 and shim.sites() == []
    shim.capture()
    shim.record("all_gather", x, 4)
    shim.record("reduce_scatter", x[:1], 4)
    assert shim.sites() == [
        {"kind": "all_gather", "numel": 12, "bytes": 24,
         "dtype": "bfloat16", "group": 4},
        {"kind": "reduce_scatter", "numel": 4, "bytes": 8,
         "dtype": "bfloat16", "group": 4}]
    shim.record("all_gather", x, 4)      # the capture ended at sites()
    assert shim.sites() == []
    shim.capture()
    shim.record("all_gather", x, 4)
    shim.reset()                         # and ends at a reset
    shim.record("all_gather", x, 4)
    assert shim.sites() == [] and shim.read()["all_gather"] == 1


def test_a_cuda_traces_calls_take_the_device_time_they_launched():
    """A CUDA trace's shape (as the card's profiler writes it): an
    all_gather whose kernel launches inside its ``c10d`` op; a ring hop
    whose send is queued and launched with its recv at the end of the
    coalesced group; a compute kernel and a peer copy.  Each call takes
    its kernel's device time; the split counts device work only."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 7, "tid": tid, "args": args}
    evs = [
        x("cpu_op", "c10d::_allgather_base_", 0, 40,
          **{"Input Dims": [[8, 4], [2, 4], [], [], []]}),
        x("user_annotation", "nccl:_all_gather_base", 5, 30),
        x("cuda_driver", "cuLaunchKernelEx", 10, 2, correlation=1),
        x("kernel", "ncclDevKernel_AllGather_RING_LL", 20, 50, tid=9,
          correlation=1),
        x("cpu_op", "c10d::send", 100, 10, **{"Input Dims": [[[6]], []]}),
        x("cpu_op", "c10d::recv_", 112, 10, **{"Input Dims": [[[6]], []]}),
        x("user_annotation", "nccl:coalesced", 125, 20),
        x("cuda_driver", "cuLaunchKernelEx", 130, 2, correlation=2),
        x("kernel", "ncclDevKernel_SendRecv", 140, 30, tid=9, correlation=2),
        x("cuda_runtime", "cudaLaunchKernel", 200, 2, correlation=3),
        x("kernel", "gemm", 210, 70, tid=8, correlation=3),
        x("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 300, 5, tid=9,
          correlation=4),
        x("cpu_op", "aten::mm", 195, 20),
    ]
    stats = PTA.collective_stats_from_events(evs)
    assert stats["all_gather"]["calls"] == [{"ts": 0.0, "us": 50.0,
                                             "numel": 8}]
    assert stats["collective_permute"]["calls"] == [
        {"ts": 100.0, "us": 30.0, "numel": 6}]
    sp = PTA.split_events(evs)
    assert (sp.source, sp.comm_us, sp.compute_us) == ("device", 85.0, 70.0)
    assert sp.overlap_us == 0.0


# ---- the timeline -----------------------------------------------------------

def test_timeline_host_rows_equal_the_references(tmp_path):
    stream = SpanStream(str(tmp_path))
    for i, (name, cat) in enumerate([("pump/sync_every", "pump"),
                                     ("prefetch/wait", "prefetch"),
                                     ("serve/decode_burst", "serve"),
                                     ("checkpoint/save", "checkpoint")]):
        with stream.span(name, cat=cat, step=i):
            pass
    stream.close()
    from distributed_training_sandbox_tpu_torch.telemetry.spans import (
        read_spans)
    spans = read_spans(str(tmp_path))
    assert len(spans) == 4
    assert PX.span_events(spans) == JX.span_events(spans)


def test_timeline_merges_a_profiled_port_run(dirs, tmp_path):
    (run,) = [d for d in (dirs / "port").iterdir()
              if (d / "collectives.json").exists()]
    copy = tmp_path / run.name
    shutil.copytree(run, copy)
    assert PX.main([str(copy)]) == 0
    with gzip.open(copy / "timeline.json.gz", "rt") as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in evs)
    assert doc["metadata"]["device_traces"]
    assert min(e["ts"] for e in evs if "ts" in e) == 0.0
    assert PX.main([str(tmp_path / "none")]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "summary.json").write_text("{}")
    assert PX.main([str(empty)]) == 1
