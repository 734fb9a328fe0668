"""The port's run telemetry (``telemetry/``, ``utils/config.py``,
``utils/profiling.py``, ``utils/tracker.py``) against the JAX package's
on the same inputs, on the CPU.

Tiers: the pure-logic pieces bit for bit — ``step_event``,
``span_event`` and the validators give equal dicts and problem lists,
``MetricsWriter`` byte-identical files, ``MetricsRegistry`` an equal
exposition text, ``ProfileSchedule`` and the profiler equal transitions,
``PerformanceTracker`` equal metrics from the same injected clock,
``build_run_id`` equal ids, ``TrainConfig.from_args`` equal fields (and
the same refusal).  The format: every ``steps.jsonl`` line of a port run
passes the JAX package's ``validate_step``, and the JAX package's
``telemetry.report`` discovers and renders a port run directory,
restart lineage included (a one-rank ``train.ddp`` preempted and
resumed, in a child process).
"""

import dataclasses
import datetime as real_datetime
import json
import os
import types

import pytest
import torch
from test_torch_fsdp import spawn_ranks

from distributed_training_sandbox_tpu.telemetry import metrics as JMET
from distributed_training_sandbox_tpu.telemetry import report as JREP
from distributed_training_sandbox_tpu.telemetry import schema as JS
from distributed_training_sandbox_tpu.telemetry import writer as JW
from distributed_training_sandbox_tpu.utils import config as JCFG
from distributed_training_sandbox_tpu.utils import profiling as JPROF
from distributed_training_sandbox_tpu.utils import tracker as JTR
from distributed_training_sandbox_tpu_torch.runtime import StepPump
from distributed_training_sandbox_tpu_torch.telemetry import TelemetryRun
from distributed_training_sandbox_tpu_torch.telemetry import metrics as PMET
from distributed_training_sandbox_tpu_torch.telemetry import schema as PS
from distributed_training_sandbox_tpu_torch.telemetry import writer as PW
from distributed_training_sandbox_tpu_torch.utils import config as PCFG
from distributed_training_sandbox_tpu_torch.utils import profiling as PPROF
from distributed_training_sandbox_tpu_torch.utils import tracker as PTR
torch.set_num_threads(1)  # the suite's workers share the cores

TRACKER_METRICS = {"last_step_time_s": 0.25, "tokens_per_second": 1e4,
                   "tflops_per_device": 1.5, "peak_memory_gb": 3.0}
STEP_CASES = [
    dict(step=0),
    dict(step=3, loss=2.5, tokens=4096, step_time_s=0.5),
    dict(step=4, loss=1, tokens=7, tracker_metrics=TRACKER_METRICS),
    dict(step=5, tracker_metrics=TRACKER_METRICS, rank=1, phase="decode",
         active=3.5, ttft_ms=12.0, trace_id="t-1"),
    dict(step=6, loss=None, tokens=None, step_time_s=None, extra_key=[1, 2]),
]
BAD_EVENTS = [
    {}, {"schema": 1}, {"schema": 2, "step": 0},
    {"schema": 1, "step": 0, "loss": "nan"},
    {"schema": 1, "step": 0, "pool_util": [1], "active": "3"},
    {"step": 1, "loss": None, "ttft_ms": 1.5},
]
BAD_SPANS = [{}, {"name": "x"}, {"schema": 1, "name": "a", "ts_us": "1",
                                 "dur_us": None},
             {"schema": 1, "name": "a/b", "ts_us": 1.0, "dur_us": 2}]


@pytest.mark.parametrize("case", range(len(STEP_CASES)))
def test_step_event_equals_the_reference(case):
    kw = dict(STEP_CASES[case])
    step = kw.pop("step")
    assert PS.step_event(step, **kw) == JS.step_event(step, **kw)
    ev = PS.step_event(step, **kw)
    assert PS.validate_step(ev) == JS.validate_step(ev) == []


def test_validators_and_span_event_equal_the_reference():
    for ev in BAD_EVENTS:
        assert PS.validate_step(ev) == JS.validate_step(ev)
    for ev in BAD_SPANS:
        assert PS.validate_span(ev) == JS.validate_span(ev)
    for kw in (dict(name="pump/sync_every", ts_us=1.5, dur_us=2),
               dict(name="prefetch/wait", ts_us=0, dur_us=0.25,
                    cat="x", step=3, skip=None)):
        assert PS.span_event(**kw) == JS.span_event(**kw)
    assert PS.STEP_FIELDS == JS.STEP_FIELDS
    assert PS.SPAN_FIELDS == JS.SPAN_FIELDS


def test_metrics_writer_writes_byte_identical_files(tmp_path):
    manifest = {"run_id": "r", "config": {"a": 1, "b": [1, 2]},
                "lineage": None}
    summary = {"status": "completed", "step_time_ms": 1.25, "x": None}
    for name, W in (("jax", JW.MetricsWriter), ("port", PW.MetricsWriter)):
        with W(str(tmp_path / name), flush_every=3) as w:
            w.write_manifest(manifest)
            for kw in STEP_CASES:
                kw = dict(kw)
                w.append_step(JS.step_event(kw.pop("step"), **kw))
            w.write_json("aux.json", {"k": [1.5, None]})
            w.write_summary(summary)
    for f in ("manifest.json", "steps.jsonl", "aux.json", "summary.json"):
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "jax" / f).read_bytes(), f


def test_metrics_registry_renders_the_reference_text():
    regs = [JMET.MetricsRegistry(), PMET.MetricsRegistry()]
    for reg, mod in zip(regs, (JMET, PMET)):
        mod.maybe_inc(reg, "pump_host_sync_total", reason="exit")
        mod.maybe_inc(reg, "pump_host_sync_total", 2, reason="sync_every")
        mod.maybe_set(reg, "last_step_time_s", 0.125)
        for v in (0.00005, 0.003, 0.2, 7.0, 30.0):
            mod.maybe_observe(reg, "prefetch_wait_seconds", v)
        mod.maybe_observe(reg, "ckpt_seconds", 0.5, buckets=(0.1, 1.0),
                          leg="a")
        mod.maybe_inc(None, "ignored")
    assert regs[1].render_prometheus() == regs[0].render_prometheus()
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].counter_total("pump_host_sync_total") == 3.0


SCHEDULES = [(0, 0, 0, 1, 1), (0, 5, 5, 10, 1), (5, 1, 2, 5, 1),
             (1, 2, 0, 3, 2), (3, 1, 1, 1, 0), (0, 4, 0, 1, 1),
             (2, 0, 3, 2, 3)]


@pytest.mark.parametrize("sched", SCHEDULES, ids=str)
def test_profile_schedule_and_profiler_transitions_equal_the_reference(
        sched, monkeypatch, tmp_path):
    """The phase of each of 40 steps, and the steps at which each
    profiler starts and stops its trace (the reference's
    ``jax.profiler`` calls and the port's ``torch.profiler`` calls
    stubbed to record) and answers ``pending_transition``."""
    js, ps = JPROF.ProfileSchedule(*sched), PPROF.ProfileSchedule(*sched)
    assert [ps.phase(i) for i in range(40)] == [js.phase(i)
                                                for i in range(40)]
    log = {"jax": [], "port": []}
    monkeypatch.setattr(JPROF.jax.profiler, "start_trace",
                        lambda d: log["jax"].append("start"))
    monkeypatch.setattr(JPROF.jax.profiler, "stop_trace",
                        lambda: log["jax"].append("stop"))
    monkeypatch.setattr(JPROF.Profiler, "_sessions", lambda self: set())

    def start(self):
        self._tracing = True
        log["port"].append("start")

    def finish(self):
        self._tracing = False
        log["port"].append("stop")

    monkeypatch.setattr(PPROF.Profiler, "_start", start)
    monkeypatch.setattr(PPROF.Profiler, "_finish", finish)
    jp = JPROF.Profiler(str(tmp_path), js, enabled=True)
    pp = PPROF.Profiler(str(tmp_path), ps, enabled=True)
    pend = {"jax": [], "port": []}
    for i in range(40):
        for name, prof in (("jax", jp), ("port", pp)):
            pend[name].append(prof.pending_transition())
            log[name].append(i)
            prof.step()
    jp.stop()
    pp.stop()
    assert log["port"] == log["jax"] and pend["port"] == pend["jax"]


def test_profiler_exports_a_chrome_trace_it_owns(tmp_path):
    prof = PPROF.Profiler(str(tmp_path), PPROF.ProfileSchedule(
        skip_first=0, wait=1, warmup=0, active=1), enabled=True)
    for _ in range(3):
        with PPROF.annotate("step"), PPROF.scope("matmul"):
            torch.ones(4, 4) @ torch.ones(4, 4)
        prof.step()
    prof.stop()
    assert len(prof.owned_sessions) == 1 and len(prof.trace_files) == 1
    assert prof.owned_sessions[0].startswith(
        os.path.join(str(tmp_path), "plugins", "profile"))
    events = json.load(open(prof.trace_files[0]))["traceEvents"]
    assert any(e.get("name") == "matmul" for e in events)
    assert prof.last_profile is not None


class _Clock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_tracker_equals_the_reference_on_the_same_clock(warmup,
                                                        monkeypatch):
    times = [float(t) for t in (0, 1, 3, 3.5, 6, 7.25, 9, 9.5, 12, 14,
                                15, 15.5, 18, 19, 22, 25, 26, 30, 31,
                                33, 40, 41, 44, 47, 50, 51, 52, 53)]
    jclock, pclock = _Clock(times), _Clock(times)
    monkeypatch.setattr(JTR, "time",
                        types.SimpleNamespace(perf_counter=jclock))
    jt = JTR.PerformanceTracker(warmup_steps=warmup, flops_per_token=6e9,
                                num_devices=4, memory_sample_every=2)
    pt = PTR.PerformanceTracker(warmup_steps=warmup, flops_per_token=6e9,
                                num_devices=4, memory_sample_every=2,
                                clock=pclock, device="cpu")
    for i in range(8):
        loss = 2.0 - 0.125 * i if i % 3 else None
        assert pt.step(1024 * (i + 1), loss=loss) \
            == jt.step(1024 * (i + 1), loss=loss)
        if i % 3 == 0:
            jt.record_loss(1.5)
            pt.record_loss(1.5)
    assert pt.metrics(sample_memory=True) == jt.metrics(sample_memory=True)
    assert pclock.times == jclock.times


def test_build_run_id_equals_the_reference(monkeypatch):
    fixed = real_datetime.datetime(2026, 10, 17, 8, 9, 10,
                                   tzinfo=real_datetime.timezone.utc)

    class FakeDateTime(real_datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    fake = types.SimpleNamespace(datetime=FakeDateTime,
                                 timezone=real_datetime.timezone)
    monkeypatch.setattr(JCFG, "datetime", fake)
    monkeypatch.setattr(PCFG, "datetime", fake)
    for label in (None, "", "fsdp", "zero3-baseline", "a b/c:d", "--",
                  "ok_1.2"):
        assert PCFG.build_run_id(label) == JCFG.build_run_id(label)
    assert PCFG.build_run_id("fsdp") == "20261017-080910-fsdp"


ARGVS = [
    [],
    ["--num-steps", "6", "--batch-size", "2", "--sequence-length", "128"],
    ["--precision", "int8_pallas_bwd", "--seed", "7", "--run-name", "x",
     "--no-profile", "--no-telemetry", "--dispatch", "sync"],
    ["--checkpoint-dir", "/tmp/ck", "--checkpoint-every", "2", "--resume",
     "--max-restarts", "3", "--inject-fault", "preempt@5:sharded"],
    ["--sync-every", "0", "--max-in-flight", "4", "--prefetch-depth", "3",
     "--bucket-mb", "0.5", "--quantize-grads", "--error-feedback",
     "--overlap", "ring", "--accum-steps", "2", "--metrics-port", "0"],
    ["--watchdog-timeout", "2.5", "--world-size", "2", "--elastic",
     "--heartbeat-dir", "/tmp/hb", "--offload", "opt", "--auto-fit",
     "--hbm-budget-gb", "70", "--results-dir", "/tmp/r", "--trace-dir",
     "/tmp/t", "--num-epochs", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a)[:40])
def test_train_config_from_args_equals_the_reference(argv, monkeypatch):
    monkeypatch.setenv("TRACE_DIR", "/tmp/trace-env")
    monkeypatch.setenv("RESULTS_DIR", "/tmp/results-env")
    for kw in ({}, {"batch_size": 16, "num_steps": 3}):
        got = dataclasses.asdict(PCFG.TrainConfig.from_args(argv, **kw))
        want = dataclasses.asdict(JCFG.TrainConfig.from_args(argv, **kw))
        assert got == want


def test_train_config_refuses_what_the_reference_refuses():
    for argv in (["--num-step", "3"], ["--bogus"]):
        with pytest.raises(SystemExit) as p:
            PCFG.TrainConfig.from_args(argv)
        with pytest.raises(SystemExit) as j:
            JCFG.TrainConfig.from_args(argv)
        assert str(p.value) == str(j.value)
    assert [f.name for f in dataclasses.fields(PCFG.TrainConfig)] \
        == [f.name for f in dataclasses.fields(JCFG.TrainConfig)]


# ---------------------------------------------------------- TelemetryRun

class _StubProfiler:
    enabled = True
    trace_dir = "stub-traces"
    owned_sessions = ["stub-traces/plugins/profile/s0"]

    def __init__(self):
        self.steps = self.stops = 0

    def step(self):
        self.steps += 1

    def stop(self):
        self.stops += 1

    def pending_transition(self):
        return False


def _read_jsonl(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def test_telemetry_run_happy_path_passes_the_reference_schema(tmp_path):
    cfg = PCFG.TrainConfig(num_steps=5, batch_size=2, results_dir=str(
        tmp_path), run_name="t")
    prof = _StubProfiler()
    tracker = PTR.PerformanceTracker(warmup_steps=1, num_devices=1,
                                     device="cpu")
    with TelemetryRun("fsdp", config=cfg, device="cpu", model="tiny",
                      profiler=prof) as telem:
        with StepPump(telem=telem, tracker=tracker, sync_every=2) as pump:
            for i in range(5):
                pump.emit(torch.tensor(3.0 - i), tokens=16)
            with telem.spans.span("checkpoint/save", step=1):
                pass
    run_dir = telem.run_dir
    assert os.path.basename(run_dir).endswith("-fsdp-t")
    steps = _read_jsonl(os.path.join(run_dir, "steps.jsonl"))
    assert [e["step"] for e in steps] == list(range(5))
    assert [e["loss"] for e in steps] == [3.0, 2.0, 1.0, 0.0, -1.0]
    for ev in steps:
        assert JS.validate_step(ev) == [] and ev["rank"] == 0
    spans = _read_jsonl(os.path.join(run_dir, "spans.jsonl"))
    assert {s["name"] for s in spans} >= {"pump/sync_every", "pump/drain",
                                          "checkpoint/save"}
    assert all(JS.validate_span(s) == [] for s in spans)
    summary = json.load(open(os.path.join(run_dir, "summary.json")))
    assert summary["status"] == "completed" and summary["model"] == "tiny"
    assert summary["host_sync_breakdown"] == {"sync_every": 2, "exit": 1}
    assert summary["comm_split"] is None and summary["ledger"] is None
    assert summary["profile_sessions"] == prof.owned_sessions
    assert prof.steps == 5 and prof.stops == 1
    man = json.load(open(os.path.join(run_dir, "manifest.json")))
    assert man["platform"] == "cpu" and man["torch_version"] \
        == torch.__version__ and man["config"]["num_steps"] == 5
    assert "jax_version" not in man
    with pytest.raises(NotImplementedError, match="A12"):
        telem.attach_step_hlo(None)


def test_telemetry_run_crash_flushes_profiler_and_marks_crashed(tmp_path):
    prof = _StubProfiler()
    with pytest.raises(RuntimeError, match="boom"):
        with TelemetryRun("ddp", results_dir=str(tmp_path), device="cpu",
                          profiler=prof) as telem:
            telem.step(loss=torch.tensor(1.5), tokens=4)
            raise RuntimeError("boom")
    assert prof.stops == 1
    summary = json.load(open(os.path.join(telem.run_dir, "summary.json")))
    assert summary["status"] == "crashed"
    assert summary["error"] == "RuntimeError: boom"
    assert _read_jsonl(os.path.join(telem.run_dir, "steps.jsonl"))[0][
        "loss"] == 1.5


def test_telemetry_run_disabled_writes_nothing(tmp_path):
    with TelemetryRun("ddp", results_dir=str(tmp_path / "r"),
                      enabled=False, device="cpu") as telem:
        telem.step(loss=1.0, tokens=3)
    assert telem.run_dir is None and telem.spans is None
    assert not (tmp_path / "r").exists()


def test_reference_report_renders_a_port_run_with_lineage(tmp_path,
                                                          procs2):
    """A one-rank ``train.ddp`` preempted at step 3 and resumed in
    process: two run directories, which the JAX package's report
    discovers, tabulates and stitches."""
    runs = tmp_path / "runs"
    spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch.train.ddp",
                 "--device", "cpu", "--scale", "200", "--num-steps", "5",
                 "--checkpoint-dir", str(tmp_path / "ck"),
                 "--inject-fault", "preempt@3", "--max-restarts", "1",
                 "--results-dir", str(runs), "--trace-dir",
                 str(tmp_path / "tr"), "--out", str(tmp_path / "r.json")],
                1, procs2.free_port())
    res = json.loads((tmp_path / "r.json").read_text())
    assert res["status"] == "completed" and len(res["losses"]) == 5
    recs = JREP.discover_runs([str(runs)])
    assert len(recs) == 2
    rows = [JREP.run_row(r) for r in recs]
    assert [r["status"] for r in rows] == ["preempted", "completed"]
    assert [r["num_steps"] for r in recs] == [3, 2]
    for rec in recs:
        for ev in JREP.load_steps(rec["dir"]):
            assert JS.validate_step(ev) == []
    table = JREP.render_table(rows)
    assert all(r["run_id"] in table for r in rows)
    lineage = JREP.render_lineage(rows)
    assert "resumed from step 2" in lineage
    assert "[0..2 preempted]" in lineage


def test_memory_helpers_read_pytorchs_oom_verdicts():
    from distributed_training_sandbox_tpu_torch.utils import memory as M
    msg = ("CUDA out of memory. Tried to allocate 2.50 GiB. GPU 0 has a "
           "total capacity of 79.10 GiB of which 1.2 GiB is free.")
    assert M.classify_failure(torch.OutOfMemoryError(msg))[0] == "oom"
    assert M.classify_failure(RuntimeError(msg)) == ("oom", msg)
    assert M.classify_failure(ValueError("bad shape")) \
        == ("error", "ValueError: bad shape")
    assert M.parse_hbm_oom(msg) == (2.5, 79.1)
    assert M.parse_hbm_oom("Tried to allocate 512.00 MiB. GPU 0 has a "
                           "total capacity of 80 GiB") == (0.5, 80.0)
    assert M.parse_hbm_oom("all fine") is None
    tree = {"w": torch.zeros(4, 8), "opt": (torch.zeros(2, dtype=torch.int8),
                                            3)}
    assert M.tree_size_bytes(tree) == 4 * 8 * 4 + 2
    assert M.tree_local_size_mb(tree) == M.tree_size_mb(tree)
    if not torch.cuda.is_available():
        assert M.hbm_capacity_gb() is None and M.all_devices_memory_gb() == {}
    got = M.print_memory_stats("t", params=tree, device="cpu",
                               printer=lambda s: None)
    assert got["model_mb"] == M.tree_size_mb(tree)
