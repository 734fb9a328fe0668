"""Every twin's contract verdict and its collective ledger, on the CPU.

One spawn of two gloo ranks (child processes importing torch, numpy and
the port only) runs each twin that the reference gives a verdict for a
step or two, with telemetry on: DDP (per leaf, bucketed, q8), ZeRO-1/2/3
(both legs), TP (none, ring, q8), SP, MoE, FSDP (none, ring, fp8), the
composable twin (a W plan and a TP plan).  Each run's manifest carries
the first step's ``ContractVerdict.to_dict()`` (``contract``, ok) and
the rules verdict (``rules``, ok); FSDP's ``ring_fused`` overlap and
its auto variant carry no contract, as the reference's script files
none.  ZeRO-3, MoE, TP and the composable TP plan run profiled: each
writes ``collectives.json`` whose join with the verdict's expected
calls is ok, and fails once a site is dropped.  The pipeline twin runs
in this process (one process drives its stages).  The cross-run report
reads each verdict into its ``contract_ok`` column, a red one as red,
and ``train.verdict_survey --summarize`` reads every run.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_training_sandbox_tpu_torch.telemetry import ledger as PL
from distributed_training_sandbox_tpu_torch.telemetry import report as PR
from distributed_training_sandbox_tpu_torch.train import (pipeline,
                                                          verdict_survey)
from distributed_training_sandbox_tpu_torch.train.harness import quiet_config
torch.set_num_threads(1)  # the suite's workers share the cores

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import json, sys
from pathlib import Path
work = Path(sys.argv[1])
import torch
torch.set_num_threads(1)
from distributed_training_sandbox_tpu_torch.train import (
    _2d, ddp, moe, train_composable, train_fsdp, zero)
from distributed_training_sandbox_tpu_torch.train.harness import quiet_config
from distributed_training_sandbox_tpu_torch.utils import mesh
from distributed_training_sandbox_tpu_torch.utils.profiling import (
    ProfileSchedule)
mesh.init_process_group("cpu")
rank = mesh.axis_rank()
quiet = lambda *a, **k: None
sched = ProfileSchedule(skip_first=1, wait=0, warmup=1, active=2)

def cfg(tag, profile=False):
    return quiet_config(telemetry=True, profile=profile,
                        results_dir=str(work / "runs" / tag),
                        trace_dir=str(work / "traces" / tag))

def lm(tag, profile=False):
    return dict(num_steps=5 if profile else 2, device="cpu", log=quiet,
                config=cfg(tag, profile),
                profile_schedule=sched if profile else None)

out = {}
def keep(tag, r, run_dirs=None):
    out[tag] = {"run_dirs": run_dirs or [r["run_dir"]],
                "contract": r.get("contract"),
                "contract_ok": r.get("contract_ok")}

for tag, kw in (("ddp", {}), ("ddp_bucketed", {"bucket_mb": 0.05}),
                ("ddp_q8", {"quantize_grads": True})):
    keep(tag, ddp.run(scale=200, num_steps=2, batch_size=16, device="cpu",
                      log=quiet, config=cfg(tag), **kw))
for stage, rebuild, prof in ((1, "broadcast", False),
                             (2, "all_gather", False), (3, "broadcast", True)):
    tag = f"zero{stage}"
    r = zero.run(stage, rebuild=rebuild, scale=200, batch_size=16,
                 **lm(tag, prof))
    dirs = sorted(str(p) for p in (work / "runs" / tag).iterdir())
    out[tag] = {"run_dirs": dirs, "legs": {
        "baseline": r["base_contract"], "sharded": r["shard_contract"]}}
for tag, kw in (("tp", {"overlap": "none"}), ("tp_ring", {"overlap": "ring"}),
                ("tp_q8", {"overlap": "q8"})):
    keep(tag, _2d.run("tp", "tiny", second=2, seq=32,
                      **lm(tag, tag == "tp"), **kw))
keep("sp", _2d.run("sp", "tiny", second=2, seq=32, **lm("sp")))
keep("moe", moe.run("tiny", ep=2, seq=32, **lm("moe", True)))
for tag, kw in (("fsdp", {}), ("fsdp_ring", {"overlap": "ring"}),
                ("fsdp_fp8", {"cfg_overrides": {
                    "matmul_precision": "fp8_pallas"}}),
                ("fsdp_ring_fused", {"overlap": "ring_fused"}),
                ("fsdp_auto", {"variant": "auto"})):
    keep(tag, train_fsdp.run("tiny", seq=32, batch_size=4, **lm(tag), **kw))
keep("composable_w1", train_composable.run("dp2xw1", scale=200,
                                           **lm("composable_w1")))
keep("composable_tp", train_composable.run("dp1xtp2", seq=32,
                                           **lm("composable_tp", True)))
(work / f"out{rank}.json").write_text(json.dumps(out))
mesh.destroy_process_group()
"""

FILED = ("ddp", "ddp_bucketed", "ddp_q8", "tp", "tp_ring", "tp_q8", "sp",
         "moe", "fsdp", "fsdp_ring", "fsdp_fp8", "composable_w1",
         "composable_tp")
NOT_FILED = ("fsdp_ring_fused", "fsdp_auto")
PROFILED = ("zero3", "tp", "moe", "composable_tp")
STRATEGY = {"composable_w1": "composable_zero1", "composable_tp": "tp"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, procs2):
    work = tmp_path_factory.mktemp("verdicts")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(procs2.free_port()),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(work)], cwd=REPO,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {r} ({p.returncode}):\n{o[-3000:]}"
        for r, (p, o) in enumerate(zip(procs, outs)))
    return work, json.loads((work / "out0.json").read_text())


def _manifest(run_dir) -> dict:
    return json.loads((Path(run_dir) / "manifest.json").read_text())


@pytest.mark.parametrize("twin", FILED)
def test_the_manifest_carries_the_verdicts(runs, twin):
    _, out = runs
    res = out[twin]
    man = _manifest(res["run_dirs"][0])
    assert man["contract"] == res["contract"]
    assert man["contract"]["ok"], man["contract"]["violations"]
    assert man["contract"]["strategy"] == STRATEGY.get(twin, twin)
    assert res["contract_ok"]
    assert man["rules"]["ok"], man["rules"]


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_both_zero_legs_carry_their_verdicts(runs, stage):
    _, out = runs
    res = out[f"zero{stage}"]
    by_strategy = {}
    for d in res["run_dirs"]:
        man = _manifest(d)
        by_strategy[man["strategy"]] = man
    base, shard = by_strategy[f"zero{stage}-baseline"], \
        by_strategy[f"zero{stage}"]
    assert base["contract"]["strategy"] == "ddp"
    assert shard["contract"]["strategy"] == f"zero{stage}"
    for man, leg in ((base, "baseline"), (shard, "sharded")):
        assert man["contract"] == res["legs"][leg]["contract"]
        assert man["contract"]["ok"] and res["legs"][leg]["contract_ok"]
        assert man["rules"]["ok"], man["rules"]


@pytest.mark.parametrize("twin", NOT_FILED)
def test_no_verdict_where_the_reference_files_none(runs, twin):
    _, out = runs
    assert out[twin]["contract"] is None
    assert _manifest(out[twin]["run_dirs"][0]).get("contract") is None


def _ledgers(run_dirs):
    return [(d, json.loads((Path(d) / "collectives.json").read_text()))
            for d in run_dirs if (Path(d) / "collectives.json").exists()]


@pytest.mark.parametrize("twin", PROFILED)
def test_a_profiled_twin_files_a_joined_ledger(runs, twin):
    _, out = runs
    ledgers = _ledgers(out[twin]["run_dirs"])
    assert len(ledgers) == (2 if twin == "zero3" else 1)
    for run_dir, led in ledgers:
        join = led["contract_join"]
        assert join["ok"], join["violations"]
        assert join["expected"] == _manifest(run_dir)["contract"]["expected"]
        assert not join["missing_from_trace"]
        assert not join["unmatched_measured"]
        assert sum(join["compiled_sites"].values()) > 0
        summary = json.loads((Path(run_dir) / "summary.json").read_text())
        assert summary["ledger"]["ok"]


@pytest.mark.parametrize("twin", PROFILED)
def test_a_dropped_site_fails_the_join(runs, twin):
    _, out = runs
    for _, doc in _ledgers(out[twin]["run_dirs"]):
        led = PL.CollectiveLedger(
            entries=[PL.LedgerEntry(**e) for e in doc["entries"][1:]],
            unmatched_events=doc["unmatched_events"],
            unmeasured_instances=doc["unmeasured_instances"],
            axis_sizes=doc["axis_sizes"])
        verdict = PL.join_contract(led, doc["contract_join"]["expected"],
                                   twin)
        assert not verdict["ok"]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_the_pipeline_twin_files_its_verdict(tmp_path, schedule):
    res = pipeline.run(schedule, num_epochs=2, device="cpu",
                       config=quiet_config(telemetry=True,
                                           results_dir=str(tmp_path)),
                       log=lambda *a, **k: None)
    man = _manifest(res["run_dir"])
    assert man["contract"] == res["contract"]
    assert man["contract"]["ok"] and man["contract"]["strategy"] == schedule
    assert res["contract_ok"] and man["rules"]["ok"]
    assert man["contract"]["observed"] == dict.fromkeys(
        ("all_reduce", "all_gather", "reduce_scatter",
         "collective_permute", "all_to_all"), 0)


def test_the_report_reads_every_verdict_and_shows_a_red_one(runs, tmp_path):
    _, out = runs
    dirs = [d for twin in FILED for d in out[twin]["run_dirs"]]
    rows = [PR.run_row(rec) for rec in PR.discover_runs(dirs)]
    assert len(rows) == len(dirs)
    assert all(r["contract_ok"] is True for r in rows), \
        [(r["run_id"], r["contract_ok"]) for r in rows]
    # a red verdict: the same run with one violation in its manifest
    src = Path(out["ddp"]["run_dirs"][0])
    bad = tmp_path / src.name
    bad.mkdir()
    for f in src.iterdir():
        if f.is_file():
            (bad / f.name).write_bytes(f.read_bytes())
    man = _manifest(bad)
    man["contract"].update(ok=False, violations=[
        "all_gather: 1 sites, contract expects 0"])
    (bad / "manifest.json").write_text(json.dumps(man))
    by_dir = {Path(r["dir"]).parent: r for r in (
        PR.run_row(rec) for rec in PR.discover_runs([str(bad), str(src)]))}
    red, green = by_dir[bad.parent], by_dir[src.parent]
    assert red["contract_ok"] is False and green["contract_ok"] is True
    table = PR.render_table([red])
    assert " ✗" in table and " ✓" not in table
    assert " ✓" in PR.render_table([green])


def test_the_survey_reads_every_run(runs):
    """``train.verdict_survey --summarize`` over the same runs folder:
    a line a rank-0 run, each verdict's summary OK, every profiled
    run's join ok."""
    work, out = runs
    lines = verdict_survey.summarize(work / "runs")
    tags = {ln["run"].split("/")[0] for ln in lines}
    assert tags == set(out)
    assert len(lines) == sum(not re.search(r"-r[1-9][0-9]*$", d)
                             for r in out.values() for d in r["run_dirs"])
    for ln in lines:
        if ln["run"].split("/")[0] in NOT_FILED:
            assert ln["contract"] is None and ln["verdict"] is None
            continue
        assert ln["verdict"].startswith("OK"), ln
        assert ln["rules_ok"], ln
        if "join_ok" in ln:
            assert ln["join_ok"] and not ln["violations"], ln
    assert sum("join_ok" in ln for ln in lines) == 5
