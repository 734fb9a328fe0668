"""The collective ledger's law on two gloo ranks: one spawn of two ranks
(child processes importing torch, numpy and the port only) runs the DDP
twin (the toy MLP at scale 200) and the FSDP twin (TINY_LM), each
profiled over a few steps.  Over the traced window the trace's
collective calls of each kind equal the shim's calls a step times the
traced steps, the join against the contract (``parallel.contracts``) is
ok, and it is not ok once a kind is dropped from the expected dict.
The JAX package's report renders the run directories the two ranks
wrote, bandwidth table included, to the same text and JSON as the
port's.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_training_sandbox_tpu_torch.telemetry import ledger as PL
from distributed_training_sandbox_tpu_torch.train import report as PRS
from distributed_training_sandbox_tpu_torch.utils import (
    trace_analysis as PTA)
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

REPO = Path(__file__).resolve().parent.parent
STEPS = 5
TWINS = ("ddp", "fsdp")

WORKER = r"""
import json, sys
from pathlib import Path
work = Path(sys.argv[1])
import torch
torch.set_num_threads(1)
from distributed_training_sandbox_tpu_torch.train import ddp, train_fsdp
from distributed_training_sandbox_tpu_torch.train.harness import quiet_config
from distributed_training_sandbox_tpu_torch.utils import mesh
from distributed_training_sandbox_tpu_torch.utils.profiling import (
    ProfileSchedule)
mesh.init_process_group("cpu")
rank = mesh.axis_rank()
quiet = lambda *a, **k: None
sched = ProfileSchedule(skip_first=1, wait=0, warmup=1, active=2)

def cfg(tag):
    return quiet_config(telemetry=True, profile=True,
                        results_dir=str(work / "runs"),
                        trace_dir=str(work / "traces" / tag))

out = {}
r = ddp.run(scale=200, num_steps=int(sys.argv[2]), batch_size=16,
            device="cpu", log=quiet, config=cfg("ddp"),
            profile_schedule=sched)
out["ddp"] = {"run_dir": r["run_dir"], "collectives": r["collectives"]}
r = train_fsdp.run(model="tiny", num_steps=int(sys.argv[2]), seq=32,
                   batch_size=4, device="cpu", log=quiet,
                   config=cfg("fsdp"), profile_schedule=sched)
out["fsdp"] = {"run_dir": r["run_dir"], "collectives": r["collectives"]}
(work / f"out{rank}.json").write_text(json.dumps(out))
mesh.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, procs2):
    work = tmp_path_factory.mktemp("ledger")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(procs2.free_port()),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(work), str(STEPS)], cwd=REPO,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {r} ({p.returncode}):\n{o[-3000:]}"
        for r, (p, o) in enumerate(zip(procs, outs)))
    return work, json.loads((work / "out0.json").read_text())


def _run_files(run_dir):
    d = Path(run_dir)
    return (json.loads((d / "summary.json").read_text()),
            json.loads((d / "collectives.json").read_text()))


@pytest.mark.parametrize("twin", TWINS)
def test_measured_calls_are_the_shims_times_the_traced_steps(runs, twin):
    _, out = runs
    summary, led = _run_files(out[twin]["run_dir"])
    assert "ledger_error" not in summary and "comm_split_error" not in summary
    steps = summary["ledger"]["traced_steps"]
    assert steps == 3 and summary["ledger"]["ok"]
    assert led["contract_join"]["ok"], led["contract_join"]["violations"]
    per_step = out[twin]["collectives"]
    assert all(c == per_step[0] for c in per_step)
    traced = PTA.collective_event_stats(summary["comm_split"]["trace_file"])
    measured: dict = {}
    for e in led["entries"]:
        assert e["occurrences"] == steps and e["payload_bytes"] > 0
        measured[e["kind"]] = measured.get(e["kind"], 0) + e["occurrences"]
    want = {k: v * steps for k, v in per_step[0].items() if v}
    assert measured == want
    assert {k: r["count"] for k, r in traced.items()} == want
    assert summary["comm_split"]["comm_us"] > 0
    assert summary["comm_split"]["compute_us"] > 0
    # the bandwidth table's rows: the gloo group's axis, measured busbw
    assert {a["axis"] for a in led["aggregates"].values()} == {"dp"}


@pytest.mark.parametrize("twin", TWINS)
def test_a_kind_dropped_from_the_contract_fails_the_join(runs, twin):
    _, out = runs
    _, doc = _run_files(out[twin]["run_dir"])
    led = PL.CollectiveLedger(
        entries=[PL.LedgerEntry(**e) for e in doc["entries"]],
        unmatched_events=doc["unmatched_events"],
        unmeasured_instances=doc["unmeasured_instances"],
        axis_sizes=doc["axis_sizes"])
    expected = doc["contract_join"]["expected"]
    assert PL.join_contract(led, expected, twin)["ok"]
    for kind in [k for k, v in expected.items() if v]:
        verdict = PL.join_contract(
            led, {k: v for k, v in expected.items() if k != kind}, twin)
        assert not verdict["ok"]
        assert any(v.startswith(f"{kind}:") for v in verdict["violations"])


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_the_references_report_renders_the_ranks_runs_alike(runs, capsys,
                                                            as_json):
    work, _ = runs
    spec = importlib.util.spec_from_file_location(
        "ref_report", REPO / "scripts" / "report.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    argv = [str(work / "runs"), "--nccl-baseline",
            str(REPO / "baselines" / "nccl_reference.json"),
            "--roofline", str(work / "none.json")] + ["--json"] * as_json
    got = []
    for main in (ref.main, PRS.main):
        rc = main(list(argv))
        got.append((rc, capsys.readouterr().out))
    assert got[0] == got[1] and got[1][0] == 0
    if not as_json:
        assert "Collective bus bandwidth" in got[1][1]
