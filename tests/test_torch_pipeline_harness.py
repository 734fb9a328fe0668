"""The pipeline twin under the run harness, on the CPU, in one process:
preempt → resume equals the uninterrupted run bit for bit (every loss,
every final param and Adam moment, the step count) for GPipe, 1F1B and
interleaved 1F1B on the PP toy, and under ``--opt8``; a resume that
restores the params but not the Adam state breaks it; a profiled run's
summary carries the comm/compute split (no hops on one device) and the
empty ledger of the zero-collective contract.
"""

import json
from pathlib import Path

import pytest

from distributed_training_sandbox_tpu_torch.parallel import optim as PO
from distributed_training_sandbox_tpu_torch.parallel import pipeline as PP
from distributed_training_sandbox_tpu_torch.train import pipeline as TP
from distributed_training_sandbox_tpu_torch.train.harness import (
    quiet_config)
from distributed_training_sandbox_tpu_torch.utils import checkpoint as CK
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

EPOCHS = 6
CASES = {"gpipe": ("gpipe", False), "1f1b": ("1f1b", False),
         "interleaved": ("interleaved", False), "1f1b-opt8": ("1f1b", True)}


def _run(schedule, opt8, config=None):
    return TP.run(schedule, n_stages=4 if schedule == "interleaved" else 2,
                  num_epochs=EPOCHS, batch_size=16, device="cpu", opt8=opt8,
                  config=config, keep_stages=True, log=lambda *a: None)


def _state(res):
    """Every stage's params and optimizer state, flattened."""
    return [CK.flatten({"p": s.params, "o": s.opt_state})
            for s in res["stages"]]


def _same(a, b) -> bool:
    return all(x.keys() == y.keys() and all(
        torch.equal(x[k], y[k]) if isinstance(x[k], torch.Tensor)
        else x[k] == y[k] for k in x) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def uninterrupted():
    return {name: _run(*case) for name, case in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_preempt_resume_is_bitwise_the_uninterrupted_run(uninterrupted,
                                                         tmp_path, name):
    schedule, opt8 = CASES[name]
    # a checkpoint at every epoch's sync point, the last at the preemption
    cfg = quiet_config(checkpoint_dir=str(tmp_path / "ck"),
                       checkpoint_every=1, inject_fault="preempt@3",
                       max_restarts=1)
    res = _run(schedule, opt8, cfg)
    ref = uninterrupted[name]
    assert res["status"] == "completed" and res["start_epoch"] == 3
    assert [s["status"] for s in res["lineage"]["segments"]] == \
        ["preempted", "completed"]
    assert res["losses"] == ref["losses"] and len(res["losses"]) == EPOCHS
    assert _same(_state(res), _state(ref))
    assert res["final_loss_batch0"] == ref["final_loss_batch0"]
    assert [sv["step"] for sv in res["saves"]][:3] == [0, 1, 2]


def test_a_resume_without_the_adam_state_breaks_the_law(uninterrupted,
                                                        tmp_path,
                                                        monkeypatch):
    def params_only(self, params, opt_state):
        with torch.no_grad():
            for (_, p), (_, q) in zip(PO.tree_leaves(self.params),
                                      PO.tree_leaves(params)):
                p.copy_(q)
    monkeypatch.setattr(PP.PipelineStage, "load_state", params_only)
    cfg = quiet_config(checkpoint_dir=str(tmp_path / "ck"),
                       inject_fault="preempt@3", max_restarts=1)
    res = _run("1f1b", False, cfg)
    ref = uninterrupted["1f1b"]
    assert res["losses"][:3] == ref["losses"][:3]
    assert res["losses"][3:] != ref["losses"][3:]


def test_the_twin_resumes_and_profiles_on_the_cpu(tmp_path, capsys):
    """``--trace-dir`` and ``--prefetch-depth``: the run dir's summary
    carries the split of its owned session (every op on the CPU, no hop:
    the stages share the device) and the ledger joined empty; then
    ``--resume`` past the end replays nothing."""
    args = ["--device", "cpu", "--schedule", "1f1b", "--num-epochs", "12",
            "--batch-size", "16", "--trace-dir", str(tmp_path / "tr"),
            "--prefetch-depth", "2", "--results-dir", str(tmp_path / "runs"),
            "--checkpoint-dir", str(tmp_path / "ck")]
    TP.main(args)
    out = capsys.readouterr().out
    res = json.loads(next(line for line in out.splitlines()
                          if line.startswith("[1f1b] {"))[len("[1f1b] "):])
    assert res["pump"] == {"prefetch_depth": 2, "dispatch": "host-prefetch"}
    summary = json.loads((Path(res["run_dir"]) / "summary.json").read_text())
    sp = summary["comm_split"]
    assert sp is not None and "comm_split_error" not in summary
    assert sp["compute_us"] > 0 and sp["comm_us"] == 0.0
    assert summary["ledger"]["ok"] and summary["ledger"]["traced_steps"] == 5
    TP.main(args + ["--resume"])
    again = json.loads(next(
        line for line in capsys.readouterr().out.splitlines()
        if line.startswith("[1f1b] {"))[len("[1f1b] "):])
    assert again["start_epoch"] == 12 and again["losses"] == res["losses"]
