"""The composable twin (``train/train_composable.py``) and the zigzag
FLOP count (``train/zigzag_flops.py``) on gloo ranks.

* One spawn of 4 ranks runs the twin: ``fsdp2xtp2`` (the 3-axis step)
  uninterrupted and preempted at step 2 then resumed under the same
  plan: the losses and every rank's final shards bit for bit the
  uninterrupted run's (the port's resume law); a resume of that
  checkpoint under ``dp2xtp2`` is refused, naming A12 (resharding);
  ``dp4xw3`` on the toy MLP; every run's manifest verdicts ok (the twin
  fails a step whose calls differ from the generated contract, or
  shards that break their rules).  ``--plan`` is refused, naming A12.
* ``zigzag_flops`` on 4 gloo ranks (sp 4): the ring's forward FLOPs
  under zigzag over contiguous equal ``MERGES``' score-element ratio,
  10/16, and the step's saved FLOPs are three times the ring forward's
  (forward, and the backward's two products for each), exactly.
"""

import json

import numpy as np
import pytest
from test_torch_fsdp import spawn_ranks
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

WORKER = r"""
import hashlib, json, sys
from pathlib import Path
import torch
from distributed_training_sandbox_tpu_torch.parallel import optim
from distributed_training_sandbox_tpu_torch.train import train_composable as TC
from distributed_training_sandbox_tpu_torch.train.harness import quiet_config
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
mesh.init_process_group("cpu")
r = mesh.axis_rank()
quiet = lambda *a, **k: None

def digest(tree):
    h = hashlib.sha256()
    for _, t in optim.tree_leaves(tree):
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()

def cfg(tag, **kw):
    return quiet_config(checkpoint_dir=str(work / "ck" / tag),
                        checkpoint_every=1, **kw)

LM = dict(num_steps=4, seq=64, device="cpu", log=quiet, keep_params=True)
out = {}
a = TC.run("fsdp2xtp2", config=cfg("a"), **LM)
b = TC.run("fsdp2xtp2", config=cfg("b", inject_fault="preempt@2",
                                   max_restarts=1), **LM)
for k, res in (("plain", a), ("resumed", b)):
    out[k] = {"losses": res["losses"], "status": res["status"],
              "start": res["start_step"], "digest": digest(res["params"]),
              "contract_ok": res["contract_ok"], "rules_ok": res["rules"]["ok"],
              "strategy": res["strategy"],
              "segments": len(res["lineage"]["segments"])}
try:
    TC.run("dp2xtp2", config=cfg("b", resume=True), **LM)
    out["cross_plan"] = "not refused"
except SystemExit as e:
    out["cross_plan"] = str(e)
m = TC.run("dp4xw3", scale=500, num_steps=3, device="cpu", log=quiet)
out["mlp"] = {"strategy": m["strategy"], "contract_ok": m["contract_ok"],
              "rules_ok": m["rules"]["ok"], "losses": m["losses"]}
if r == 0:
    (work / "out.json").write_text(json.dumps(out))
mesh.destroy_process_group()
"""


@pytest.fixture(scope="module")
def twin(procs2, tmp_path_factory):
    work = tmp_path_factory.mktemp("composable_twin")
    outs = spawn_ranks(["-c", WORKER, str(work)], 4, procs2.free_port())
    return json.loads((work / "out.json").read_text()), outs


def test_same_plan_resume_is_bit_equal(twin):
    out, _ = twin
    a, b = out["plain"], out["resumed"]
    assert a["strategy"] == "composable_dp_fsdp_tp"
    assert b["segments"] == 2 and a["segments"] == 1
    assert b["losses"] == a["losses"] and len(a["losses"]) == 4
    assert np.isfinite(a["losses"]).all()
    assert b["digest"] == a["digest"]
    for r in (a, b):
        assert r["contract_ok"] and r["rules_ok"]


def test_cross_plan_resume_and_tuner_plans_are_refused(twin):
    out, _ = twin
    assert "A12" in out["cross_plan"] and "resharding" in out["cross_plan"]
    from distributed_training_sandbox_tpu_torch.train import train_composable
    with pytest.raises(SystemExit, match="A12"):
        train_composable.main(["--mesh", "fsdp2xtp2", "--plan", "p.json"])


def test_mlp_plan_runs_its_contract(twin):
    out, _ = twin
    m = out["mlp"]
    assert m["strategy"] == "zero3" and m["contract_ok"] and m["rules_ok"]
    assert np.isfinite(m["losses"]).all()


def test_zigzag_flops_equal_the_score_element_ratio(procs2, tmp_path):
    path = tmp_path / "zz.json"
    spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch.train."
                 "zigzag_flops", "--device", "cpu", "--sp", "4", "--seq",
                 "256", "--out", str(path)], 4, procs2.free_port())
    res = json.loads(path.read_text())
    c, z = res["contiguous"], res["zigzag"]
    assert z["score_elements"] * 16 == c["score_elements"] * 10
    assert z["ring_forward_flops"] * 16 == c["ring_forward_flops"] * 10
    assert res["expected_ratio"] == 10 / 16
    assert c["masked_merges"] > 0 and z["masked_merges"] == 0
    assert (c["step_flops"] - z["step_flops"]
            == 3 * (c["ring_forward_flops"] - z["ring_forward_flops"]))
