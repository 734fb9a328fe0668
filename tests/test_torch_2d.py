"""The dp × sp × ep MoE step and the two-axis twins (``train.train_tp``,
``train.train_sp``) on gloo ranks, against the JAX reference.

* two dp 1 × sp 2 × ep 2 MoE steps (ring attention over sp, the experts
  over ep) on 4 ranks against the reference's
  ``make_moe_lm_train_step(sp_axis="sp")`` on a (dp, sp, ep) mesh of 4
  CPU devices: loss rtol 2e-4, params atol 2e-4 (the tiers of
  ``test_torch_moe_ranks.py``); the shim's counts
  ``contracts.moe_step_collectives(sp=2)``;
* ``train.train_tp`` and ``train.train_sp`` as ``torchrun
  --nproc-per-node 2`` starts them, on the CPU, writing their run
  directories; each step's collectives the contract's;
* the sp and tp twins agree on their first loss (same seed, model and
  batch through two shardings), as the reference's
  ``tests/test_2d_scripts.py`` checks, within 2e-4.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from test_torch_fsdp import KINDS, _flat, _unflat, spawn_ranks
from test_torch_moe_lm import JCFG, MOE, _batch, _jparams
from test_torch_tensor import PRELUDE, sub

from distributed_training_sandbox_tpu.parallel import expert as JE
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import expert as PE
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    moe_step_collectives)
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

LOSS_RTOL, PARAM_ATOL = 2e-4, 2e-4
STEPS = 2
TWIN_AGREE_ATOL = 2e-4

WORKER = PRELUDE + r"""
cfg = cfg_of("moe")
tree = tree_of("moe")
ax = grid(("dp", "sp", "ep"), (1, 2, 2))
shards = bridge.moe_shards_from_jax(tree, cfg, mesh.axis_rank(ax["ep"]), 2)
opt = optim.adam_init(shards)
step = expert.make_moe_lm_train_step(shards, cfg, dp_axis=ax["dp"],
                                     ep_axis=ax["ep"], sp_axis=ax["sp"])
losses, counts = [], []
for _ in range(int(sys.argv[2])):
    C.COLLECTIVES.reset()
    shards, opt, loss = step(shards, opt, batch)
    counts.append(counts_now())
    losses.append(float(loss))
res["losses"], res["counts"] = np.array(losses), np.array(counts)
res["coords"] = np.array([mesh.axis_rank(ax[a]) for a in ("dp", "sp", "ep")])
put("shard/", bridge.params_to_numpy(shards))
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


@pytest.fixture(scope="module")
def moe_world(procs2, tmp_path_factory):
    work = tmp_path_factory.mktemp("moe_sp")
    params, (ids, labels) = _jparams(JCFG, 3), _batch(512, seed=4)
    np.savez(work / "params_moe.npz", **dict(_flat(params)))
    np.savez(work / "batch.npz", ids=ids, labels=labels)
    (work / "cases.json").write_text("{}")
    (work / "cfgs.json").write_text(json.dumps({"moe": MOE}))
    spawn_ranks(["-c", WORKER, str(work), str(STEPS)], 4, procs2.free_port())
    return params, (ids, labels), [dict(np.load(work / f"rank{r}.npz"))
                                   for r in range(4)]


def test_dp_sp_ep_step_matches_the_reference(moe_world):
    """Two dp 1 × sp 2 × ep 2 steps against the reference's mesh step:
    every rank's loss the same and rtol 2e-4 of the reference's; each
    sp chunk's ep ranks' shards assembled (``assemble_moe_shards``) atol
    2e-4; the replicated leaves equal across every rank; the ranks laid
    out as the reference's mesh (row-major over dp, sp, ep); each step's
    counts ``moe_step_collectives(sp=2)`` of the rank's tree."""
    params, batch, ranks = moe_world
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 2, 2),
                ("dp", "sp", "ep"))
    shards = JE.shard_moe_lm_params(jax.tree.map(jnp.asarray, params), mesh)
    opt = JF.init_fsdp_opt_state(shards)
    step = JE.make_moe_lm_train_step(shards, JCFG, mesh, sp_axis="sp",
                                     donate=False)
    losses = []
    for _ in range(STEPS):
        shards, opt, loss = step(shards, opt, tuple(map(jnp.asarray, batch)))
        losses.append(float(loss))
    jp = dict(_flat(jax.tree.map(np.asarray, shards)))
    for r, rk in enumerate(ranks):
        assert list(rk["coords"]) == [0, r // 2, r % 2]
        np.testing.assert_array_equal(rk["losses"], ranks[0]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=LOSS_RTOL)
    for s in (0, 1):
        row = [_unflat(sub(rk, "shard/")) for rk in ranks
               if rk["coords"][1] == s]
        full = dict(_flat(bridge.assemble_moe_shards(row)))
        assert sorted(full) == sorted(jp)
        for k, v in full.items():
            np.testing.assert_allclose(v, jp[k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"sp {s}: {k}")
    flat0 = dict(_flat(_unflat(sub(ranks[0], "shard/"))))
    for rk in ranks[1:]:
        for k, v in _flat(_unflat(sub(rk, "shard/"))):
            if not any(x in k for x in PE.EXPERT_LEAVES):
                np.testing.assert_array_equal(v, flat0[k], err_msg=k)
    for rk in ranks:
        want = moe_step_collectives(_unflat(sub(rk, "shard/")),
                                    remat=False, sp=2)
        for row in rk["counts"]:
            assert list(row) == [want[k] for k in KINDS]


def _twin(mode, procs2, tmp_path) -> tuple[dict, list]:
    out = tmp_path / f"{mode}.json"
    outs = spawn_ranks(
        ["-m", f"distributed_training_sandbox_tpu_torch.train.train_{mode}",
         "--device", "cpu", "--model", "tiny", f"--{mode}", "2",
         "--num-steps", "2", "--sequence-length", "32",
         "--results-dir", str(tmp_path / f"runs_{mode}"),
         "--trace-dir", str(tmp_path / f"traces_{mode}"), "--out", str(out)],
        2, procs2.free_port())
    return json.loads(out.read_text()), outs


@pytest.fixture(scope="module")
def twins(procs2, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("twins")
    return {mode: _twin(mode, procs2, tmp) for mode in ("tp", "sp")}, tmp


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_twin_trains_under_torchrun(twins, mode):
    """The twin as ``torchrun --nproc-per-node 2`` starts it, for two
    steps on the CPU: finite losses, every step's collectives the
    contract's (the mesh dp 1 × 2), the contract printed, and a run
    directory a rank with its manifest, ``steps.jsonl`` and summary."""
    (res, outs), tmp = twins[0][mode], twins[1]
    assert res[mode] == 2 and res["dp"] == 1 and res["world_size"] == 2
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["contract"]["ok"] and res["contract_ok"]
    assert f"contract[{mode}]: OK" in outs[0]
    assert f"[train_{mode}] step   0 loss" in outs[0]
    runs = sorted(Path(tmp / f"runs_{mode}").iterdir())
    assert len(runs) == 2, runs
    for run in runs:
        for name in ("manifest.json", "steps.jsonl", "summary.json"):
            assert (run / name).exists(), (run, name)


def test_sp_and_tp_twins_agree_on_step_zero(twins):
    """The same seed, model and batch through two shardings (tp 2 and
    sp 2) give the same first loss, within 2e-4."""
    tp, sp = twins[0]["tp"][0], twins[0]["sp"][0]
    assert tp["batch_size"] == sp["batch_size"]
    assert abs(tp["losses"][0] - sp["losses"][0]) < TWIN_AGREE_ATOL


def test_twin_refusals(tmp_path):
    """``--plan`` is refused by name (the memory planner, A12); the tp
    twin refuses an fsdp overlap mode and a tp that does not divide the
    heads; the sp twin a sequence sp does not divide."""
    from distributed_training_sandbox_tpu_torch.train import _2d
    with pytest.raises(SystemExit, match="A12"):
        _2d.main("tp", ["--plan", str(tmp_path / "p.json"), "--device",
                        "cpu"])
    with pytest.raises(ValueError, match="ring_fused is an fsdp mode"):
        _2d._check("tp", PT.TINY_LM, 1, 1, 32, "ring_fused")
    with pytest.raises(ValueError, match="tp=3"):
        _2d._check("tp", PT.TINY_LM, 3, 3, 32, "none")
    with pytest.raises(ValueError, match="divisible by sp=3"):
        _2d._check("sp", PT.TINY_LM, 3, 3, 32, "none")
    with pytest.raises(ValueError, match="must be >= 1 and divide"):
        _2d._check("sp", PT.TINY_LM, 3, 4, 48, "none")
