"""The MoE transformer's dp × ep step and FSDP with MoE on 2 and 4 gloo
ranks against the JAX reference's ``shard_map`` steps on as many CPU
devices: every case of the reference's ``tests/test_moe_lm.py`` but
the dp × sp × ep one (ring attention; ``test_torch_2d.py`` holds it),
with top-2, the router's lr multiplier and z-loss, the no-drop loss
against the all-local model, the shim's counts against
``contracts.moe_step_collectives`` and the ``train.moe`` twin under
torchrun.  Each world size is one spawn of n ranks (child processes
that import torch, numpy and the port only).  Tiers: counts bitwise;
losses rtol 2e-4 and params atol 2e-4 (below).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_fsdp import _flat, _unflat, spawn_ranks
from test_torch_moe_lm import JCFG, MOE, PCFG, _batch, _jparams, _tb

from distributed_training_sandbox_tpu.parallel import expert as JE
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import expert as PE
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    moe_step_collectives)

WORLDS = (2, 4)
# loss rtol and param atol of the multi-rank steps: test_torch_fsdp's
# loss tier; the params at test_torch_pipeline's TINY_LM tier, 2e-4 (two
# Adam steps move a weight whose grad is near zero by about ±lr, so a
# last-bit grad difference there reads up to ~1e-4 on these steps)
LOSS_RTOL, PARAM_ATOL = 2e-4, 2e-4

# name: (dp, ep, config overrides)
STEP_CASES = {
    2: {"dp1_ep2": (1, 2, {}),
        "dp1_ep2_top2": (1, 2, dict(moe_top_k=2)),
        "dp1_ep2_router": (1, 2, dict(moe_router_lr_mult=0.5,
                                      moe_router_z_weight=1e-3)),
        "nodrop": (1, 2, dict(moe_capacity_factor=8.0,
                              moe_aux_weight=0.0))},
    4: {"dp2_ep2": (2, 2, {}),
        "dp1_ep4": (1, 4, {}),
        "dp2_ep2_top2": (2, 2, dict(moe_top_k=2)),
        "nodrop": (2, 2, dict(moe_capacity_factor=8.0,
                              moe_aux_weight=0.0))},
}
FSDP_CASE = dict(moe_router_lr_mult=0.5)
STEPS = 2

WORKER = r"""
import dataclasses, json, sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.parallel import expert, fsdp, optim
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
mesh.init_process_group("cpu")
n, r = mesh.axis_size(), mesh.axis_rank()
tree = {}
for key, v in dict(np.load(work / "params.npz")).items():
    *parents, leaf = key.split("/")
    node = tree
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = v
data = np.load(work / "batch.npz")
batch = (torch.from_numpy(data["ids"]), torch.from_numpy(data["labels"]))
base = json.loads((work / "base.json").read_text())
cases = json.loads((work / "cases.json").read_text())
res = {}

def record(name, shards, losses, counts):
    res[f"{name}/losses"] = np.array(losses)
    res[f"{name}/counts"] = np.array(json.dumps(counts))
    for path, t in optim.tree_leaves(bridge.params_to_numpy(shards)):
        res[f"{name}/shard/" + "/".join(path)] = t

for name, (dp, ep, kw) in cases.items():
    cfg = dataclasses.replace(T.TINY_LM, **{**base, **kw})
    dp_ax, ep_ax = mesh.dp_ep_axes(dp, ep)
    shards = bridge.moe_shards_from_jax(tree, cfg, mesh.axis_rank(ep_ax), ep)
    opt = optim.adam_init(shards)
    step = expert.make_moe_lm_train_step(shards, cfg, dp_axis=dp_ax,
                                         ep_axis=ep_ax)
    losses, counts = [], []
    for _ in range(int(sys.argv[2])):
        C.COLLECTIVES.reset()
        shards, opt, loss = step(shards, opt, batch)
        counts.append(C.COLLECTIVES.read())
        losses.append(float(loss))
    record(name, shards, losses, counts)
    res[f"{name}/ranks"] = np.array([mesh.axis_rank(dp_ax),
                                     mesh.axis_rank(ep_ax)])
# FSDP with MoE: every expert leaf sharded on E
cfg = dataclasses.replace(T.TINY_LM, **{**base, **json.loads(sys.argv[3])})
shards = bridge.shards_from_jax(tree, cfg, r, n)
opt = fsdp.init_fsdp_opt_state(shards)
step = fsdp.make_fsdp_train_step(shards, cfg, lr=3e-4)
losses = []
for _ in range(int(sys.argv[2])):
    shards, opt, loss = step(shards, opt, batch)
    losses.append(float(loss))
record("fsdp", shards, losses, [])
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


@pytest.fixture(scope="module")
def reference():
    return _jparams(JCFG, 3), _batch(512, seed=4)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, reference, procs2, tmp_path_factory):
    n = request.param
    params, (ids, labels) = reference
    work = tmp_path_factory.mktemp(f"moe_lm{n}")
    np.savez(work / "params.npz", **dict(_flat(params)))
    np.savez(work / "batch.npz", ids=ids, labels=labels)
    (work / "base.json").write_text(json.dumps(MOE))
    (work / "cases.json").write_text(json.dumps(STEP_CASES[n]))
    spawn_ranks(["-c", WORKER, str(work), str(STEPS), json.dumps(FSDP_CASE)],
                n, procs2.free_port())
    return n, [dict(np.load(work / f"rank{r}.npz")) for r in range(n)]


def _rank_tree(rk, name):
    pre = f"{name}/shard/"
    return _unflat({k[len(pre):]: v for k, v in rk.items()
                    if k.startswith(pre)})


def _jax_moe_step(n, dp, ep, kw):
    params, (ids, labels) = _jparams(JCFG, 3), _batch(512, seed=4)
    cfg = dataclasses.replace(JCFG, **kw)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(dp, ep), ("dp", "ep"))
    shards = JE.shard_moe_lm_params(jax.tree.map(jnp.asarray, params), mesh)
    opt = JF.init_fsdp_opt_state(shards)
    step = JE.make_moe_lm_train_step(shards, cfg, mesh, donate=False)
    losses = []
    for _ in range(STEPS):
        shards, opt, loss = step(shards, opt, (jnp.asarray(ids),
                                               jnp.asarray(labels)))
        losses.append(float(loss))
    return losses, dict(_flat(jax.tree.map(np.asarray, shards)))


def test_dp_ep_steps_match_the_reference(world):
    """Two dp × ep steps on n gloo ranks against the reference's jitted
    ``make_moe_lm_train_step`` on a (dp, ep) mesh of n CPU devices, for
    each layout and option of ``STEP_CASES`` (top-2; the router's lr
    multiplier with the z-loss): the loss on every rank (the mean over
    the group, so bitwise the same on each) rtol 2e-4; every leaf
    assembled from each dp row's ep ranks (the replicated leaves
    bitwise equal across all ranks) atol 2e-4."""
    n, ranks = world
    for name, (dp, ep, kw) in STEP_CASES[n].items():
        jl, jp = _jax_moe_step(n, dp, ep, kw)
        for rk in ranks:
            np.testing.assert_array_equal(rk[f"{name}/losses"],
                                          ranks[0][f"{name}/losses"])
        np.testing.assert_allclose(ranks[0][f"{name}/losses"], jl,
                                   rtol=LOSS_RTOL, err_msg=name)
        rows = {}
        for rk in ranks:
            d, e = rk[f"{name}/ranks"]
            rows.setdefault(int(d), {})[int(e)] = _rank_tree(rk, name)
        for d, row in rows.items():
            full = dict(_flat(bridge.assemble_moe_shards(
                [row[e] for e in range(ep)])))
            assert sorted(full) == sorted(jp)
            for k, v in full.items():
                np.testing.assert_allclose(v, jp[k], rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"{name} dp {d}: {k}")
        flat0 = dict(_flat(_rank_tree(ranks[0], name)))
        for rk in ranks[1:]:
            for k, v in _flat(_rank_tree(rk, name)):
                if not any(x in k for x in PE.EXPERT_LEAVES):
                    np.testing.assert_array_equal(v, flat0[k], err_msg=k)


def test_dp_ep_step_collectives_follow_the_moe_contract(world):
    """bitwise: each step's shim counts are ``moe_step_collectives`` of
    the rank's tree (TINY_LM runs without remat)."""
    n, ranks = world
    for name, (dp, ep, kw) in STEP_CASES[n].items():
        for rk in ranks:
            want = moe_step_collectives(
                _rank_tree(rk, name), remat=PT.TINY_LM.remat,
                z_loss=bool(kw.get("moe_router_z_weight")))
            for c in json.loads(str(rk[f"{name}/counts"])):
                assert c == want, (name, c, want)


def test_ep_sharded_loss_matches_the_local_computation(world):
    """At no-drop capacity with no aux, the expert-sharded step's first
    loss equals the mean of each rank's chunk through the all-local
    model (``ep_axis=None``), as the reference pins it."""
    n, ranks = world
    params, (ids, labels) = _jparams(JCFG, 3), _batch(512, seed=4)
    cfg = dataclasses.replace(PCFG, moe_capacity_factor=8.0,
                              moe_aux_weight=0.0)
    pp = bridge.params_from_jax(params, cfg)
    with torch.no_grad():
        m = len(ids) // n
        want = np.mean([float(PT.lm_loss(pp, _tb((ids[i:i + m],
                                                  labels[i:i + m])), cfg))
                        for i in range(0, len(ids), m)])
    assert float(ranks[0]["nodrop/losses"][0]) == pytest.approx(want,
                                                                abs=2e-5)


def test_fsdp_with_moe_matches_the_reference(world):
    """FSDP (overlap "none") with MoE at n ranks, the expert leaves
    sharded on E and the router at ``moe_router_lr_mult`` 0.5, against
    the reference's FSDP step on n devices: losses rtol 2e-4, every
    reassembled leaf atol 2e-4."""
    n, ranks = world
    params, (ids, labels) = _jparams(JCFG, 3), _batch(512, seed=4)
    cfg = dataclasses.replace(JCFG, **FSDP_CASE)
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    shards = JF.shard_params_fsdp(jax.tree.map(jnp.asarray, params), mesh)
    opt = JF.init_fsdp_opt_state(shards)
    step = JF.make_fsdp_train_step(shards, cfg, mesh, lr=3e-4, donate=False)
    losses = []
    for _ in range(STEPS):
        shards, opt, loss = step(shards, opt, (jnp.asarray(ids),
                                               jnp.asarray(labels)))
        losses.append(float(loss))
    np.testing.assert_allclose(ranks[0]["fsdp/losses"], losses,
                               rtol=LOSS_RTOL)
    full = dict(_flat(bridge.assemble_shards([_rank_tree(rk, "fsdp")
                                              for rk in ranks])))
    want = dict(_flat(jax.tree.map(np.asarray, shards)))
    for k, v in full.items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def test_moe_twin_trains_under_torchrun(procs2, tmp_path):
    """``train.moe`` on two gloo ranks (dp 1 × ep 2) under torchrun,
    with RunState checkpoints: the losses are finite, each step's
    collectives are the contract's, and rank 0 writes its result."""
    out = tmp_path / "moe.json"
    spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch.train.moe",
                 "--device", "cpu", "--model", "tiny", "--ep", "2",
                 "--num-steps", "3", "--sequence-length", "64",
                 "--checkpoint-dir", str(tmp_path / "ck"),
                 "--checkpoint-every", "2", "--no-telemetry", "--no-profile",
                 "--out", str(out)], 2, procs2.free_port())
    res = json.loads(out.read_text())
    assert res["ep"] == 2 and res["dp"] == 1 and len(res["losses"]) == 3
    assert all(np.isfinite(res["losses"]))
    assert all(c == res["contract"] for c in res["collectives"])
    assert res["saves"], "no RunState checkpoint was written"
