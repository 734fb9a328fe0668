"""FSDP's auto variant (``parallel.fsdp.make_fsdp_auto_train_step`` over
``torch.distributed.fsdp.fully_shard``) on 2 gloo ranks, against the
JAX reference's ``make_fsdp_auto_train_step`` (jit with sharding
constraints) on a 2-device CPU mesh and against the port's explicit
step, on TINY_LM with the reference's weights and batches.

Tiers, ``test_torch_fsdp.py``'s (f32 math reduced in other orders by
XLA, torch and gloo): three steps, losses rtol 2e-4 and every
reassembled param atol 1e-4, remat off and on.  Against the explicit
step: each rank's shards are the same shapes and the same rows, bit for
bit, before the first step (``fully_shard``'s placement is
``shard_tree``'s); three steps at the same tiers.  The grads
``fully_shard`` hands Adam are the ranks' mean (its divide factor, the
rank count).  The ``train_fsdp --variant auto`` twin under torchrun
agrees with ``--variant explicit`` on its first loss; the knobs the auto
variant does not take are refused.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from test_torch_fsdp import (LR, STEPS, _flat, _unflat, reference,  # noqa: F401
                             spawn_ranks)

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu_torch import bridge
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

N = 2
REMATS = (False, True)

WORKER = r"""
import dataclasses, json, sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.parallel import fsdp, optim
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
lr = float(sys.argv[2])
mesh.init_process_group("cpu")
n, r = mesh.axis_size(), mesh.axis_rank()
flat = dict(np.load(work / "params.npz"))
tree = {}
for key, v in flat.items():
    *parents, leaf = key.split("/")
    node = tree
    for p in parents:
        node = node.setdefault(p, {})
    node[leaf] = v
data = np.load(work / "batches.npz")
res = {}
for remat in json.loads((work / "remats.json").read_text()):
    cfg = dataclasses.replace(T.TINY_LM, remat=remat)
    full = bridge.params_from_jax(tree, cfg)
    module = fsdp.fully_shard_params(full, cfg)
    auto = fsdp.auto_shards(module)
    expl = fsdp.shard_params_fsdp(optim.tree_map(lambda x: x.clone(), full))
    res[f"{remat}/same_rows"] = np.array(all(
        torch.equal(x, optim.tree_get(expl, p))
        for p, x in optim.tree_leaves(auto)))
    sa = fsdp.make_fsdp_auto_train_step(module, lr=lr)
    se = fsdp.make_fsdp_train_step(expl, cfg, lr=lr)
    oa, oe = fsdp.init_fsdp_opt_state(auto), fsdp.init_fsdp_opt_state(expl)
    la, le, counts = [], [], []
    for i in range(data["ids"].shape[0]):
        b = (torch.from_numpy(data["ids"][i]),
             torch.from_numpy(data["labels"][i]))
        C.COLLECTIVES.reset()
        auto, oa, l1 = sa(auto, oa, b)
        counts.append(C.COLLECTIVES.read()["all_reduce"])
        expl, oe, l2 = se(expl, oe, b)
        la.append(float(l1)), le.append(float(l2))
    res[f"{remat}/auto_losses"] = np.array(la)
    res[f"{remat}/expl_losses"] = np.array(le)
    res[f"{remat}/loss_calls"] = np.array(counts)
    for p, x in optim.tree_leaves(auto):
        res[f"{remat}/auto/" + "/".join(p)] = x.numpy()
    for p, x in optim.tree_leaves(expl):
        res[f"{remat}/expl/" + "/".join(p)] = x.numpy()
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


@pytest.fixture(scope="module")
def world(reference, procs2, tmp_path_factory):  # noqa: F811
    params, ids, labels = reference
    work = tmp_path_factory.mktemp("fsdp_auto")
    np.savez(work / "params.npz", **dict(_flat(params)))
    np.savez(work / "batches.npz", ids=ids, labels=labels)
    (work / "remats.json").write_text(json.dumps(list(REMATS)))
    spawn_ranks(["-c", WORKER, str(work), str(LR)], N, procs2.free_port())
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(N)]


def _assembled(ranks, prefix):
    return dict(_flat(bridge.assemble_shards([
        _unflat({k[len(prefix):]: v for k, v in rk.items()
                 if k.startswith(prefix)}) for rk in ranks])))


def _jax_auto(params, ids, labels, remat):
    cfg = dataclasses.replace(JT.TINY_LM, remat=remat)
    mesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    shards = JF.shard_params_fsdp(params, mesh)
    opt = JF.init_fsdp_opt_state(shards)
    step = JF.make_fsdp_auto_train_step(shards, cfg, mesh, lr=LR,
                                        donate=False)
    losses = []
    for i in range(STEPS):
        shards, opt, loss = step(shards, opt, (jnp.asarray(ids[i]),
                                               jnp.asarray(labels[i])))
        losses.append(float(loss))
    return losses, dict(_flat(jax.tree.map(np.asarray, shards)))


@pytest.mark.parametrize("remat", REMATS)
def test_auto_variant_matches_the_references(world, reference, remat):
    """Three steps against the reference's auto step: every rank's loss
    the mean, rtol 2e-4; the reassembled params atol 1e-4; one shim call
    (the loss mean) a step."""
    params, ids, labels = reference
    jl, jp = _jax_auto(params, ids, labels, remat)
    for rk in world:
        np.testing.assert_array_equal(rk[f"{remat}/auto_losses"],
                                      world[0][f"{remat}/auto_losses"])
        assert list(rk[f"{remat}/loss_calls"]) == [1] * STEPS
    np.testing.assert_allclose(world[0][f"{remat}/auto_losses"], jl,
                               rtol=2e-4)
    got = _assembled(world, f"{remat}/auto/")
    assert sorted(got) == sorted(jp)
    for name, v in got.items():
        np.testing.assert_allclose(v, jp[name], rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("remat", REMATS)
def test_auto_variant_matches_the_explicit_step(world, remat):
    """The same rows on every rank before the first step, bit for bit;
    three steps at the tiers above."""
    for rk in world:
        assert bool(rk[f"{remat}/same_rows"])
        np.testing.assert_allclose(rk[f"{remat}/auto_losses"],
                                   rk[f"{remat}/expl_losses"], rtol=2e-4)
    a, e = _assembled(world, f"{remat}/auto/"), _assembled(world,
                                                           f"{remat}/expl/")
    for name in a:
        np.testing.assert_allclose(a[name], e[name], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_train_fsdp_auto_twin_under_torchrun(procs2, tmp_path):
    """``train_fsdp --variant auto`` and ``--variant explicit`` on two
    gloo ranks: the same first loss within the steps' tier, finite
    losses, the auto run's shim counts the loss mean only."""
    out = {}
    for v in ("explicit", "auto"):
        path = tmp_path / f"{v}.json"
        spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch.train."
                     "train_fsdp", "--device", "cpu", "--model", "tiny",
                     "--variant", v, "--num-steps", "2", "--no-telemetry",
                     "--no-profile", "--out", str(path)], 2,
                    procs2.free_port())
        out[v] = json.loads(path.read_text())
    assert out["auto"]["variant"] == "auto"
    np.testing.assert_allclose(out["auto"]["losses"][0],
                               out["explicit"]["losses"][0], rtol=2e-4)
    assert all(np.isfinite(out["auto"]["losses"]))
    assert out["auto"]["collectives"][0]["all_reduce"] == 1
    assert out["auto"]["collectives"][0]["all_gather"] == 0


def test_auto_variant_refusals():
    from distributed_training_sandbox_tpu_torch.models import transformer as PT
    from distributed_training_sandbox_tpu_torch.parallel import fsdp
    from distributed_training_sandbox_tpu_torch.train import train_fsdp
    import torch
    p = PT.init_params(PT.TINY_LM, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="needs a process group"):
        fsdp.fully_shard_params(p, PT.TINY_LM)
    for kw in (dict(overlap="ring"), dict(quantized_gather=True),
               dict(state_precision="int8"),
               dict(reshard_after_forward=False)):
        with pytest.raises(ValueError, match="drop --variant auto"):
            train_fsdp.run("tiny", variant="auto", device="cpu", **kw)
    with pytest.raises(ValueError, match="variant="):
        train_fsdp.run("tiny", variant="bogus", device="cpu")
