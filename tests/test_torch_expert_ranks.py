"""The port's expert parallelism on 2 and 4 gloo ranks against the JAX
reference's ``shard_map`` on a mesh of as many CPU devices: the
all_to_all's gradient (and a mutant without it), the expert-parallel
layer and the EP toy step of the reference's ``tests/test_expert.py``,
and the ``train.moe_toy`` twin under torchrun.  Each world size is one
spawn of n ranks (child processes that import torch, numpy and the port
only).  Tiers as ``test_torch_expert.py`` states them: data movement
and collective counts bitwise, outputs and params allclose.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_expert import FFN, HID, NEXP, _x
from test_torch_fsdp import spawn_ranks

from distributed_training_sandbox_tpu.ops import smap
from distributed_training_sandbox_tpu.parallel import expert as JE
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    ep_step_collectives)

WORLDS = (2, 4)

WORKER = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.parallel import expert, optim
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
mesh.init_process_group("cpu")
n, r = mesh.axis_size(), mesh.axis_rank()
d = np.load(work / "inputs.npz")
full = bridge.moe_params_from_jax([d["w_router"], d["w_gate"], d["w_up"],
                                   d["w_down"]])
res = {}
# all_to_all's gradient: tiled and untiled, sound and with the backward
# taken away (no cotangent reaches the input, as when it was detached)
xa = torch.from_numpy(d["a2a_x"][r]).requires_grad_()
probe = torch.from_numpy(d["a2a_probe"][r])
for tiled in (True, False):
    y = C.all_to_all(xa if tiled else xa.reshape(n, -1, xa.shape[-1]),
                     "ep", split_axis=0, concat_axis=1 if tiled else 0,
                     tiled=tiled)
    g, = torch.autograd.grad((y * probe.reshape(y.shape)).sum(), [xa])
    res[f"a2a/{tiled}/y"] = y.detach().numpy()
    res[f"a2a/{tiled}/g"] = g.numpy()
sound = C._AllToAll.backward
C._AllToAll.backward = staticmethod(lambda ctx, g: (None,) * 5)
y = C.all_to_all(xa, "ep", split_axis=0, concat_axis=1)
g, = torch.autograd.grad((y * probe.reshape(y.shape)).sum(), [xa],
                         allow_unused=True, materialize_grads=True)
res["a2a/mutant/g"] = g.numpy()
C._AllToAll.backward = sound
# the sharded toy layer: each rank its chunk
x = torch.from_numpy(d["x"])
for cf in (8.0, 1.0):
    for group in (128, 16):
        shards = expert.shard_moe_params(full, "ep")
        y, aux = expert.moe_layer(shards, mesh.shard_rows((x,), "ep")[0], "ep",
                                  capacity_factor=cf, group_size=group)
        res[f"layer/{cf}/{group}/y"] = y.numpy()
        res[f"layer/{cf}/{group}/aux"] = np.array(float(aux))
# the EP toy step, two steps
shards = expert.shard_moe_params(full, "ep")
opt = optim.adam_init(shards._asdict())
step = expert.make_ep_train_step(shards, axis="ep")
batch = (torch.from_numpy(d["x"]), torch.from_numpy(d["y"]))
losses, counts = [], []
for _ in range(2):
    C.COLLECTIVES.reset()
    shards, opt, loss = step(shards, opt, batch)
    counts.append(C.COLLECTIVES.read())
    losses.append(float(loss))
res["ep/losses"] = np.array(losses)
res["ep/counts"] = np.array(json.dumps(counts))
for k, v in shards._asdict().items():
    res[f"ep/{k}"] = v.numpy()
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


@pytest.fixture(scope="module")
def reference_toy():
    jp = JE.init_moe_params(jax.random.PRNGKey(0), hidden=HID, ffn=FFN,
                            n_experts=NEXP)
    x = _x(4, 8, 16)
    return jax.tree.map(np.asarray, jp), x, np.tanh(x) * 0.5


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, reference_toy, procs2, tmp_path_factory):
    n = request.param
    jp, x, y = reference_toy
    rng = np.random.default_rng(n)
    work = tmp_path_factory.mktemp(f"expert{n}")
    np.savez(work / "inputs.npz", w_router=jp.w_router, w_gate=jp.w_gate,
             w_up=jp.w_up, w_down=jp.w_down, x=x, y=y,
             a2a_x=rng.standard_normal((n, 2 * n, 3)).astype(np.float32),
             a2a_probe=rng.standard_normal((n, 2 * n * 3)).astype(
                 np.float32))
    spawn_ranks(["-c", WORKER, str(work)], n, procs2.free_port())
    return n, [dict(np.load(work / f"rank{r}.npz")) for r in range(n)], work


def test_all_to_all_gradient_is_the_inverse_all_to_all(world):
    """The cotangent of every rank's output routed back (the transpose
    lax.all_to_all gets under shard_map): against jax.grad of the same
    all_to_all in shard_map, tiled and untiled, bitwise (pure data
    movement).  The mutant whose backward is removed (no cotangent
    reaches the input, as when the port's all_to_all detached it) must
    fail the same comparison."""
    n, ranks, work = world
    d = np.load(work / "inputs.npz")
    mesh = Mesh(np.array(jax.devices()[:n]), ("ep",))
    for tiled in (True, False):
        def f(x, p, tiled=tiled):
            x = x[0]
            if not tiled:
                x = x.reshape(n, -1, x.shape[-1])
            y = jax.lax.all_to_all(x, "ep", 0, 1 if tiled else 0,
                                   tiled=tiled)
            return jnp.sum(y * p[0].reshape(y.shape))[None]

        def loss(x, p):
            return jnp.sum(smap(f, mesh, in_specs=(P("ep"), P("ep")),
                                out_specs=P("ep"))(x, p))
        gj = np.asarray(jax.grad(loss)(jnp.asarray(d["a2a_x"]),
                                       jnp.asarray(d["a2a_probe"])))
        for r, rk in enumerate(ranks):
            np.testing.assert_array_equal(rk[f"a2a/{tiled}/g"], gj[r])
    mutant = np.stack([rk["a2a/mutant/g"] for rk in ranks])
    sound = np.stack([rk["a2a/True/g"] for rk in ranks])
    assert not np.allclose(mutant, sound), "the removed backward went unseen"


@pytest.mark.parametrize("cap_factor", [8.0, 1.0])
@pytest.mark.parametrize("group", [128, 16])
def test_ep_sharded_layer_matches_the_reference(world, reference_toy,
                                                cap_factor, group):
    """The all_to_all choreography on n ranks == the reference's
    shard_map layer on n devices (allclose tier), one or several groups
    a rank, at no-drop and tight capacity."""
    n, ranks, _ = world
    jp, x, _ = reference_toy
    mesh = Mesh(np.array(jax.devices()[:n]), ("ep",))
    jpt = JE.MoEParams(*(jnp.asarray(a) for a in jp))
    f = jax.jit(smap(lambda p, x: JE.moe_layer(
        p, x, "ep", capacity_factor=cap_factor, group_size=group),
        mesh, in_specs=(JE.moe_specs("ep"), P("ep")), out_specs=(P("ep"),
                                                                 P())))
    yj, auxj = f(JE.shard_moe_params(jpt, mesh, "ep"), jnp.asarray(x))
    got = np.concatenate([rk[f"layer/{cap_factor}/{group}/y"]
                          for rk in ranks])
    np.testing.assert_allclose(got, np.asarray(yj), rtol=2e-5, atol=2e-5)
    for rk in ranks:
        assert float(rk[f"layer/{cap_factor}/{group}/aux"]) == \
            pytest.approx(float(auxj), rel=1e-5)


def test_ep_train_step_matches_the_reference(world, reference_toy):
    """Two EP toy steps on n ranks against the reference's jitted
    ``make_ep_train_step`` on n devices: losses rtol 1e-5, every expert
    shard and the router atol 1e-5 (allclose); the collectives of each
    step the ``ep_step_collectives`` contract (bitwise)."""
    n, ranks, _ = world
    jp, x, y = reference_toy
    mesh = Mesh(np.array(jax.devices()[:n]), ("ep",))
    shards = JE.shard_moe_params(JE.MoEParams(*(jnp.asarray(a) for a in jp)),
                                 mesh, "ep")
    opt = JF.init_fsdp_opt_state(shards)
    step = JE.make_ep_train_step(shards, mesh, axis="ep", donate=False)
    losses = []
    for _ in range(2):
        shards, opt, loss = step(shards, opt, (jnp.asarray(x),
                                               jnp.asarray(y)))
        losses.append(float(loss))
    for rk in ranks:
        np.testing.assert_allclose(rk["ep/losses"], losses, rtol=1e-5)
        for c in json.loads(str(rk["ep/counts"])):
            assert c == ep_step_collectives()
    for k in ("w_gate", "w_up", "w_down"):
        got = np.concatenate([rk[f"ep/{k}"] for rk in ranks])
        np.testing.assert_allclose(got, np.asarray(getattr(shards, k)),
                                   rtol=0, atol=1e-5, err_msg=k)
    for rk in ranks:
        np.testing.assert_allclose(rk["ep/w_router"],
                                   np.asarray(shards.w_router), rtol=0,
                                   atol=1e-5)


def test_moe_toy_twin_learns_under_torchrun(procs2, tmp_path):
    """``train.moe_toy`` on two gloo ranks under torchrun: the toy
    regression descends and a step's collectives are the contract's."""
    out = spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch.train."
                       "moe_toy", "--device", "cpu", "--num-steps", "12"],
                      2, procs2.free_port())
    text = out[0]
    assert "(learning)" in text, text[-2000:]
    line = next(ln for ln in text.splitlines() if "collectives a step" in ln)
    assert '{"all_reduce": 5, "all_to_all": 3}' in line, line
