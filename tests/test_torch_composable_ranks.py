"""The composable step (``parallel/composable.py``) on gloo ranks: the
dp × fsdp × tp step against the JAX reference's, and the replay law.

* The 3-axis step at dp 1 × fsdp 2 × tp 2 on 4 ranks (rejoins ``none``
  and ``ring``, remat on) and at 1 × 2 × 1 and 1 × 1 × 2 on 2 ranks,
  called directly, against the reference's ``_make_dp_fsdp_tp_step``
  choreography on a CPU mesh of the same shape (the reference's
  ``shard_params_by_rules`` places the weights; its step body is
  restated here to read the synced grads): the loss and every grad
  leaf of every rank at rtol = atol = 1e-5 (f32 math reduced in other
  orders by XLA, torch and gloo); two steps against the reference's
  jitted step at its TP tiers, losses rtol 1e-4 and every rank's shards
  atol 2e-3 (``test_torch_tensor.py``'s); each step's calls equal the
  generated contract (``analysis.contract_gen``) exactly.
* The replay law, port-internal and bit for bit (same function, same
  inputs): ``dp2``, ``dp2xw1``, ``dp2xw2``, ``dp2xw3`` on the toy MLP and
  ``dp2xw3named``, ``dp1xtp2``, ``dp1xsp2`` on TINY_LM, two steps of the
  composable build against the hand factory, loss for loss and param
  for param.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_fsdp import KINDS, _flat, spawn_ranks
from test_torch_tensor import CFGS, PRELUDE, reference, sub  # noqa: F401

from distributed_training_sandbox_tpu.analysis import rules as JR
from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.ops import collectives as JC
from distributed_training_sandbox_tpu.parallel import composable as JCP
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.analysis import contract_gen
from distributed_training_sandbox_tpu_torch.models import transformer as PT

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-4, 2e-3
STEPS = 2
S3 = "composable_dp_fsdp_tp"

# name: (dp, fsdp, tp), rejoin, remat
THREE = {
    4: {"f2t2": ((1, 2, 2), "none", True),
        "f2t2_ring": ((1, 2, 2), "ring", True)},
    2: {"f2": ((1, 2, 1), "none", False),
        "t2": ((1, 1, 2), "none", True)},
}
# the replay law's plans at 2 ranks
REPLAYS = ("dp2", "dp2xw1", "dp2xw2", "dp2xw3", "dp2xw3named", "dp1xtp2",
           "dp1xsp2")
MLP_SIZES = (48, 40, 48)

WORKER = PRELUDE + r"""
from distributed_training_sandbox_tpu_torch.models import mlp
from distributed_training_sandbox_tpu_torch.parallel import composable as CP
from distributed_training_sandbox_tpu_torch.parallel import ddp, zero

def clone(t):
    return optim.tree_map(lambda x: x.clone(), t)

three = json.loads((work / "three.json").read_text())
for name, (sizes, overlap, remat) in three.items():
    cfg = cfg_of("tiny", remat=remat)
    full = bridge.params_from_jax(tree_of("tiny"), cfg)
    ax = grid(("dp", "fsdp", "tp"), sizes)
    res[f"{name}/coords"] = np.array([mesh.axis_rank(ax[a])
                                      for a in ("dp", "fsdp", "tp")])
    kw = dict(dp_axis=ax["dp"], fsdp_axis=ax["fsdp"], tp_axis=ax["tp"],
              overlap=overlap)
    shards = CP.shard_params_by_rules(full, "composable_dp_fsdp_tp", ax)
    vg = CP.make_dp_fsdp_tp_value_and_grad(clone(shards), cfg, **kw)
    loss, grads = vg(shards, batch)
    res[f"{name}/loss"] = np.array(float(loss))
    put(f"{name}/grad/", grads)
    step = CP.make_dp_fsdp_tp_step(shards, cfg, **kw)
    opt = fsdp.init_fsdp_opt_state(shards)
    losses, counts = [], []
    for _ in range(int(sys.argv[2])):
        C.COLLECTIVES.reset()
        shards, opt, loss = step(shards, opt, batch)
        counts.append(counts_now())
        losses.append(float(loss))
    res[f"{name}/losses"] = np.array(losses)
    res[f"{name}/counts"] = np.array(counts)
    put(f"{name}/shard/", shards)

# the replay law: the composable build against the hand factory
replays = json.loads((work / "replays.json").read_text())
g = np.random.default_rng(7)
sizes = tuple(json.loads((work / "mlp.json").read_text()))
xb = torch.from_numpy(g.standard_normal((8, sizes[0])).astype(np.float32))
yb = torch.from_numpy(g.standard_normal((8, sizes[-1])).astype(np.float32))
mlp_batch = (xb, yb)
cfg_lm = cfg_of("tiny", remat=True)
for text in replays:
    plan = CP.MeshPlan.parse(text).normalized()
    strategy = plan.strategy_name()
    names = CP.grid_names(plan)
    ax = grid(names, [getattr(plan, a) for a in names])
    lm = strategy in ("fsdp", "tp", "sp")
    if lm:
        full = bridge.params_from_jax(tree_of("tiny"), cfg_lm)
        b = batch
    else:
        full = mlp.init_mlp(torch.Generator().manual_seed(3), sizes)
        b = mlp_batch
    build = CP.make_composable_train_step(
        clone(full), plan, axes=ax, model_cfg=cfg_lm if lm else None,
        loss_fn=None if lm or strategy == "zero3" else mlp.mse_loss)
    d = ax["dp"]
    if strategy == "ddp":
        hstep = ddp.make_ddp_train_step(
            mlp.mse_loss, lambda g_, s, p_: optim.adam_update(g_, s, p_), d)
        hp, ho = clone(full), optim.adam_init(full)
    elif strategy in ("composable_zero1", "zero2"):
        hstep = zero.make_zero_train_step(
            mlp.mse_loss, d, stage=1 if strategy == "composable_zero1" else 2)
        hp, ho = clone(full), zero.init_zero_opt_state(full, d)
    elif strategy == "zero3":
        shapes = [{k: tuple(v.shape) for k, v in l.items()} for l in full]
        hstep = zero.make_zero3_train_step(zero.make_zero3_mlp_loss(shapes, d),
                                           d)
        hp, ho = (zero.shard_params_zero3(clone(full), d),
                  zero.init_zero_opt_state(full, d))
    elif strategy == "fsdp":
        hp = fsdp.shard_params_fsdp(clone(full), d)
        hstep = fsdp.make_fsdp_train_step(hp, cfg_lm, d)
        ho = fsdp.init_fsdp_opt_state(hp)
    elif strategy == "tp":
        hp = tensor.shard_params_tp(clone(full), ax["tp"])
        hstep = tensor.make_tp_train_step(hp, cfg_lm, dp_axis=d,
                                          tp_axis=ax["tp"])
        ho = fsdp.init_fsdp_opt_state(hp)
    else:
        hp = fsdp.shard_params_fsdp(clone(full), d)
        hstep = sequence.make_sp_train_step(hp, cfg_lm, dp_axis=d,
                                            sp_axis=ax["sp"])
        ho = fsdp.init_fsdp_opt_state(hp)
    cp_, co = build.params, build.opt_state
    same, cl, hl = True, [], []
    for _ in range(int(sys.argv[2])):
        cp_, co, l1 = build.step(cp_, co, b)
        hp, ho, l2 = hstep(hp, ho, b)
        cl.append(float(l1)), hl.append(float(l2))
    same = all(torch.equal(x, optim.tree_get(hp, path))
               for path, x in optim.tree_leaves(cp_))
    res[f"replay/{text}/strategy"] = np.array(strategy)
    res[f"replay/{text}/losses"] = np.array([cl, hl])
    res[f"replay/{text}/params_equal"] = np.array(same)
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


def jax_cfg(name, remat):
    return dataclasses.replace(JT.TINY_LM, **CFGS[name], remat=remat)


def _mesh(sizes):
    n = int(np.prod(sizes))
    return Mesh(np.array(jax.devices()[:n]).reshape(*sizes),
                ("dp", "fsdp", "tp"))


def reference_loss_grads(cfg, params, batch, sizes, overlap):
    """The reference's 3-axis step body up to its Adam update
    (``parallel/composable.py:_make_dp_fsdp_tp_step``): the loss pmean
    and the synced grads, sharded as the rules place them."""
    mesh = _mesh(sizes)
    shards = JCP.shard_params_by_rules(jax.tree.map(jnp.asarray, params),
                                       mesh, S3)
    specs = JR.RULESETS[S3].partition_specs(shards, "params")
    hook_specs = jax.tree.map(lambda s: P(*s[1:]), specs["layers"],
                              is_leaf=lambda x: isinstance(x, P))
    n_total = int(np.prod(sizes))
    import functools
    layer_body = functools.partial(JT._layer_body, tp_axis="tp",
                                   tp_overlap=overlap)

    def layer_hook(layer):
        return jax.tree.map(lambda x, s: JF._gather_leaf(x, s, "fsdp"),
                            layer, hook_specs,
                            is_leaf=lambda x: isinstance(x, P))

    def sharded_loss(sh, b):
        outer = {k: JF._gather_leaf(v, specs[k], "fsdp")
                 for k, v in sh.items() if k != "layers"}
        return JT.lm_loss({**outer, "layers": sh["layers"]}, b, cfg,
                          layer_hook=layer_hook, layer_body=layer_body)

    def sync(g, spec):
        axes = ("dp",) + (("tp",) if "tp" not in JCP._spec_tree_axes(spec)
                          else ())
        return lax.psum(g, axes) / n_total

    def body(sh, b):
        loss, g = jax.value_and_grad(sharded_loss)(sh, b)
        loss = lax.pmean(loss, ("dp", "fsdp", "tp"))
        g = jax.tree.map(sync, g, specs, is_leaf=lambda x: isinstance(x, P))
        return loss, g

    f = jax.jit(JC.smap(body, mesh, in_specs=(specs, P(("dp", "fsdp"))),
                        out_specs=(P(), specs)))
    loss, g = f(shards, tuple(map(jnp.asarray, batch)))
    return float(loss), g


def reference_steps(cfg, params, batch, sizes, overlap):
    """Two steps of the reference's jitted 3-axis step: its losses and
    its shards."""
    mesh = _mesh(sizes)
    shards = JCP.shard_params_by_rules(jax.tree.map(jnp.asarray, params),
                                       mesh, S3)
    step = JCP._make_dp_fsdp_tp_step(shards, cfg, mesh, overlap=overlap,
                                     donate=False)
    opt = JF.init_fsdp_opt_state(shards)
    losses = []
    for _ in range(STEPS):
        shards, opt, loss = step(shards, opt, tuple(map(jnp.asarray, batch)))
        losses.append(float(loss))
    return np.array(losses), shards


def _device_shards(tree):
    """{path: {device id: the device's shard}} of a sharded jax tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[key] = {s.device.id: np.asarray(s.data)
                    for s in leaf.addressable_shards}
    return out


@pytest.fixture(scope="module", params=(4, 2), ids=lambda n: f"{n}ranks")
def world(request, reference, procs2, tmp_path_factory):  # noqa: F811
    n = request.param
    params, (ids, labels) = reference
    work = tmp_path_factory.mktemp(f"composable{n}")
    for name, tree in params.items():
        np.savez(work / f"params_{name}.npz", **dict(_flat(tree)))
    np.savez(work / "batch.npz", ids=ids, labels=labels)
    (work / "cases.json").write_text("{}")
    (work / "cfgs.json").write_text(json.dumps(CFGS))
    (work / "three.json").write_text(json.dumps(THREE[n]))
    (work / "replays.json").write_text(json.dumps(REPLAYS if n == 2
                                                  else []))
    (work / "mlp.json").write_text(json.dumps(MLP_SIZES))
    spawn_ranks(["-c", WORKER, str(work), str(STEPS)], n, procs2.free_port())
    return n, [dict(np.load(work / f"rank{r}.npz")) for r in range(n)]


def test_three_axis_step_matches_the_reference(world, reference):
    """The loss and every synced grad leaf of every rank against the
    reference's on the same device (rtol = atol = 1e-5), two steps at
    its TP tiers, and each step's calls the generated contract's."""
    n, ranks = world
    params, batch = reference
    for name, (sizes, overlap, remat) in THREE[n].items():
        cfg = jax_cfg("tiny", remat)
        jloss, jg = reference_loss_grads(cfg, params["tiny"], batch, sizes,
                                         overlap)
        jgrads = _device_shards(jg)
        jlosses, jshards = reference_steps(cfg, params["tiny"], batch, sizes,
                                           overlap)
        jsh = _device_shards(jshards)
        full = bridge.params_from_jax(
            params["tiny"], dataclasses.replace(PT.TINY_LM, **CFGS["tiny"]))
        want = contract_gen.generate_counts(
            S3, full, contract_gen.Ctx(dict(zip(("dp", "fsdp", "tp"), sizes)),
                                       remat=remat, overlap=overlap))
        for r, rk in enumerate(ranks):
            np.testing.assert_allclose(rk[f"{name}/loss"], jloss, **TOL,
                                       err_msg=name)
            grads = sub(rk, f"{name}/grad/")
            assert sorted(grads) == sorted(jgrads), name
            for path, g in grads.items():
                np.testing.assert_allclose(g, jgrads[path][r], **TOL,
                                           err_msg=f"{name} {path} rank {r}")
            np.testing.assert_allclose(rk[f"{name}/losses"], jlosses,
                                       rtol=STEP_LOSS_RTOL, err_msg=name)
            for path, x in sub(rk, f"{name}/shard/").items():
                np.testing.assert_allclose(x, jsh[path][r],
                                           atol=STEP_PARAM_ATOL,
                                           err_msg=f"{name} {path} rank {r}")
            for counts in rk[f"{name}/counts"]:
                assert list(counts) == [want[k] for k in KINDS], (
                    name, dict(zip(KINDS, counts)), want)


@pytest.mark.parametrize("world", [2], indirect=True,
                         ids=lambda n: f"{n}ranks")
def test_replayed_plans_are_the_hand_steps_bit_for_bit(world):
    """Each legacy plan's composable build runs its hand factory: two
    steps, loss for loss and param for param, on every rank."""
    n, ranks = world
    strategies = {}
    for rk in ranks:
        for text in REPLAYS:
            cl, hl = rk[f"replay/{text}/losses"]
            assert list(cl) == list(hl), (text, cl, hl)
            assert np.isfinite(cl).all()
            assert bool(rk[f"replay/{text}/params_equal"]), text
            strategies[text] = str(rk[f"replay/{text}/strategy"])
    assert strategies == {"dp2": "ddp", "dp2xw1": "composable_zero1",
                          "dp2xw2": "zero2", "dp2xw3": "zero3",
                          "dp2xw3named": "fsdp", "dp1xtp2": "tp",
                          "dp1xsp2": "sp"}
