"""The port's tensor parallelism (``parallel/tensor.py``, the Megatron
``_layer_body``, ``decomposed_all_reduce`` and ``matmul_reduce_scatter``)
against the JAX reference's on the CPU, at 2 and 4 gloo ranks, on
TINY_LM-sized models with the reference's weights bridged into each
rank's shards.

Each world size is one spawn of n gloo ranks (child processes that
import torch, numpy and the port only; ``WORKER``) running every case of
``CASES[n]``; the JAX side runs the same functions in ``shard_map`` on a
CPU mesh of the same shape.  Tiers, each with its reason:

* the collectives: ``decomposed_all_reduce`` bit-equal to ``all_reduce``
  and to the reference's value at 2 ranks (a sum of two terms
  commutes); at 4 ranks within ws f32 roundings of the sum (gloo's
  reduce_scatter and all_reduce may add in other orders); its backward
  the all_reduce of the cotangent, bit for bit; ``matmul_reduce_scatter``
  allclose (the ring reassociates the sum);
* ``tp_lm_loss`` and every grad leaf of every rank: rtol = atol = 1e-5
  (f32 math reduced in other orders by XLA, torch and gloo, as
  ``test_torch_train.py``); at ``overlap="q8"`` the same, since both sides
  quantise the same partial sums to the same codes unless a partial
  straddles a rounding boundary (the rejoin's own ``n · max_scale / 2``
  bound against the exact sum is checked too);
* two steps of ``make_tp_train_step``: losses rtol 1e-4, params atol
  2e-3, the reference's own tiers (``tests/test_tensor.py``);
* the shim's counts a step: bit for bit ``contracts.tp_step_collectives``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_fsdp import KINDS, _flat, _unflat, spawn_ranks

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.ops import collectives as JC
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu.parallel import tensor as JTP
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import contracts
from distributed_training_sandbox_tpu_torch.parallel import tensor as PTP
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-4, 2e-3
STEPS, BATCH, SEQ = 2, 4, 32

# the configs, as overrides of TINY_LM (f32, no remat)
CFGS = {
    "tiny": dict(num_hidden_layers=2),
    # 8 query and 4 KV heads, so tp = 4 divides both
    "tiny8": dict(num_hidden_layers=2, num_attention_heads=8,
                  num_key_value_heads=4),
    # the reference's MOE_TP_CFG (tests/test_tensor.py): a tight
    # capacity, so drops bite
    "moe": dict(num_hidden_layers=2, n_experts=4, moe_ffn=32,
                moe_capacity_factor=1.0, moe_group_size=32),
}
# name: case; "loss" = tp_lm_loss and its grads, "step" = STEPS steps
CASES = {
    2: {"none": dict(kind="loss", cfg="tiny", dp=1, tp=2, overlap="none"),
        "ring": dict(kind="loss", cfg="tiny", dp=1, tp=2, overlap="ring"),
        "q8": dict(kind="loss", cfg="tiny", dp=1, tp=2, overlap="q8"),
        "moe": dict(kind="loss", cfg="moe", dp=1, tp=2, overlap="none"),
        "step_dp1_tp2": dict(kind="step", cfg="tiny", dp=1, tp=2,
                             overlap="none", accum=1),
        "step_moe": dict(kind="step", cfg="moe", dp=1, tp=2,
                         overlap="none", accum=1)},
    4: {"none": dict(kind="loss", cfg="tiny8", dp=1, tp=4, overlap="none"),
        "ring": dict(kind="loss", cfg="tiny8", dp=1, tp=4, overlap="ring"),
        "q8": dict(kind="loss", cfg="tiny8", dp=1, tp=4, overlap="q8"),
        "step_dp2_tp2_accum2": dict(kind="step", cfg="tiny", dp=2, tp=2,
                                    overlap="ring", accum=2)},
}

# the preamble every two-axis worker shares (test_torch_sequence.py and
# test_torch_2d.py run it too): the group, the params by config name,
# one global batch, a cache of grids (every rank builds them in one
# order) and the result writer
PRELUDE = r"""
import dataclasses, json, sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.ops import ring_attention as RA
from distributed_training_sandbox_tpu_torch.parallel import (
    contracts, expert, fsdp, optim, sequence, tensor)
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
mesh.init_process_group("cpu")
n, r = mesh.axis_size(), mesh.axis_rank()
cases = json.loads((work / "cases.json").read_text())
cfgs = json.loads((work / "cfgs.json").read_text())
bnp = np.load(work / "batch.npz")
batch = (torch.from_numpy(bnp["ids"]), torch.from_numpy(bnp["labels"]))
res = {}
_grids = {}

def tree_of(name):
    tree = {}
    for key, v in dict(np.load(work / f"params_{name}.npz")).items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree

def cfg_of(name, **kw):
    return dataclasses.replace(T.TINY_LM, **{**cfgs[name], **kw})

def grid(names, sizes):
    key = (tuple(names), tuple(sizes))
    if key not in _grids:
        _grids[key] = mesh.grid_axes(names, sizes)
    return _grids[key]

def put(prefix, tree):
    for path, t in optim.tree_leaves(tree):
        res[prefix + "/".join(map(str, path))] = np.asarray(t)

def counts_now():
    return np.array([C.COLLECTIVES.read()[k] for k in C.CollectiveCounts.KINDS])
"""

WORKER = PRELUDE + r"""
for name, c in cases.items():
    cfg = cfg_of(c["cfg"])
    tree = tree_of(c["cfg"])
    ax = grid(("dp", "tp"), (c["dp"], c["tp"]))
    tp_rank = mesh.axis_rank(ax["tp"])
    res[f"{name}/coords"] = np.array([mesh.axis_rank(ax["dp"]), tp_rank])
    shards = bridge.tp_shards_from_jax(tree, cfg, tp_rank, c["tp"])
    if c["kind"] == "loss":
        leaves = [t for _, t in optim.tree_leaves(shards)]
        for t in leaves:
            t.requires_grad_(True)
        C.COLLECTIVES.reset()
        loss = tensor.tp_lm_loss(shards, mesh.shard_rows(batch, ax["dp"]),
                                 cfg, axis=ax["tp"], overlap=c["overlap"])
        grads = torch.autograd.grad(loss, leaves)
        res[f"{name}/counts"] = counts_now()
        res[f"{name}/loss"] = np.array(float(loss))
        put(f"{name}/grad/", optim.tree_unflatten(shards, grads))
        continue
    opt = fsdp.init_fsdp_opt_state(shards)
    step = tensor.make_tp_train_step(shards, cfg, dp_axis=ax["dp"],
                                     tp_axis=ax["tp"], overlap=c["overlap"],
                                     accum_steps=c["accum"])
    losses, counts = [], []
    for _ in range(int(sys.argv[2])):
        C.COLLECTIVES.reset()
        shards, opt, loss = step(shards, opt, batch)
        counts.append(counts_now())
        losses.append(float(loss))
    res[f"{name}/losses"] = np.array(losses)
    res[f"{name}/counts"] = np.array(counts)
    put(f"{name}/shard/", bridge.params_to_numpy(shards))

# the collectives: every rank's x and cotangent drawn from its rank's seed
tp = grid(("tp",), (n,))["tp"]
g = np.random.default_rng(100 + r)
x = torch.from_numpy(g.standard_normal((3, 8 * n)).astype(np.float32))
w = torch.from_numpy(g.standard_normal((3, 8 * n)).astype(np.float32))
x.requires_grad_(True)
C.COLLECTIVES.reset()
y = C.decomposed_all_reduce(x, tp, axis=-1)
(dx,) = torch.autograd.grad((y * w).sum(), [x])
res["dar/counts"] = counts_now()
res["dar/y"], res["dar/dx"] = y.detach().numpy(), dx.numpy()
res["dar/ar"] = C.all_reduce(x.detach(), tp).numpy()
res["dar/ar_w"] = C.all_reduce(w, tp).numpy()
from distributed_training_sandbox_tpu_torch.ops.quant import quantized_all_reduce
res["dar/q8"] = quantized_all_reduce(x.detach(), tp).numpy()
a = torch.from_numpy(g.standard_normal((4 * n, 6)).astype(np.float32))
b = torch.from_numpy(g.standard_normal((6, 5)).astype(np.float32))
res["mrs/out"] = C.matmul_reduce_scatter(a, b, tp).numpy()
res["mrs/a"], res["mrs/b"] = a.numpy(), b.numpy()
res["dar/x"], res["dar/w"] = x.detach().numpy(), w.numpy()
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


def jax_cfg(name):
    return dataclasses.replace(JT.TINY_LM, **CFGS[name])


def port_cfg(name):
    return dataclasses.replace(PT.TINY_LM, **CFGS[name])


@pytest.fixture(scope="module")
def reference():
    """The reference's weights for each config and one global batch."""
    params = {name: jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(i), jax_cfg(name)))
        for i, name in enumerate(CFGS)}
    ids = jax.random.randint(jax.random.PRNGKey(5), (BATCH, SEQ), 0,
                             JT.TINY_LM.vocab_size)
    return params, (np.asarray(ids), np.asarray(jnp.roll(ids, -1, axis=1)))


def spawn_world(n, cases, reference, procs2, work, worker, steps=STEPS):
    """Write the params, the batch and the cases under ``work``, run
    ``worker`` on n gloo ranks, return each rank's results."""
    params, (ids, labels) = reference
    for name, tree in params.items():
        np.savez(work / f"params_{name}.npz", **dict(_flat(tree)))
    np.savez(work / "batch.npz", ids=ids, labels=labels)
    (work / "cases.json").write_text(json.dumps(cases))
    (work / "cfgs.json").write_text(json.dumps(
        {k: v for k, v in CFGS.items()}))
    spawn_ranks(["-c", worker, str(work), str(steps)], n, procs2.free_port())
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module", params=(2, 4), ids=lambda n: f"{n}ranks")
def world(request, reference, procs2, tmp_path_factory):
    n = request.param
    work = tmp_path_factory.mktemp(f"tensor{n}")
    return n, spawn_world(n, CASES[n], reference, procs2, work, WORKER)


def sub(rk, prefix):
    return {k[len(prefix):]: v for k, v in rk.items() if k.startswith(prefix)}


def _mesh(dp, tp, names=("dp", "tp")):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp), names)


def jax_loss_grads(cfg, params, batch, dp, tp, overlap):
    """The reference's ``tp_lm_loss`` and its grads on every device of a
    (dp, tp) mesh, stacked in device (= rank) order."""
    mesh = _mesh(dp, tp)
    specs = JTP.tp_specs(params)
    flat = P(("dp", "tp"))

    def body(p, b):
        loss, g = jax.value_and_grad(
            lambda p: JTP.tp_lm_loss(p, b, cfg, overlap=overlap))(p)
        return loss[None], jax.tree.map(lambda x: x[None], g)

    f = jax.jit(JC.smap(body, mesh, in_specs=(specs, P("dp")),
                        out_specs=(flat, jax.tree.map(lambda _: flat,
                                                      params))))
    shards = JTP.shard_params_tp(jax.tree.map(jnp.asarray, params), mesh)
    loss, g = f(shards, tuple(map(jnp.asarray, batch)))
    return np.asarray(loss), dict(_flat(jax.tree.map(np.asarray, g)))


def jax_tp_steps(cfg, params, batch, dp, tp, overlap, accum, sp=1):
    """The reference's ``make_tp_train_step`` for ``STEPS`` steps on a
    (dp, tp) mesh, or (dp, sp, tp) with ``sp > 1``: its losses and the
    full params."""
    if sp > 1:
        mesh = Mesh(np.array(jax.devices()[:dp * sp * tp]).reshape(dp, sp, tp),
                    ("dp", "sp", "tp"))
    else:
        mesh = _mesh(dp, tp)
    shards = JTP.shard_params_tp(jax.tree.map(jnp.asarray, params), mesh)
    opt = JF.init_fsdp_opt_state(shards)
    step = JTP.make_tp_train_step(shards, cfg, mesh, overlap=overlap,
                                  accum_steps=accum, donate=False,
                                  sp_axis="sp" if sp > 1 else None)
    losses = []
    for _ in range(STEPS):
        shards, opt, loss = step(shards, opt, tuple(map(jnp.asarray, batch)))
        losses.append(float(loss))
    return np.array(losses), dict(_flat(jax.tree.map(np.asarray, shards)))


def assemble_rows(ranks, name, dp):
    """Each dp row's tp ranks' shards assembled (``assemble_tp_shards``)."""
    rows = {}
    for rk in ranks:
        d, t = rk[f"{name}/coords"][:2]
        rows.setdefault(int(d), {})[int(t)] = _unflat(sub(rk,
                                                          f"{name}/shard/"))
    return {d: dict(_flat(bridge.assemble_tp_shards(
        [row[t] for t in sorted(row)]))) for d, row in rows.items()}


# ------------------------------------------------------------ one process

def _walk(tree, prefix=""):
    """(path, leaf) of a dict tree, leaves as they are."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_tp_specs_and_shards_match_the_reference(reference):
    """``tp_specs`` is the reference's spec tree (dense and expert
    leaves), and each rank's shards bit for bit the reference's
    ``shard_params_tp`` buffers on that device; the tp ranks' shards
    assemble back into the full params bit for bit."""
    params, _ = reference
    tp = 2
    mesh = _mesh(1, tp)
    for name in ("tiny", "moe"):
        p = params[name]
        pspecs = dict(_walk(PTP.tp_specs(
            bridge.params_from_jax(p, port_cfg(name)))))
        jspecs = dict(_walk(JTP.tp_specs(p)))
        assert sorted(pspecs) == sorted(jspecs)
        for path, js in jspecs.items():
            assert tuple(js) == pspecs[path], (name, path, js)
        ranks = [dict(_flat(bridge.params_to_numpy(bridge.tp_shards_from_jax(
            p, port_cfg(name), r, tp)))) for r in range(tp)]
        jsh = JTP.shard_params_tp(jax.tree.map(jnp.asarray, p), mesh)
        for path, leaf in _walk(jsh):
            for shard in leaf.addressable_shards:
                r = shard.device.id
                np.testing.assert_array_equal(ranks[r][path],
                                              np.asarray(shard.data),
                                              err_msg=f"{name} {path} {r}")
        back = dict(_flat(bridge.assemble_tp_shards(
            [_unflat(rk) for rk in ranks])))
        for path, v in _flat(p):
            np.testing.assert_array_equal(back[path], v, err_msg=path)


def test_tp_refusals():
    """The reference's refusals: tp must divide the heads and the MLP;
    the step's overlap modes, a custom loss with an overlap, accum < 1,
    a ring config without ``sp_axis``; expert and tensor parallelism at
    once."""
    with pytest.raises(ValueError, match="tp=3"):
        PTP.check_tp_divisibility(PT.TINY_LM, 3)
    cfg = port_cfg("tiny")
    import torch
    params = PT.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="'none', 'ring' or 'q8'"):
        PTP.make_tp_train_step(params, cfg, overlap="ring_fused")
    with pytest.raises(ValueError, match="custom loss_fn"):
        PTP.make_tp_train_step(params, cfg, overlap="ring",
                               loss_fn=PT.lm_loss)
    with pytest.raises(ValueError, match="accum_steps"):
        PTP.make_tp_train_step(params, cfg, accum_steps=0)
    from distributed_training_sandbox_tpu_torch.parallel import sequence
    with pytest.raises(ValueError, match="sp_axis"):
        PTP.make_tp_train_step(params, sequence.sp_config(cfg), overlap="none")
    moe = dataclasses.replace(port_cfg("moe"), ep_axis="dp")
    mp = PT.init_params(moe, torch.Generator().manual_seed(0))
    ids = torch.zeros((2, 32), dtype=torch.int64)
    with pytest.raises(ValueError, match="ep OR"):
        PTP.tp_lm_loss(mp, (ids, ids), moe)


def test_custom_loss_gets_the_tp_axis_forwarded():
    """A ``loss_fn`` that declares ``axis`` receives the step's tp axis;
    one that does not is called as ``(params, batch, cfg)``."""
    import torch
    cfg = port_cfg("tiny")
    params = PT.init_params(cfg, torch.Generator().manual_seed(1))
    seen = []

    def with_axis(p, b, c, axis):
        seen.append(axis)
        return PTP.tp_lm_loss(p, b, c, axis=axis)

    ids = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(2))
    step = PTP.make_tp_train_step(
        PTP.shard_params_tp(params), cfg, tp_axis="tp", loss_fn=with_axis)
    from distributed_training_sandbox_tpu_torch.parallel import optim
    sh = PTP.shard_params_tp(params)
    _, _, loss = step(sh, optim.adam_init(sh), (ids, ids.roll(-1, 1)))
    assert seen == ["tp"] and np.isfinite(float(loss))


# ------------------------------------------------------------- n ranks

def test_decomposed_all_reduce_and_matmul_reduce_scatter(world):
    """``decomposed_all_reduce`` against ``all_reduce`` and the
    reference's in ``shard_map`` (bit for bit at 2 ranks; at 4 within
    ws f32 roundings), its backward the all_reduce of the cotangent bit
    for bit, one reduce_scatter, n - 1 hops forward and one all_reduce
    backward; ``matmul_reduce_scatter`` against the reference's and the
    plain reduce_scatter of ``a @ b`` (allclose)."""
    n, ranks = world
    xs = np.stack([rk["dar/x"] for rk in ranks])
    ws_ = np.stack([rk["dar/w"] for rk in ranks])
    mesh = Mesh(np.array(jax.devices()[:n]), ("tp",))
    f = jax.jit(JC.smap(
        lambda x: JC.decomposed_all_reduce(x[0], "tp", -1)[None], mesh,
        in_specs=P("tp"), out_specs=P("tp")))
    jy = np.asarray(f(jnp.asarray(xs)))
    exact = xs.astype(np.float64).sum(0)
    # ws f32 roundings of the partial sums, each at most 2^-24 of the
    # sum of the terms' magnitudes
    ulp = n * 2.0 ** -24 * np.abs(xs.astype(np.float64)).sum(0)
    for r, rk in enumerate(ranks):
        if n == 2:
            np.testing.assert_array_equal(rk["dar/y"], rk["dar/ar"])
            np.testing.assert_array_equal(rk["dar/y"], jy[r])
        else:
            for v in (rk["dar/y"], rk["dar/ar"], jy[r]):
                assert (np.abs(v - exact) <= ulp).all()
        np.testing.assert_array_equal(rk["dar/dx"], rk["dar/ar_w"])
        np.testing.assert_array_equal(rk["dar/y"], ranks[0]["dar/y"])
        want = dict.fromkeys(KINDS, 0)
        want.update(reduce_scatter=1, collective_permute=n - 1,
                    all_reduce=1)
        assert list(rk["dar/counts"]) == [want[k] for k in KINDS]
        # the q8 rejoin within n · max_scale / 2 of the exact sum
        scales = np.abs(xs).max(axis=-1, keepdims=True) / 127.0
        bound = n * scales.max(axis=0) / 2 + 1e-6
        assert (np.abs(rk["dar/q8"] - exact) <= bound).all()
    # the backward against jax.grad in shard_map
    g = jax.jit(JC.smap(
        lambda x, w: jax.grad(lambda x: jnp.sum(
            JC.decomposed_all_reduce(x, "tp", -1) * w))(x), mesh,
        in_specs=(P("tp"), P("tp")), out_specs=P("tp")))
    jdx = np.asarray(g(jnp.asarray(xs.reshape(n * 3, -1)),
                       jnp.asarray(ws_.reshape(n * 3, -1)))).reshape(xs.shape)
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["dar/dx"], jdx[r], rtol=1e-6,
                                   atol=1e-6)
    a, b = ranks[0]["mrs/a"], ranks[0]["mrs/b"]
    h = jax.jit(JC.smap(
        lambda a, b: JC.matmul_reduce_scatter(a, b, "tp"), mesh,
        in_specs=(P("tp"), P("tp")), out_specs=P("tp")))
    a_all = np.concatenate([rk["mrs/a"] for rk in ranks])
    b_all = np.concatenate([rk["mrs/b"] for rk in ranks])
    jm = np.asarray(h(jnp.asarray(a_all), jnp.asarray(b_all)))
    total = sum(rk["mrs/a"].astype(np.float64) @ rk["mrs/b"] for rk in ranks)
    rows = a.shape[0] // n
    for r, rk in enumerate(ranks):
        np.testing.assert_allclose(rk["mrs/out"], jm[r * rows:(r + 1) * rows],
                                   **TOL)
        np.testing.assert_allclose(rk["mrs/out"],
                                   total[r * rows:(r + 1) * rows], **TOL)


def test_tp_loss_and_every_grad_match_the_reference(world, reference):
    """``tp_lm_loss`` and every grad leaf on every rank against the
    reference's on the same device of a (dp, tp) mesh, for each rejoin
    (``none``, ``ring``, ``q8``) and the MoE case (every expert
    Megatron-split), rtol = atol = 1e-5; the shim's counts a forward and
    backward: two rejoins a layer and their backward all_reduces."""
    n, ranks = world
    params, batch = reference
    for name, c in CASES[n].items():
        if c["kind"] != "loss":
            continue
        jl, jg = jax_loss_grads(jax_cfg(c["cfg"]), params[c["cfg"]], batch,
                                c["dp"], c["tp"], c["overlap"])
        L = CFGS[c["cfg"]]["num_hidden_layers"]
        for r, rk in enumerate(ranks):
            np.testing.assert_allclose(rk[f"{name}/loss"], jl[r], **TOL,
                                       err_msg=name)
            got = sub(rk, f"{name}/grad/")
            assert sorted(got) == sorted(jg), name
            for k, v in got.items():
                np.testing.assert_allclose(v, jg[k][r], rtol=TOL["rtol"],
                                           atol=2 * TOL["atol"],
                                           err_msg=f"{name} rank {r}: {k}")
            # a step's calls but its loss mean and grad syncs: a tree of
            # one leaf takes 2 all_reduces there
            want = contracts.tp_step_collectives(
                {"layers": {"w": np.zeros((L, 1))}}, c["tp"],
                overlap=c["overlap"], remat=False)
            want["all_reduce"] -= 2
            assert list(rk[f"{name}/counts"]) == [want[k] for k in KINDS], \
                name


def test_tp_steps_match_the_reference(world, reference):
    """Two ``make_tp_train_step`` steps (dp 1 × tp 2, the MoE config at
    dp 1 × tp 2; dp 2 × tp 2 with the ring rejoin and accum 2) against
    the reference's on a mesh of the same shape: every rank's loss the
    same, rtol 1e-4 of the reference's; each dp row's shards assembled
    atol 2e-3 (the reference's tiers); the replicated leaves equal on
    every rank; each step's shim counts ``contracts.tp_step_collectives``
    of the rank's tree."""
    n, ranks = world
    params, batch = reference
    for name, c in CASES[n].items():
        if c["kind"] != "step":
            continue
        jl, jp = jax_tp_steps(jax_cfg(c["cfg"]), params[c["cfg"]], batch,
                              c["dp"], c["tp"], c["overlap"], c["accum"])
        for rk in ranks:
            np.testing.assert_array_equal(rk[f"{name}/losses"],
                                          ranks[0][f"{name}/losses"])
        np.testing.assert_allclose(ranks[0][f"{name}/losses"], jl,
                                   rtol=STEP_LOSS_RTOL, err_msg=name)
        for d, full in assemble_rows(ranks, name, c["dp"]).items():
            assert sorted(full) == sorted(jp)
            for k, v in full.items():
                np.testing.assert_allclose(v, jp[k], rtol=0,
                                           atol=STEP_PARAM_ATOL,
                                           err_msg=f"{name} dp {d}: {k}")
        tree = _unflat(sub(ranks[0], f"{name}/shard/"))
        want = contracts.tp_step_collectives(
            tree, c["tp"], overlap=c["overlap"], remat=False,
            accum_steps=c["accum"])
        for rk in ranks:
            for row in rk[f"{name}/counts"]:
                assert list(row) == [want[k] for k in KINDS], name
