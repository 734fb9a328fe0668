"""The port's sequence parallelism (``ops/ring_attention.py``,
``parallel/sequence.py``, FSDP with ``sp_axis``, and the dp × sp × tp
step) against the JAX reference's on the CPU, at 2 and 4 gloo ranks.

Each world size is one spawn of n gloo ranks (``WORKER``, the shared
prelude of ``test_torch_tensor.py``); the JAX side runs the same
functions in ``shard_map`` on a CPU mesh of the same shape.  Tiers:

* ring attention, f32: outputs and dq, dk, dv rtol = atol = 2e-5
  against the reference's ring and against monolithic attention (the
  reference's ``tests/test_sequence.py`` tier); bf16 inputs at the
  reference's bf16 tier (rtol = atol = 0.05);
* the zigzag shuffle, unshuffle and positions: bit for bit;
* two FSDP × SP steps and two dp × sp × tp steps: losses rtol 1e-4,
  params atol 2e-3 (the reference's tiers, ``tests/test_sequence.py``
  and ``tests/test_tensor.py``);
* the shim's counts: bit for bit ``contracts.sp_step_collectives`` and
  ``contracts.tp_step_collectives`` (with ``sp``); the ring's hops
  2 (n - 1) forward and as many backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_fsdp import KINDS, _flat, _unflat
from test_torch_tensor import (CFGS, PRELUDE, STEP_LOSS_RTOL, STEP_PARAM_ATOL,
                               STEPS, assemble_rows, jax_cfg, jax_tp_steps,
                               spawn_world, sub)

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.ops import collectives as JC
from distributed_training_sandbox_tpu.ops import ring_attention as JRA
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu.parallel import sequence as JS
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.ops import ring_attention as PRA
from distributed_training_sandbox_tpu_torch.parallel import contracts
from distributed_training_sandbox_tpu_torch.parallel import sequence as PS
torch.set_num_threads(1)  # the suite's workers share the cores

RING_TOL = dict(rtol=2e-5, atol=2e-5)
RING_BF16_TOL = dict(rtol=0.05, atol=0.05)
B, S, HD = 2, 64, 16
# name: (layout, causal, nq, nkv, block_q, dtype)
RINGS = {
    "contig_gqa_bq8": ("contiguous", True, 4, 2, 8, "float32"),
    "noncausal": ("contiguous", False, 2, 2, None, "float32"),
    "zigzag_gqa": ("zigzag", True, 4, 2, None, "float32"),
    "zigzag_bq8": ("zigzag", True, 4, 4, 8, "float32"),
    "bf16": ("contiguous", True, 4, 4, None, "bfloat16"),
}
# name: (dp, sp, tp, layout); tp > 1 is the dp x sp x tp step
STEP_CASES = {
    2: {"dp1_sp2": (1, 2, 1, "contiguous"),
        "dp1_sp2_zigzag": (1, 2, 1, "zigzag")},
    4: {"dp2_sp2": (2, 2, 1, "contiguous"),
        "dp1_sp4_zigzag": (1, 4, 1, "zigzag"),
        "dp1_sp4": (1, 4, 1, "contiguous"),
        "dp1_sp2_tp2": (1, 2, 2, "contiguous")},
}

WORKER = PRELUDE + r"""
ring = np.load(work / "ring.npz")
sp_axis = grid(("sp",), (n,))["sp"]
for name, (layout, causal, nq, nkv, bq, dtype) in cases["rings"].items():
    dt = getattr(torch, dtype)
    xs = []
    for x in ("q", "k", "v", "do"):
        t = torch.from_numpy(ring[f"{name}/{x}"])
        if layout == "zigzag":
            t = sequence.zigzag_shuffle(t, n)
        t = t[:, r * t.shape[1] // n:(r + 1) * t.shape[1] // n].to(dt)
        xs.append(t.requires_grad_(x != "do"))
    q, k, v, do = xs
    C.COLLECTIVES.reset()
    out = RA.ring_attention(q, k, v, sp_axis, scale=1.0 / np.sqrt(q.shape[-1]),
                            causal=causal, block_q=bq, layout=layout)
    dq, dk, dv = torch.autograd.grad(out, [q, k, v], do)
    res[f"ring/{name}/counts"] = counts_now()
    for key, t in (("out", out), ("dq", dq), ("dk", dk), ("dv", dv)):
        res[f"ring/{name}/{key}"] = t.detach().float().numpy()
for name, (dp, sp, tp, layout) in cases["steps"].items():
    cfg = cfg_of("tiny")
    tree = tree_of("tiny")
    b = batch
    if layout == "zigzag":
        b = tuple(sequence.zigzag_shuffle(t, sp) for t in batch)
    C.COLLECTIVES.reset()
    if tp > 1:
        ax = grid(("dp", "sp", "tp"), (dp, sp, tp))
        shards = bridge.tp_shards_from_jax(tree, cfg, mesh.axis_rank(ax["tp"]),
                                           tp)
        step = tensor.make_tp_train_step(shards, cfg, dp_axis=ax["dp"],
                                         tp_axis=ax["tp"], sp_axis=ax["sp"])
        res[f"{name}/coords"] = np.array([mesh.axis_rank(ax["dp"]),
                                          mesh.axis_rank(ax["tp"]),
                                          mesh.axis_rank(ax["sp"])])
    else:
        ax = grid(("dp", "sp"), (dp, sp))
        shards = bridge.shards_from_jax(tree, cfg, mesh.axis_rank(ax["dp"]), dp)
        step = sequence.make_sp_train_step(
            shards, sequence.sp_config(cfg, layout=layout),
            dp_axis=ax["dp"], sp_axis=ax["sp"])
        res[f"{name}/coords"] = np.array([mesh.axis_rank(ax["dp"]),
                                          mesh.axis_rank(ax["sp"])])
    opt = fsdp.init_fsdp_opt_state(shards)
    losses, counts = [], []
    for _ in range(int(sys.argv[2])):
        C.COLLECTIVES.reset()
        shards, opt, loss = step(shards, opt, b)
        counts.append(counts_now())
        losses.append(float(loss))
    res[f"{name}/losses"] = np.array(losses)
    res[f"{name}/counts"] = np.array(counts)
    put(f"{name}/shard/", bridge.params_to_numpy(shards))
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


def _ring_inputs():
    g = np.random.default_rng(7)
    out = {}
    for name, (_, _, nq, nkv, _, _) in RINGS.items():
        for x, heads in (("q", nq), ("k", nkv), ("v", nkv), ("do", nq)):
            out[f"{name}/{x}"] = g.standard_normal(
                (B, S, heads, HD)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def reference():
    params = {name: jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(i), jax_cfg(name)))
        for i, name in enumerate(CFGS)}
    ids = jax.random.randint(jax.random.PRNGKey(5), (4, 32), 0,
                             JT.TINY_LM.vocab_size)
    return params, (np.asarray(ids), np.asarray(jnp.roll(ids, -1, axis=1)))


@pytest.fixture(scope="module", params=(2, 4), ids=lambda n: f"{n}ranks")
def world(request, reference, procs2, tmp_path_factory):
    n = request.param
    work = tmp_path_factory.mktemp(f"sequence{n}")
    rings = _ring_inputs()
    np.savez(work / "ring.npz", **rings)
    ranks = spawn_world(n, {"rings": RINGS, "steps": STEP_CASES[n]},
                        reference, procs2, work, WORKER)
    return n, ranks, rings


def _cat(ranks, key):
    return np.concatenate([rk[key] for rk in ranks], axis=1)


def _jax_ring(n, layout, causal, bq, q, k, v, do):
    """The reference's ring on an n-device mesh: output and the grads of
    ``sum(out · do)``, each the concatenated chunks (the shuffled order
    for zigzag)."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    scale = 1.0 / np.sqrt(q.shape[-1])

    def ring(q, k, v):
        return JRA.ring_attention(q, k, v, "sp", scale=scale, causal=causal,
                                  block_q=bq, layout=layout)

    def body(q, k, v, do):
        out, vjp = jax.vjp(ring, q, k, v)
        return (out, *vjp(do.astype(out.dtype)))

    spec = P(None, "sp")
    f = jax.jit(JC.smap(body, mesh, in_specs=(spec,) * 4,
                        out_specs=(spec,) * 4))
    return [np.asarray(t, np.float32) for t in f(q, k, v, do)]


def _mono(q, k, v, do, causal):
    """Monolithic attention and its grads (the reference's
    ``_attention_xla``, or softmax without the mask)."""
    scale = 1.0 / np.sqrt(q.shape[-1])

    def attend(q, k, v):
        if causal:
            return JT._attention_xla(q, k, v, scale)
        rep = q.shape[2] // k.shape[2]
        k, v = jnp.repeat(k, rep, 2), jnp.repeat(v, rep, 2)
        s = jnp.einsum("bqnh,bknh->bnqk", q, k) * scale
        return jnp.einsum("bnqk,bknh->bqnh", jax.nn.softmax(s, -1), v)

    out, vjp = jax.vjp(attend, q, k, v)
    return [np.asarray(t, np.float32) for t in (out, *vjp(do.astype(
        out.dtype)))]


# ------------------------------------------------------------ one process

def test_zigzag_shuffle_positions_and_guards():
    """``zigzag_shuffle`` / ``unshuffle`` bit for bit the reference's (and
    each other's inverse); ``zigzag_positions`` of every rank the
    reference's in ``shard_map``; the guards: a length that does not cut
    into 2D stripes, zigzag without the causal mask, an odd local chunk,
    ``block_q`` out of range or not dividing, an unknown layout."""
    x = np.arange(2 * 48).reshape(2, 48)
    for d in (2, 3, 4):
        got = PS.zigzag_shuffle(torch.from_numpy(x), d).numpy()
        np.testing.assert_array_equal(got, np.asarray(JS.zigzag_shuffle(
            jnp.asarray(x), d)))
        np.testing.assert_array_equal(
            PS.zigzag_unshuffle(torch.from_numpy(got), d).numpy(), x)
        y = np.random.default_rng(d).standard_normal((2, 48, 3)).astype(
            np.float32)
        np.testing.assert_array_equal(
            PS.zigzag_unshuffle(torch.from_numpy(y), d, axis=1).numpy(),
            np.asarray(JS.zigzag_unshuffle(jnp.asarray(y), d, axis=1)))
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
        jpos = np.asarray(jax.jit(JC.smap(
            lambda: JRA.zigzag_positions("sp", 8), mesh, in_specs=(),
            out_specs=P("sp")))())
        got = np.concatenate([PRA.zigzag_positions(
            None, 8, rank=r, n_dev=n).numpy() for r in range(n)])
        np.testing.assert_array_equal(got, jpos)
    with pytest.raises(ValueError, match="stripes"):
        PS.zigzag_shuffle(torch.zeros((2, 30)), 4)
    z = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="zigzag"):
        PRA.ring_attention(z, z, z, "sp", scale=1.0, causal=False,
                           layout="zigzag")
    with pytest.raises(ValueError, match="even local chunk"):
        PRA.ring_attention(z[:, :7], z[:, :7], z[:, :7], "sp", scale=1.0,
                           layout="zigzag")
    for bq, msg in ((0, "positive divisor"), (16, "exceeds"),
                    (3, "must divide")):
        with pytest.raises(ValueError, match=msg):
            PRA.ring_attention(z, z, z, "sp", scale=1.0, block_q=bq)
    with pytest.raises(ValueError, match="unknown ring layout"):
        PRA.ring_attention(z, z, z, "sp", scale=1.0, layout="striped")


def test_ring_config_checks():
    """The config's checks: ``sp_axis`` needs the ring, the ring needs
    ``sp_axis``, the layout is one of two; ``sp_config`` sets both."""
    with pytest.raises(ValueError, match="requires attention_impl='ring'"):
        dataclasses.replace(PT.TINY_LM, sp_axis="sp")
    with pytest.raises(ValueError, match="needs sp_axis"):
        dataclasses.replace(PT.TINY_LM, attention_impl="ring")
    with pytest.raises(ValueError, match="unknown ring_layout"):
        PS.sp_config(PT.TINY_LM, layout="striped")
    cfg = PS.sp_config(PT.TINY_LM, "sp", "zigzag")
    assert (cfg.attention_impl, cfg.sp_axis, cfg.ring_layout) == (
        "ring", "sp", "zigzag")


def test_ring_at_one_rank_is_plain_attention():
    """Without a process group the ring is one rank: its own block under
    the causal mask, which is plain attention (f32, the ring tier), and
    the zigzag fold of one rank's two stripes likewise."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 32, 4, 16), generator=g) for _ in range(3))
    want = PT._attention_xla(q, k, v, 0.25)
    for layout in ("contiguous", "zigzag"):
        got = PRA.ring_attention(q, k, v, "sp", scale=0.25, layout=layout,
                                 block_q=8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **RING_TOL)


# ------------------------------------------------------------- n ranks

def test_ring_attention_matches_the_reference_and_monolithic(world):
    """Every ``RINGS`` case on n ranks: the output and dq, dk, dv
    against the reference's ring in ``shard_map`` and against monolithic
    attention (zigzag unshuffled), f32 at rtol = atol = 2e-5, bf16 at
    0.05; the hops: 2 (n - 1) a forward, as many backward."""
    n, ranks, rings = world
    for name, (layout, causal, nq, nkv, bq, dtype) in RINGS.items():
        q, k, v, do = (rings[f"{name}/{x}"] for x in ("q", "k", "v", "do"))
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        ins = [jnp.asarray(t, jdt) for t in (q, k, v, do)]
        if layout == "zigzag":
            ins = [JS.zigzag_shuffle(t, n) for t in ins]
        jring = _jax_ring(n, layout, causal, bq, *ins)
        mono = _mono(*(jnp.asarray(t, jdt) for t in (q, k, v, do)), causal)
        tol = RING_BF16_TOL if dtype == "bfloat16" else RING_TOL
        for i, key in enumerate(("out", "dq", "dk", "dv")):
            got = _cat(ranks, f"ring/{name}/{key}")
            np.testing.assert_allclose(got, jring[i], **tol,
                                       err_msg=f"{name} {key} vs ring")
            if layout == "zigzag":
                got = PS.zigzag_unshuffle(torch.from_numpy(got), n).numpy()
            np.testing.assert_allclose(got, mono[i], **tol,
                                       err_msg=f"{name} {key} vs mono")
        want = dict.fromkeys(KINDS, 0)
        want["collective_permute"] = 4 * (n - 1)
        for rk in ranks:
            assert list(rk[f"ring/{name}/counts"]) == [want[k] for k in KINDS]


def _jax_sp_steps(params, batch, dp, sp, layout):
    mesh = Mesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                ("dp", "sp"))
    cfg = JS.sp_config(jax_cfg("tiny"), "sp", layout)
    shards = JF.shard_params_fsdp(jax.tree.map(jnp.asarray, params), mesh)
    opt = JF.init_fsdp_opt_state(shards)
    step = JS.make_sp_train_step(shards, cfg, mesh, donate=False)
    losses = []
    for _ in range(STEPS):
        shards, opt, loss = step(shards, opt, batch)
        losses.append(float(loss))
    return np.array(losses), dict(_flat(jax.tree.map(np.asarray, shards)))


def test_sp_steps_match_the_reference(world, reference):
    """Two FSDP × SP steps (dp 1 × sp 2, dp 2 × sp 2, dp 1 × sp 4;
    contiguous and zigzag, the batch zigzag-shuffled on both sides) and
    two dp 1 × sp 2 × tp 2 steps against the reference's
    ``make_sp_train_step`` / ``make_tp_train_step(sp_axis=)`` on a mesh
    of the same shape: every rank's loss the same, rtol 1e-4; the
    params (each dp row's FSDP shards, or tp shards, assembled) atol
    2e-3; each step's shim counts the contract's."""
    n, ranks, _ = world
    params, batch = reference
    tiny = params["tiny"]
    for name, (dp, sp, tp, layout) in STEP_CASES[n].items():
        b = tuple(jnp.asarray(t) for t in batch)
        if layout == "zigzag":
            b = tuple(JS.zigzag_shuffle(t, sp) for t in b)
        if tp > 1:
            jl, jp = jax_tp_steps(jax_cfg("tiny"), tiny, b, dp, tp, "none", 1,
                                  sp=sp)
        else:
            jl, jp = _jax_sp_steps(tiny, b, dp, sp, layout)
        for rk in ranks:
            np.testing.assert_array_equal(rk[f"{name}/losses"],
                                          ranks[0][f"{name}/losses"])
        np.testing.assert_allclose(ranks[0][f"{name}/losses"], jl,
                                   rtol=STEP_LOSS_RTOL, err_msg=name)
        if tp > 1:
            fulls = assemble_rows(ranks, name, dp)
        else:
            rows = {}
            for rk in ranks:
                d, s = rk[f"{name}/coords"]
                rows.setdefault(int(s), {})[int(d)] = _unflat(
                    sub(rk, f"{name}/shard/"))
            fulls = {s: dict(_flat(bridge.assemble_shards(
                [row[d] for d in sorted(row)]))) for s, row in rows.items()}
        for key, full in fulls.items():
            assert sorted(full) == sorted(jp)
            for k, v in full.items():
                np.testing.assert_allclose(v, jp[k], rtol=0,
                                           atol=STEP_PARAM_ATOL,
                                           err_msg=f"{name} {key}: {k}")
        tree = _unflat(sub(ranks[0], f"{name}/shard/"))
        if tp > 1:
            want = contracts.tp_step_collectives(tree, tp, sp=sp, remat=False)
        else:
            want = contracts.sp_step_collectives(tree, dp, sp, remat=False)
        for rk in ranks:
            for row in rk[f"{name}/counts"]:
                assert list(row) == [want[k] for k in KINDS], name
