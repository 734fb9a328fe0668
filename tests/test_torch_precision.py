"""The port's quantized collectives (``ops/quant.py``) and the FSDP step's
precision knobs (``parallel/fsdp.py``: ``quantized_gather``,
``quantized_grads``, ``state_precision="int8"``) against the JAX
reference, on the CPU, at 2 and 4 gloo ranks.

Each world size is one spawn of n gloo ranks (child processes that
import torch, numpy and the port only) running every collective case,
and one more spawn of 2 ranks runs the FSDP cases for three steps; each
rank hands its results back as ``.npz``.  The JAX side runs the same
inputs in ``shard_map`` on a CPU mesh of the same size, once a spawn in
a module-scoped fixture.

Tiers, each with its reason:
- The int8 codes and f32 scales each rank puts on the wire are bit-equal
  to the jitted reference's (the quantiser's form, ``ops/quant.py``),
  so a gather's dequantised output is bit-equal too.
- A sum over ranks (the all-reduce, the reduce-scatter, the f32
  reduce_scatter of a gather's backward) adds the same terms in another
  order: the port adds the dequantised terms in rank order, one f32
  rounding each, while XLA reduces them in its own order and may fuse
  ``q · s`` into its adds (ROADMAP.md C3).  Element by element they may
  differ by ``ws`` f32 roundings of the terms' magnitude,
  ``ws · 2^-24 · Σ_r |t_r|`` (``_sum_tier``).
- Against the full-precision collective, the reference's documented
  bound: ``n_ranks · max_scale / 2`` element by element (half a
  quantum a contribution), plus the sum tier.
- FSDP steps: losses rtol 1e-5; shards atol 1e-4 after three steps
  (``test_torch_fsdp.py``'s tier: f32 sums in other orders, magnified
  by Adam's first steps; a code of a quantised gather flips where a
  weight has moved across a rounding boundary).  int8 moments: the
  reference's jitted update contracts ``b·m + (1 - b)·g`` into a fused
  multiply-add (XLA on the CPU), the port rounds the product first, and
  the grads they accumulate differ by summation order, so after the
  first step a code may sit one step apart: dequantised moments within one
  quantum (the row's scale) of the reference's, plus the scales' own
  difference over 127 codes; scales and the 1-D
  leaves' moments at ``MOMENT_RTOL``, with an atol of ``MOMENT_RTOL``
  times the leaf's largest entry for entries that cancel to near zero
  (read: scales 1.6e-5 apart, 1-D moments 7e-6 of the leaf's largest).
  C6: each rank's scale of the stacked norm scales equals its own
  device's buffer of the reference, read through
  ``addressable_shards``; the two devices' buffers differ.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_fsdp import _flat, _unflat, expected_counts, spawn_ranks

from distributed_training_sandbox_tpu.data import packing as JD
from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.ops import collectives as JC
from distributed_training_sandbox_tpu.ops import quant as JQ
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.ops import quant as PQ
from distributed_training_sandbox_tpu_torch.parallel import fsdp as PF
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    fsdp_quantized_step_collectives)

WORLDS = (2, 4)
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
         "all_to_all", "collective_permute")
STEPS, BATCH, SEQ, LR = 3, 8, 32, 1e-3
# name: (kind, local shape as a function of the world n, dim, q8_bwd,
# dtype)
COLL_CASES = {
    "ag1": ("ag", lambda n: (6,), 0, False, "float32"),
    "ag2d0": ("ag", lambda n: (4, 6), 0, False, "float32"),
    "ag2d1": ("ag", lambda n: (4, 6), 1, False, "float32"),
    "ag3d0": ("ag", lambda n: (2, 4, 6), 0, False, "float32"),
    "ag3d1": ("ag", lambda n: (2, 4, 6), 1, False, "float32"),
    "ag3d2": ("ag", lambda n: (2, 4, 6), 2, False, "float32"),
    "ag2d0_bf16": ("ag", lambda n: (4, 6), 0, False, "bfloat16"),
    "agq1": ("ag", lambda n: (6,), 0, True, "float32"),
    "agq2d0": ("ag", lambda n: (4, 6), 0, True, "float32"),
    "agq2d1": ("ag", lambda n: (4, 6), 1, True, "float32"),
    "agq3d1": ("ag", lambda n: (2, 4, 6), 1, True, "float32"),
    "ar1": ("ar", lambda n: (8,), 0, False, "float32"),
    "ar2": ("ar", lambda n: (4, 6), 0, False, "float32"),
    "ar3": ("ar", lambda n: (2, 3, 8), 0, False, "float32"),
    "rs1": ("rs", lambda n: (3 * n,), 0, False, "float32"),
    "rs2d0": ("rs", lambda n: (2 * n, 3 * n), 0, False, "float32"),
    "rs2d1": ("rs", lambda n: (2 * n, 3 * n), 1, False, "float32"),
    "rs3d0": ("rs", lambda n: (2 * n, n, 3), 0, False, "float32"),
    "rs3d1": ("rs", lambda n: (2, 2 * n, 3), 1, False, "float32"),
    "rs3d2": ("rs", lambda n: (2, 3, 2 * n), 2, False, "float32"),
}
# name: (quantized_gather, quantized_grads, state_precision,
# reshard_after_forward, remat), at 2 ranks
FSDP_CASES = {
    "qgather": (True, False, "full", True, False),
    "qgather_qgrads": (True, True, "full", True, False),
    "state8": (False, False, "int8", True, False),
    "all_three": (True, True, "int8", True, False),
    "all_three_remat": (True, True, "int8", True, True),
    "qgather_zero2": (True, True, "full", False, False),
}
FSDP_WORLD = 2
MOMENT_RTOL = 1e-4

WORKER = r"""
import dataclasses, json, sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.ops import quant as Q
from distributed_training_sandbox_tpu_torch.parallel import fsdp
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
mesh.init_process_group("cpu")
n, r = mesh.axis_size(), mesh.axis_rank()
res = {}

def codes(kind, x, dim):
    if kind == "ar":
        return Q.quantize_int8(x.reshape(1, -1) if x.ndim < 2 else x, -1)
    if x.ndim == 1:
        return Q.quantize_int8(x.reshape(1, -1), -1)
    return Q.quantize_int8(x, -1 if dim != x.ndim - 1 else 0)

meta = {}
if (work / "coll.npz").exists():
    coll = dict(np.load(work / "coll.npz"))
    meta = json.loads((work / "coll.json").read_text())
for name, (kind, dim, q8, dtype) in meta.items():
    x = torch.from_numpy(coll[name + "/x"][r]).to(getattr(torch, dtype))
    x.requires_grad_(True)
    c = torch.from_numpy(coll[name + "/c"][r])
    if kind == "ag":
        out = Q.quantized_all_gather(x, "dp", dim, q8)
    elif kind == "ar":
        out = Q.quantized_all_reduce(x, "dp")
    else:
        out = Q.quantized_reduce_scatter(x, "dp", dim)
    (g,) = torch.autograd.grad((out.float() * c).sum(), x)
    q, s = codes(kind, x.detach(), dim)
    res[name + "/out"] = out.detach().float().numpy()
    res[name + "/grad"] = g.float().numpy()
    res[name + "/q"] = q.numpy()
    res[name + "/s"] = s.numpy()
try:
    Q.quantized_reduce_scatter(torch.zeros(2, n + 1), "dp", 1)
except ValueError as e:
    res["rs_error"] = np.array(str(e))

if (work / "params.npz").exists():
    flat = dict(np.load(work / "params.npz"))
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    data = np.load(work / "batches.npz")
    cases = json.loads((work / "cases.json").read_text())
    for name, (qg, qgr, sp, reshard, remat) in cases.items():
        cfg = dataclasses.replace(T.TINY_LM, remat=remat)
        shards = bridge.shards_from_jax(tree, cfg, r, n)
        opt = (fsdp.init_fsdp_opt_state8(shards) if sp == "int8"
               else fsdp.init_fsdp_opt_state(shards))
        step = fsdp.make_fsdp_train_step(
            shards, cfg, quantized_gather=qg, quantized_grads=qgr,
            state_precision=sp, reshard_after_forward=reshard,
            lr=float(sys.argv[2]))
        losses, counts = [], []
        for i in range(len(data["ids"])):
            C.COLLECTIVES.reset()
            shards, opt, loss = step(shards, opt, (
                torch.from_numpy(data["ids"][i]),
                torch.from_numpy(data["labels"][i])))
            counts.append([C.COLLECTIVES.read()[k]
                           for k in C.CollectiveCounts.KINDS])
            losses.append(float(loss))
            if i == 0:   # the moments after one step
                mu, nu, _ = bridge.adam_state_to_numpy(opt)
                for mom, tree_m in (("mu", mu), ("nu", nu)):
                    for path, t in fsdp.optim.tree_leaves(tree_m):
                        key = f"{name}/{mom}/" + "/".join(map(str, path))
                        if hasattr(t, "scale"):
                            res[key + "/q"], res[key + "/scale"] = t
                        else:
                            res[key] = t
        res[f"{name}/losses"] = np.array(losses)
        res[f"{name}/counts"] = np.array(counts)
        for path, t in fsdp.optim.tree_leaves(bridge.params_to_numpy(shards)):
            res[f"{name}/shard/" + "/".join(path)] = t
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


# ------------------------------------------------------------- reference

def _jax_codes(kind, x, dim):
    if kind == "ar":
        return JQ.quantize_int8(x.reshape(1, -1) if x.ndim < 2 else x, -1)
    if x.ndim == 1:
        return JQ.quantize_int8(x.reshape(1, -1), -1)
    return JQ.quantize_int8(x, -1 if dim != x.ndim - 1 else 0)


def _jax_collective(mesh, kind, dim, q8):
    """Per device: (out, grad of sum(out · c), codes, scales), each on a
    leading rank axis."""
    def fn(x):
        if kind == "ag":
            return JQ.quantized_all_gather(x, "dp", dim, q8)
        if kind == "ar":
            return JQ.quantized_all_reduce(x, "dp")
        return JQ.quantized_reduce_scatter(x, "dp", dim)

    def per_device(x, c):
        x, c = x[0], c[0]
        out, vjp = jax.vjp(fn, x)
        (g,) = vjp(c.astype(out.dtype))
        q, s = _jax_codes(kind, x, dim)
        return tuple(t[None] for t in (out.astype(jnp.float32),
                                       g.astype(jnp.float32), q, s))

    return jax.jit(JC.smap(per_device, mesh, (P("dp"), P("dp")),
                           (P("dp"),) * 4))


def _out_shape(kind, shape, dim, n):
    if kind == "ag":
        return tuple(s * n if i == dim else s for i, s in enumerate(shape))
    if kind == "rs":
        return tuple(s // n if i == dim else s for i, s in enumerate(shape))
    return shape


def _coll_inputs(n):
    rng = np.random.default_rng(10 + n)
    arrays, meta = {}, {}
    for name, (kind, shape_fn, dim, q8, dtype) in COLL_CASES.items():
        shape = shape_fn(n)
        x = (rng.standard_normal((n, *shape)) * rng.uniform(0.1, 3.0, n)
             .reshape(n, *[1] * len(shape))).astype(np.float32)
        if dtype == "bfloat16":   # bf16 values, carried as f32
            x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        c = rng.standard_normal((n, *_out_shape(kind, shape, dim, n))) \
            .astype(np.float32)
        arrays[name + "/x"], arrays[name + "/c"] = x, c
        meta[name] = (kind, dim, q8, dtype)
    return arrays, meta


@pytest.fixture(scope="module")
def lm_reference():
    params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(2),
                                                     JT.TINY_LM))
    ii, ll = JD.make_packed_dataset(SEQ, JT.TINY_LM.vocab_size,
                                    num_tokens=STEPS * BATCH * (SEQ + 1) + 64,
                                    seed=5, source="synthetic",
                                    engine="numpy")
    return (params, ii[:STEPS * BATCH].reshape(STEPS, BATCH, SEQ),
            ll[:STEPS * BATCH].reshape(STEPS, BATCH, SEQ))


def _jax_fsdp(params, ids, labels, qg, qgr, sp, reshard, remat):
    """Losses, shards (numpy) and, for int8 state, every device's local
    moments after the first step (``addressable_shards``) of the
    reference's steps."""
    mesh = Mesh(np.array(jax.devices()[:FSDP_WORLD]), ("dp",))
    shards = JF.shard_params_fsdp(params, mesh)
    opt = (JF.init_fsdp_opt_state8(shards) if sp == "int8"
           else JF.init_fsdp_opt_state(shards))
    cfg = dataclasses.replace(JT.TINY_LM, remat=remat)
    step = JF.make_fsdp_train_step(shards, cfg, mesh, lr=LR,
                                   donate=False, quantized_gather=qg,
                                   quantized_grads=qgr, state_precision=sp,
                                   reshard_after_forward=reshard)
    def per_device(a):
        by_dev = {s.device: np.asarray(s.data) for s in a.addressable_shards}
        return [by_dev[d] for d in mesh.devices]

    losses, local = [], None
    for i in range(STEPS):
        shards, opt, loss = step(shards, opt, (jnp.asarray(ids[i]),
                                               jnp.asarray(labels[i])))
        losses.append(float(loss))
        if i == 0 and sp == "int8":
            local = jax.tree.map(per_device, (opt.mu, opt.nu))
    return losses, dict(_flat(jax.tree.map(np.asarray, shards))), local


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, procs2, tmp_path_factory):
    """Every collective case on n gloo ranks, and the reference's."""
    n = request.param
    work = tmp_path_factory.mktemp(f"precision{n}")
    arrays, meta = _coll_inputs(n)
    np.savez(work / "coll.npz", **arrays)
    (work / "coll.json").write_text(json.dumps(meta))
    spawn_ranks(["-c", WORKER, str(work), str(LR)], n, procs2.free_port())
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(n)]
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    ref = {}
    for name, (kind, dim, q8, dtype) in meta.items():
        outs = _jax_collective(mesh, kind, dim, q8)(
            jnp.asarray(arrays[name + "/x"], getattr(jnp, dtype)),
            jnp.asarray(arrays[name + "/c"]))
        ref[name] = [np.asarray(t) for t in outs]
    return n, arrays, ranks, ref


# ----------------------------------------------------------- collectives

def _sum_tier(terms: np.ndarray) -> np.ndarray:
    """``ws`` f32 roundings of the terms' magnitude, element by element
    (``terms`` on a leading rank axis)."""
    return terms.shape[0] * 2.0 ** -24 * np.abs(terms).sum(axis=0)


@pytest.mark.parametrize("case", list(COLL_CASES))
def test_codes_and_scales_are_bitwise(world, case):
    n, _, ranks, ref = world
    for r, rk in enumerate(ranks):
        np.testing.assert_array_equal(rk[case + "/q"], ref[case][2][r],
                                      err_msg=f"{case} rank {r} codes")
        np.testing.assert_array_equal(rk[case + "/s"], ref[case][3][r],
                                      err_msg=f"{case} rank {r} scales")


def _rs_chunk(t, dim, n, r):
    c = t.shape[dim] // n
    return np.take(t, np.arange(r * c, (r + 1) * c), axis=dim)


@pytest.mark.parametrize("case", list(COLL_CASES))
def test_outputs_and_grads_match_the_reference(world, case):
    n, arrays, ranks, ref = world
    kind, _, dim, q8, _ = COLL_CASES[case]
    x = arrays[case + "/x"].astype(np.float32)
    c = arrays[case + "/c"]
    for r, rk in enumerate(ranks):
        out, grad = rk[case + "/out"], rk[case + "/grad"]
        jout, jgrad = ref[case][0][r], ref[case][1][r]
        if kind == "ag":   # codes and scales bit-equal: so is the output
            np.testing.assert_array_equal(out, jout, err_msg=case)
            if not q8:     # an f32 reduce_scatter of the cotangents
                tier = _rs_chunk(_sum_tier(c), dim, n, r)
            else:          # quantised: the codes' terms in rank order
                cq = np.stack([np.asarray(JQ.dequantize(*_jax_codes(
                    "rs", jnp.asarray(ci), dim), jnp.float32))
                    .reshape(ci.shape) for ci in c])
                tier = _rs_chunk(_sum_tier(cq), dim, n, r)
            assert np.all(np.abs(grad - jgrad) <= tier), case
        elif kind == "ar":
            terms = np.stack([rk2[case + "/q"].astype(np.float64)
                              * rk2[case + "/s"] for rk2 in ranks])
            tier = _sum_tier(terms).reshape(out.shape)
            assert np.all(np.abs(out - jout) <= tier), case
            # the backward: a full-precision all_reduce of the cotangents
            assert np.all(np.abs(grad - jgrad) <= _sum_tier(c)), case
        else:
            terms = np.stack([(rk2[case + "/q"].astype(np.float64)
                               * rk2[case + "/s"]).reshape(x.shape[1:])
                              for rk2 in ranks])
            tier = _rs_chunk(_sum_tier(terms), dim, n, r)
            assert np.all(np.abs(out - jout) <= tier), case
            # the backward: an all_gather of the cotangents, bit for bit
            np.testing.assert_array_equal(grad, jgrad, err_msg=case)


@pytest.mark.parametrize("case", [c for c in COLL_CASES
                                  if COLL_CASES[c][0] != "ag"])
def test_sums_keep_the_references_bound(world, case):
    """``|quantised - plain| <= n · max_scale / 2`` element by element:
    half a quantum a rank's contribution (plus the sum tier)."""
    n, arrays, ranks, _ = world
    kind, _, dim, _, _ = COLL_CASES[case]
    x = arrays[case + "/x"].astype(np.float64)
    plain = x.sum(axis=0)
    max_scale = max(float(rk[case + "/s"].max()) for rk in ranks)
    for r, rk in enumerate(ranks):
        want = plain if kind == "ar" else _rs_chunk(plain, dim, n, r)
        bound = n * max_scale / 2 + _sum_tier(
            x if kind == "ar" else np.stack([_rs_chunk(t, dim, n, r)
                                             for t in x]))
        assert np.all(np.abs(rk[case + "/out"] - want) <= bound), case


def test_reduce_scatter_refuses_a_dim_that_does_not_divide(world):
    n, _, ranks, _ = world
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    with pytest.raises(ValueError) as je:
        jax.jit(JC.smap(lambda a: JQ.quantized_reduce_scatter(a, "dp", 1),
                        mesh, P("dp"), P("dp")))(jnp.zeros((2 * n, n + 1)))
    for rk in ranks:
        assert str(rk["rs_error"]) == str(je.value)


def test_one_rank_is_the_round_trip():
    """Without a process group each collective is one rank's: the
    gather and the all-reduce return the int8 round-trip of x, not x."""
    x = torch.linspace(-3, 5, 24).reshape(4, 6)
    want = PQ.dequantize(*PQ.quantize_int8(x, -1), torch.float32)
    assert torch.equal(PQ.quantized_all_gather(x, "dp", 0), want)
    assert torch.equal(PQ.quantized_all_reduce(x, "dp"), want)
    assert torch.equal(PQ.quantized_reduce_scatter(x, "dp", 0), want)
    assert not torch.equal(want, x)


# ------------------------------------------------------------------ FSDP

@pytest.fixture(scope="module")
def fsdp_world(lm_reference, procs2, tmp_path_factory):
    """The FSDP cases on 2 gloo ranks, and the reference's."""
    params, ids, labels = lm_reference
    work = tmp_path_factory.mktemp("precision_fsdp")
    np.savez(work / "params.npz", **dict(_flat(params)))
    np.savez(work / "batches.npz", ids=ids, labels=labels)
    (work / "cases.json").write_text(json.dumps(FSDP_CASES))
    spawn_ranks(["-c", WORKER, str(work), str(LR)], FSDP_WORLD,
                procs2.free_port())
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(FSDP_WORLD)]
    ref = {name: _jax_fsdp(params, ids, labels, *opts)
           for name, opts in FSDP_CASES.items()}
    return ranks, ref


def _fsdp_port(ranks, name):
    pre = f"{name}/shard/"
    shards = [_unflat({k[len(pre):]: v for k, v in rk.items()
                       if k.startswith(pre)}) for rk in ranks]
    return {"losses": [rk[f"{name}/losses"] for rk in ranks],
            "counts": [rk[f"{name}/counts"] for rk in ranks],
            "params": bridge.assemble_shards(shards)}


@pytest.mark.parametrize("case", list(FSDP_CASES))
def test_fsdp_steps_match_the_reference(fsdp_world, case):
    ranks, ref = fsdp_world
    got = _fsdp_port(ranks, case)
    jl, jp, _ = ref[case]
    for r, rl in enumerate(got["losses"]):
        np.testing.assert_allclose(rl, jl, rtol=1e-5, err_msg=f"rank {r}")
    flat = dict(_flat(got["params"]))
    assert sorted(flat) == sorted(jp)
    for name, v in flat.items():
        np.testing.assert_allclose(v, jp[name], rtol=0, atol=1e-4,
                                   err_msg=f"{case} {name}")


def _jax_local(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", ["state8", "all_three",
                                  "all_three_remat"])
def test_int8_moments_match_each_devices_buffers(fsdp_world, case):
    """Each rank's int8 moments after the first step against its own
    device's buffers of the reference (C6: never through
    ``np.asarray``) at the module docstring's tiers.  Later steps feed
    each side its own params, up to 1e-4 apart (the shards' tier)."""
    ranks, ref = fsdp_world
    jmu, jnu = ref[case][2]
    checked = 0
    for mom, jtree in (("mu", jmu), ("nu", jnu)):
        pre = f"{case}/{mom}/"
        for key in sorted(k for k in ranks[0] if k.startswith(pre)):
            path = key[len(pre):].split("/")
            if path[-1] == "scale":
                continue
            for r, rk in enumerate(ranks):
                if path[-1] == "q":   # a Q8 leaf: codes and scales
                    jq = _jax_local(jtree, path[:-1])
                    s, js = rk[key[:-1] + "scale"], jq.scale[r]
                    np.testing.assert_allclose(s, js, rtol=MOMENT_RTOL,
                                               err_msg=key)
                    deq = rk[key].astype(np.float64) * s
                    jdeq = jq.q[r].astype(np.float64) * js
                    # one code step, and the scales' own difference
                    assert np.all(np.abs(deq - jdeq)
                                  <= s + 127 * MOMENT_RTOL * js), key
                else:
                    jv = _jax_local(jtree, path)[r]
                    np.testing.assert_allclose(
                        rk[key], jv, rtol=MOMENT_RTOL,
                        atol=MOMENT_RTOL * np.abs(jv).max(), err_msg=key)
                checked += 1
    assert checked == 2 * 2 * 11   # 2 ranks, 2 moments, 11 leaves


def test_c6_scales_differ_by_device_and_each_rank_keeps_its_own(fsdp_world):
    ranks, ref = fsdp_world
    jmu, _ = ref["state8"][2]
    dev = jmu["layers"]["ln1"].scale
    assert not np.allclose(dev[0], dev[1], rtol=1e-3)   # "replicated"
    for r, rk in enumerate(ranks):
        got = rk["state8/mu/layers/ln1/scale"]
        np.testing.assert_allclose(got, dev[r], rtol=MOMENT_RTOL)
        assert not np.allclose(got, dev[1 - r], rtol=1e-3)
    # assemble_shards keeps them one a rank
    q8 = [bridge.Q8(rk["state8/mu/layers/ln1/q"],
                    rk["state8/mu/layers/ln1/scale"]) for rk in ranks]
    both = bridge.assemble_shards([{"layers": {"ln1": q}} for q in q8])
    ln1 = both["layers"]["ln1"]
    assert ln1.q.shape == (4, 64) and ln1.scale.shape == (2, 4, 1)


@pytest.mark.parametrize("case", list(FSDP_CASES))
def test_fsdp_counts_follow_the_contract(fsdp_world, case):
    """The shim's counts a step against the contract, through
    ``test_torch_fsdp.py``'s adapter (remat re-gathers every layer's
    codes and scales in the backward)."""
    ranks, _ = fsdp_world
    got = _fsdp_port(ranks, case)
    qg, qgr, _, reshard, remat = FSDP_CASES[case]
    want = expected_counts(FSDP_WORLD, "none", reshard, 1, remat,
                           quantized_gather=qg, quantized_grads=qgr)
    for r, counts in enumerate(got["counts"]):
        for i, step in enumerate(counts):
            assert dict(zip(KINDS, step.tolist())) == want, (case, r, i)


def test_contract_counts_the_quantised_leaves():
    """By hand on TINY_LM (2 root leaves, embed 2-D; 9 leaves a layer,
    ln1/ln2 1-D inside the layer), 4 layers, remat on: each quantised
    leaf gathers twice (codes, scales) a forward and again in the
    recompute; under quantized_grads its reduce_scatter becomes two
    all_to_alls."""
    params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                     JT.TINY_LM))
    got = fsdp_quantized_step_collectives(params, remat=True,
                                          quantized_grads=True)
    q_layer, one_d = 7 * 4, 2 * 4
    assert got["all_gather"] == 2 * 1 + 1 + (2 * q_layer + one_d) * 2
    assert got["all_to_all"] == 2 * (1 + q_layer)
    assert got["reduce_scatter"] == 1 + one_d
    assert got["all_reduce"] == 1


def _guard_kwargs():
    return [{"overlap": "ring_fused", "quantized_gather": True},
            {"overlap": "ring_fused_pallas", "quantized_gather": True},
            {"quantized_grads": True}]


@pytest.mark.parametrize("kw", _guard_kwargs(),
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_refusals_are_the_references(kw):
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    with pytest.raises(ValueError) as je:
        JF.make_fsdp_train_step({}, JT.TINY_LM, mesh, **kw)
    with pytest.raises(ValueError) as pe:
        PF.make_fsdp_train_step({}, PT.TINY_LM, **kw)
    assert str(pe.value) == str(je.value)


def test_train_fsdp_twin_with_every_precision_knob(procs2, tmp_path):
    """``train.train_fsdp`` under ``torchrun --nproc-per-node 2`` with
    quantised gathers and grads and int8 state, two steps on the CPU:
    finite losses, the counts of the contract, and the moments at rest
    two int8 codes a param plus the scales (f32 moments take eight)."""
    out = tmp_path / "res.json"
    spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch.train."
                 "train_fsdp", "--device", "cpu", "--model", "tiny",
                 "--num-steps", "2", "--sequence-length", "32",
                 "--quantized-gather", "--quantized-grads",
                 "--state-precision", "int8", "--out", str(out)], 2,
                procs2.free_port())
    res = json.loads(out.read_text())
    assert res["quantized_gather"] and res["state_precision"] == "int8"
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                     JT.TINY_LM))
    want = fsdp_quantized_step_collectives(params, remat=False,
                                           quantized_grads=True)
    assert res["collectives"] == [want, want]
    n_params = sum(v.size for _, v in _flat(params)) // 2   # a rank's
    # f32 moments would take 8 bytes a param; int8 codes take 2 plus
    # one f32 scale a row
    assert 2 * n_params < res["opt_state_bytes"] < 2.2 * n_params
