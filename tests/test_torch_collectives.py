"""The port's collectives (``ops/collectives.py``) against the JAX
reference's, on the CPU, at 2 and 4 ranks.

Each world size is one spawn of n gloo ranks (child processes that
import torch, numpy and the port only, never JAX) running every case on
inputs made here with numpy; each rank hands its results back as an
``.npz``.  The JAX side runs here, on ``Mesh(jax.devices()[:n],
("dp",))``, rank r's input being the reference's device r's shard.

Tolerances, each with its reason:
- every plain collective: bit for bit.  The sums (all_reduce,
  reduce_scatter, their grads) run on integer-valued floats, whose sums
  are exact in any order: gloo and XLA add the ranks' terms in their
  own orders, which neither framework specifies;
- PRODUCT: rtol 1e-6 (``exp`` of a sum of logs, the reference's form;
  the two libraries' ``exp`` and ``log`` may differ in the last bit);
- ``ring_all_gather`` against ``all_gather``: bit for bit, values and
  grads (pure data movement, the same backward);
- ``all_gather_matmul`` and ``all_gather_matmul_pallas`` (whose chunk
  product is K7's plain version on the CPU) against the reference's,
  f32 (16, 64)·(64, 48): rtol = atol = 1e-5 on values, rtol 1e-5 atol
  1e-4 on grads (the same products summed in another order by another
  BLAS; grads reach ~40);
- the two ports of the fused ring against each other: bit for bit (on
  the CPU K7's plain version is the same f32 product).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from distributed_training_sandbox_tpu.ops import collectives as JC
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 120

WORKER = r"""
import sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.utils import mesh

out_dir = Path(sys.argv[1])
mesh.init_process_group("cpu")
n, r = mesh.axis_size(), mesh.axis_rank()
inp = {k: torch.from_numpy(v) for k, v in np.load(out_dir / "inputs.npz").items()}
res = {}
xi, xf, xr, xu, xa = (inp[k][r] for k in ("xi", "xf", "xr", "xu", "xa"))
res["ar_sum"] = C.all_reduce(xi)
res["ar_max"] = C.all_reduce(xf, op="max")
res["ar_min"] = C.all_reduce(xf, op="min")
res["ar_mean"] = C.all_reduce(xi, mean=True)
res["ar_prod"] = C.all_reduce(xf, op="prod")
res["ag0"] = C.all_gather(xf, axis=0)
res["ag1"] = C.all_gather(xf, axis=1)
res["ag_untiled"] = C.all_gather(xf, axis=1, tiled=False)
res["rs0"] = C.reduce_scatter(xr, axis=0)
res["rs1"] = C.reduce_scatter(xr.T.contiguous(), axis=1)
res["rs_untiled"] = C.reduce_scatter(xu, axis=0, tiled=False)
res["bcast"] = C.broadcast(xf, root=1)
res["scatter"] = C.scatter(inp["xr"][0], axis=0)
res["perm"] = C.ppermute_ring(xf, shift=1)
res["perm_back"] = C.ppermute_ring(xf, shift=-1)
res["a2a"] = C.all_to_all(xa, split_axis=0, concat_axis=1)
res["a2a_untiled"] = C.all_to_all(xu, split_axis=0, concat_axis=1,
                                  tiled=False)
res["barrier"] = C.barrier()
t = C.tree_all_reduce({"u": xi, "v": {"w": 2 * xi}})
res["tree_ar_u"], res["tree_ar_w"] = t["u"], t["v"]["w"]
t = C.tree_all_gather({"s": xf[0, 0], "m": xf, "k": "name"})
assert t["k"] == "name"
res["tree_ag_s"], res["tree_ag_m"] = t["s"], t["m"]
res["rag0"] = C.ring_all_gather(xf, axis=0)
res["rag1"] = C.ring_all_gather(xf, axis=1)


def grad(fn, *args):
    args = [a.clone().requires_grad_(True) for a in args]
    fn(*args).backward()
    return [a.grad for a in args]


res["g_ag"], = grad(lambda x: (C.all_gather(x, axis=0) ** 2).sum(), xf)
res["g_rag"], = grad(lambda x: (C.ring_all_gather(x, axis=0) ** 2).sum(), xf)
res["g_ag1"], = grad(lambda x: (C.all_gather(x, axis=1) * inp["xg"][r]).sum(), xi)
res["g_rag1"], = grad(lambda x: (C.ring_all_gather(x, axis=1)
                                 * inp["xg"][r]).sum(), xi)
res["g_rs"], = grad(lambda x: (C.reduce_scatter(x, axis=0)
                               * xi[0, :3]).sum(), xr)
res["g_ar"], = grad(lambda x: (C.all_reduce(x) * xi).sum(), xi)
res["g_perm"], = grad(lambda x: (C.ppermute_ring(x) * xi).sum(), xf)
a, w = inp["a"], inp["w"].chunk(n, 0)[r]
C.COUNTS.reset()
for name, fn in (("agmm", C.all_gather_matmul),
                 ("agmmp", C.all_gather_matmul_pallas)):
    res[name] = fn(a, w)
    res[f"g_{name}_a"], res[f"g_{name}_w"] = grad(
        lambda a_, w_: (fn(a_, w_) ** 2).sum(), a, w)
res["k7_counts"] = torch.tensor([C.COUNTS.launches, C.COUNTS.plain_calls])
errs = []
for fn in (C.all_gather_matmul, C.all_gather_matmul_pallas):
    try:
        fn(a[:, :56], w)
    except ValueError as e:
        errs.append(str(e))
for call in (lambda: C.scatter(torch.ones(4 * n + 1, 2), axis=0),
             lambda: C.reduce_scatter(torch.ones(4 * n + 1, 2), axis=0)):
    try:
        call()
    except ValueError as e:
        errs.append(str(e))
res["errors"] = np.array(errs)
C.COLLECTIVES.reset()
C.all_gather(xf)
C.ring_all_gather(xf)
C.all_reduce(xi)
C.barrier()
C.reduce_scatter(xr)
C.ppermute_ring(xf)
C.broadcast(xf)
C.all_to_all(xa)
y = C.all_gather_matmul(a.clone().requires_grad_(True),
                        w.clone().requires_grad_(True))
counts_fwd = C.COLLECTIVES.read()
y.sum().backward()
counts_all = C.COLLECTIVES.read()
res["counts_fwd"] = np.array([counts_fwd[k] for k in C.CollectiveCounts.KINDS])
res["counts_all"] = np.array([counts_all[k] for k in C.CollectiveCounts.KINDS])
np.savez(out_dir / f"rank{r}.npz",
         **{k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()})
mesh.destroy_process_group()
"""


def spawn_ranks(code: str, n: int, work: Path, port: int) -> list[dict]:
    """Run ``code`` in n gloo ranks (the environment torchrun gives);
    each writes ``work/rank{r}.npz``.  A hang fails after
    ``SPAWN_TIMEOUT_S`` instead of eating the suite's time."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(n))
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(work)], cwd=REPO,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n}:\n{out[-3000:]}"
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(n)]


def _inputs(n: int) -> dict:
    rng = np.random.default_rng(100 + n)
    ints = lambda *s: rng.integers(-8, 9, size=s).astype(np.float32)  # noqa
    return {
        "xi": ints(n, 6, 8),                       # integer-valued
        "xf": rng.standard_normal((n, 6, 8)).astype(np.float32),
        "xr": ints(n, 4 * n, 3),
        "xu": ints(n, n, 5),
        "xa": rng.standard_normal((n, 2 * n, 3)).astype(np.float32),
        "xg": ints(n, 6, 8 * n),
        "a": rng.standard_normal((16, 64)).astype(np.float32),
        "w": rng.standard_normal((64, 48)).astype(np.float32),
    }


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, procs2, tmp_path_factory):
    n = request.param
    work = tmp_path_factory.mktemp(f"collectives{n}")
    inp = _inputs(n)
    np.savez(work / "inputs.npz", **inp)
    return n, inp, spawn_ranks(WORKER, n, work, procs2.free_port())


def _per_rank(fn, n, *args, specs=None):
    """``fn`` under shard_map on n devices, rank r's input ``args[i][r]``
    (or replicated where ``specs`` says P()); returns each device's
    output stacked on a new leading dim."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    specs = specs or (P("dp"),) * len(args)
    glob = [jnp.asarray(a.reshape(-1, *a.shape[2:])) if s == P("dp")
            else jnp.asarray(a) for a, s in zip(args, specs)]
    f = JC.smap(lambda *xs: jax.tree.map(lambda y: y[None], fn(*xs)), mesh,
                tuple(specs), P("dp"))
    return jax.tree.map(np.asarray, jax.jit(f)(*glob))


def _same(port_ranks, key, ref):
    for r, out in enumerate(port_ranks):
        np.testing.assert_array_equal(out[key], ref[r], err_msg=f"{key} "
                                      f"rank {r}")


def test_plain_collectives_are_bitwise_jax(world):
    n, inp, ranks = world
    xi, xf, xr, xu, xa = (inp[k] for k in ("xi", "xf", "xr", "xu", "xa"))
    jax_cases = {
        "ar_sum": (lambda x: JC.all_reduce(x, "dp"), xi),
        "ar_max": (lambda x: JC.all_reduce(x, "dp", "max"), xf),
        "ar_min": (lambda x: JC.all_reduce(x, "dp", "min"), xf),
        "ar_mean": (lambda x: JC.all_reduce(x, "dp", mean=True), xi),
        "ag0": (lambda x: JC.all_gather(x, "dp", axis=0), xf),
        "ag1": (lambda x: JC.all_gather(x, "dp", axis=1), xf),
        "ag_untiled": (lambda x: JC.all_gather(x, "dp", axis=1,
                                               tiled=False), xf),
        "rs0": (lambda x: JC.reduce_scatter(x, "dp", axis=0), xr),
        "rs1": (lambda x: JC.reduce_scatter(x.T, "dp", axis=1), xr),
        "rs_untiled": (lambda x: JC.reduce_scatter(x, "dp", axis=0,
                                                   tiled=False), xu),
        "bcast": (lambda x: JC.broadcast(x, "dp", root=1), xf),
        "perm": (lambda x: JC.ppermute_ring(x, "dp", shift=1), xf),
        "perm_back": (lambda x: JC.ppermute_ring(x, "dp", shift=-1), xf),
        "a2a": (lambda x: JC.all_to_all(x, "dp", split_axis=0,
                                        concat_axis=1), xa),
        "a2a_untiled": (lambda x: JC.all_to_all(x, "dp", split_axis=0,
                                                concat_axis=1, tiled=False),
                        xu),
        "tree_ar_u": (lambda x: JC.tree_all_reduce({"u": x}, "dp")["u"], xi),
        "tree_ar_w": (lambda x: JC.tree_all_reduce({"w": 2 * x}, "dp")["w"],
                      xi),
        "tree_ag_s": (lambda x: JC.tree_all_gather({"s": x[0, 0]}, "dp")["s"],
                      xf),
        "tree_ag_m": (lambda x: JC.tree_all_gather({"m": x}, "dp")["m"], xf),
    }
    for key, (fn, x) in jax_cases.items():
        _same(ranks, key, _per_rank(fn, n, x))
    # scatter: each rank's chunk of a replicated tensor
    ref = _per_rank(lambda x: JC.scatter(x, "dp", axis=0), n, xr[0],
                    specs=(P(),))
    _same(ranks, "scatter", ref)
    ref = _per_rank(lambda x: JC.barrier("dp"), n, xf)
    _same(ranks, "barrier", ref)
    ref = _per_rank(lambda x: JC.all_reduce(x, "dp", "prod"), n, xf)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["ar_prod"], ref[r], rtol=1e-6)


def test_collective_grads_are_the_reference_transposes(world):
    n, inp, ranks = world
    xi, xf, xr, xg = inp["xi"], inp["xf"], inp["xr"], inp["xg"]

    def g(loss, *args):
        return _per_rank(lambda *xs: jax.grad(loss, argnums=0)(*xs), n,
                         *args)

    _same(ranks, "g_ag", g(lambda x: jnp.sum(
        JC.all_gather(x, "dp", axis=0) ** 2), xf))
    _same(ranks, "g_ag1", g(lambda x, y: jnp.sum(
        JC.all_gather(x, "dp", axis=1) * y), xi, xg))
    _same(ranks, "g_rs", g(lambda x, y: jnp.sum(
        JC.reduce_scatter(x, "dp", axis=0) * y[0, :3]), xr, xi))
    _same(ranks, "g_ar", g(lambda x, y: jnp.sum(JC.all_reduce(x, "dp") * y),
                           xi, xi))
    _same(ranks, "g_perm", g(lambda x, y: jnp.sum(
        JC.ppermute_ring(x, "dp") * y), xf, xi))


def test_ring_all_gather_is_bitwise_all_gather(world):
    n, inp, ranks = world
    for out in ranks:
        for ring, mono in (("rag0", "ag0"), ("rag1", "ag1"),
                           ("g_rag", "g_ag"), ("g_rag1", "g_ag1")):
            np.testing.assert_array_equal(out[ring], out[mono], err_msg=ring)
    ref = _per_rank(lambda x: JC.ring_all_gather(x, "dp", 1), n, inp["xf"])
    _same(ranks, "rag1", ref)


def test_all_gather_matmul_matches_jax(world):
    """Both ports of the fused ring against the reference's
    ``all_gather_matmul`` and ``all_gather_matmul_pallas``
    (``interpret=True``), value and grads; the port's two are bitwise
    equal, and the kernel twin made one chunk product a rank a step
    (K7's plain version on the CPU)."""
    n, inp, ranks = world
    a, w = inp["a"], inp["w"]
    specs = (P(), P("dp"))
    wr = w.reshape(n, -1, w.shape[1])
    for name, fn in (("agmm", JC.all_gather_matmul),
                     ("agmmp", lambda a_, w_, ax: JC.all_gather_matmul_pallas(
                         a_, w_, ax, interpret=True))):
        out = _per_rank(lambda a_, w_: fn(a_, w_, "dp"), n, a, wr,
                        specs=specs)
        ga, gw = _per_rank(lambda a_, w_: jax.grad(
            lambda a2, w2: jnp.sum(fn(a2, w2, "dp") ** 2),
            argnums=(0, 1))(a_, w_), n, a, wr, specs=specs)
        for r, port in enumerate(ranks):
            np.testing.assert_allclose(port[name], out[r], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            np.testing.assert_allclose(port[f"g_{name}_a"], ga[r],
                                       rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(port[f"g_{name}_w"], gw[r],
                                       rtol=1e-5, atol=1e-4)
    for port in ranks:
        for k in ("agmm", "g_agmm_a", "g_agmm_w"):
            np.testing.assert_array_equal(port[k], port[k.replace(
                "agmm", "agmmp")], err_msg=k)
        # two passes (value, then value and grads) of n chunk products
        assert port["k7_counts"].tolist() == [0, 2 * n]


def test_ring_errors_speak_as_the_reference(world):
    n, inp, ranks = world
    a = jnp.asarray(inp["a"][:, :56])
    w = jnp.asarray(inp["w"]).reshape(n, -1, 48)
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    want = []
    for fn in (JC.all_gather_matmul, JC.all_gather_matmul_pallas):
        with pytest.raises(ValueError) as e:
            jax.jit(JC.smap(lambda w_: fn(a, w_[0], "dp"), mesh, P("dp"),
                            P()))(w)
        want.append(str(e.value))
    with pytest.raises(ValueError) as e:
        jax.jit(JC.smap(lambda x: JC.scatter(x, "dp", axis=0), mesh, P(),
                        P()))(jnp.ones((4 * n + 1, 2)))
    want.append(str(e.value))
    for port in ranks:
        errs = port["errors"].tolist()
        assert errs[:3] == want
        assert "reduce_scatter: scatter dim 0 of size" in errs[3]
        assert "not divisible by mesh axis 'dp'" in errs[3]


def test_recording_shim_counts_each_wire_call(world):
    """One count per wire call: a ring gather is n - 1 hops, a barrier an
    all_reduce, and the fused ring's backward n - 1 reverse hops."""
    n, _, ranks = world
    fwd = {"all_reduce": 2, "all_gather": 1, "reduce_scatter": 1,
           "broadcast": 1, "all_to_all": 1,
           "collective_permute": (n - 1) + 1 + (n - 1)}
    both = dict(fwd, collective_permute=fwd["collective_permute"] + n - 1)
    kinds = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
             "all_to_all", "collective_permute")
    for port in ranks:
        assert dict(zip(kinds, port["counts_fwd"].tolist())) == fwd
        assert dict(zip(kinds, port["counts_all"].tolist())) == both
