"""The port's DDP and ZeRO-1/2/3 steps (``parallel/ddp.py``,
``parallel/zero.py``) against the JAX reference's, on the CPU, at 2 and 4
ranks, on the toy MLP with the reference's weights and batches.

Each world size is one spawn of n gloo ranks (child processes that
import torch, numpy and the port only) running every case of ``CASES``
for ``STEPS`` steps; each rank hands back its losses, its params (ZeRO-3:
its chunks; q8 + EF: its residual) and the collectives each step issued
(the shim ``ops.collectives.COLLECTIVES``).  The JAX side runs the same
steps here on ``Mesh(jax.devices()[:n], ("dp",))``.

Tolerances against JAX, as ``test_torch_fsdp.py``'s: losses rtol 2e-4,
every param or chunk atol 1e-4 (f32 products and means reduced in other
orders by XLA, torch and gloo; Adam moves each weight by about lr a
step whatever the size of its grad, which magnifies grad differences
at f32 level).  The q8 sync: its int8 codes and its error-feedback
residual bit for bit against the reference function under ``jax.jit``,
its sums within one f32 rounding a term of the reference's and within
the reference's bound of ``mean_d(scale_d) / 2`` of the exact mean.
The port's own laws hold at the reference's tiers or tighter: DDP at n
ranks equals one process on the global batch (``tests/test_ddp.py``'s
2e-5); ZeRO-1/2/3 equal plain Adam (``tests/test_zero.py``'s rtol 1e-5
/ atol 1e-5); ``rebuild="broadcast"`` equals ``"all_gather"`` bit for
bit; bucketed equals per-leaf bit for bit at 2 ranks and at the
reference's rtol 1e-6 at 4, where it does not hold bit for bit
(``tests/test_step_pump.py``); ``params_sync_error`` reads exactly
0.0 after ``broadcast_params`` and more before it.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P
from test_torch_fsdp import spawn_ranks

from distributed_training_sandbox_tpu.models import mlp as JM
from distributed_training_sandbox_tpu.ops import collectives as JC
from distributed_training_sandbox_tpu.parallel import ddp as JD
from distributed_training_sandbox_tpu.parallel import optim as JO
from distributed_training_sandbox_tpu.parallel import zero as JZ
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import mlp as PM
from distributed_training_sandbox_tpu_torch.ops.collectives import (
    CollectiveCounts)
from distributed_training_sandbox_tpu_torch.parallel import ddp as PD
from distributed_training_sandbox_tpu_torch.parallel import optim as PO
from distributed_training_sandbox_tpu_torch.parallel import zero as PZ
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    ddp_bucket_count, step_collectives)
from distributed_training_sandbox_tpu_torch.train import ddp as TD
from distributed_training_sandbox_tpu_torch.train import zero as TZ
torch.set_num_threads(1)  # the suite's workers share the cores

WORLDS = (2, 4)
STEPS, BATCH, SGD_LR = 3, 16, 1e-2
# tests/test_zero.py's: width 48 (chunks pad-free at 2 and 4 ranks) and
# a pad-exercising set
SIZES = {"sq": (48, 48, 48, 48), "rag": (30, 44, 18)}
Q8_BUCKET_MB = 0.01          # 2621 f32 elements: 3 buckets of SIZES["sq"]
# name: the step (kind, size set and options)
CASES = {
    "ddp": dict(kind="ddp", sizes="sq"),
    "ddp_bucket_small": dict(kind="ddp", sizes="sq", bucket_mb=0.004),
    "ddp_bucket_large": dict(kind="ddp", sizes="sq", bucket_mb=0.02),
    "ddp_q8": dict(kind="ddp", sizes="sq", q8=True),
    "ddp_q8_ef": dict(kind="ddp", sizes="sq", q8=True, ef=True,
                      bucket_mb=Q8_BUCKET_MB),
    **{f"zero{s}_{rb}_{sz}": dict(kind="zero", sizes=sz, stage=s, rebuild=rb)
       for s in (1, 2) for rb in ("broadcast", "all_gather")
       for sz in SIZES},
    **{f"zero3_{sz}": dict(kind="zero3", sizes=sz) for sz in SIZES},
}
KINDS = CollectiveCounts.KINDS

WORKER = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import mlp
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.parallel import ddp, optim, zero
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
lr = float(sys.argv[2])
mesh.init_process_group("cpu")
n, r = mesh.axis_size(), mesh.axis_rank()
data = dict(np.load(work / "data.npz"))
cases = json.loads((work / "cases.json").read_text())


def tree(prefix):
    layers = {}
    for key, v in data.items():
        if key.startswith(prefix + "/"):
            i, leaf = key[len(prefix) + 1:].split("/")
            layers.setdefault(int(i), {})[leaf] = v
    return [layers[i] for i in sorted(layers)]


def save(res, prefix, t):
    for path, a in optim.tree_leaves(bridge.params_to_numpy(t)):
        res[prefix + "/" + "/".join(map(str, path))] = a


res = {}
for name, c in cases.items():
    params = bridge.mlp_params_from_jax(tree(c["sizes"] + "/params"))
    xs, ys = data[c["sizes"] + "/x"], data[c["sizes"] + "/y"]
    if c["kind"] == "ddp":
        state = optim.sgd_init(params)
        if c.get("ef"):
            state = (state, ddp.init_grad_residual(params))
        step = ddp.make_ddp_train_step(
            mlp.mse_loss, lambda g, s, p: optim.sgd_update(g, s, p, lr=lr),
            bucket_mb=c.get("bucket_mb"), quantize_grads=c.get("q8", False),
            error_feedback=c.get("ef", False))
    elif c["kind"] == "zero":
        state = zero.init_zero_opt_state(params)
        step = zero.make_zero_train_step(mlp.mse_loss, stage=c["stage"],
                                         rebuild=c["rebuild"])
    else:
        shapes = [{k: tuple(v.shape) for k, v in l.items()} for l in params]
        state = zero.init_zero_opt_state(params)
        params = zero.shard_params_zero3(params)
        step = zero.make_zero3_train_step(zero.make_zero3_mlp_loss(shapes))
    losses, counts = [], []
    for i in range(len(xs)):
        C.COLLECTIVES.reset()
        params, state, loss = step(params, state, (torch.from_numpy(xs[i]),
                                                   torch.from_numpy(ys[i])))
        counts.append([C.COLLECTIVES.read()[k]
                       for k in C.CollectiveCounts.KINDS])
        losses.append(float(loss))
    res[name + "/losses"] = np.array(losses)
    res[name + "/counts"] = np.array(counts)
    save(res, name + "/params", params)
    if c.get("ef"):
        save(res, name + "/residual", state[1])

# the init broadcast and the sync check, on params skewed by rank
params = bridge.mlp_params_from_jax(tree("sq/params"))
skewed = optim.tree_map(lambda p: p + r, params)
res["sync/before"] = np.array(float(ddp.params_sync_error(skewed)))
fixed = ddp.broadcast_params(skewed)
res["sync/after"] = np.array(float(ddp.params_sync_error(fixed)))
res["sync/kept_rank0"] = np.array(all(
    torch.equal(a, optim.tree_get(params, p))
    for p, a in optim.tree_leaves(fixed)))

# one q8 sync of this rank's own grads, with and without a residual
grads = bridge.residual_from_jax(tree("q8/grads"), r)
resid = bridge.residual_from_jax(tree("q8/residual"), r)
for tag, rr in (("plain", None), ("ef", resid)):
    synced, new = ddp.quantized_bucket_all_reduce(grads, "dp", %r,
                                                  residual=rr)
    save(res, "q8sync/" + tag, synced)
    if new is not None:
        save(res, "q8sync/new_residual", new)
save(res, "q8sync/exact", ddp.sync_gradients(grads))
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
""" % Q8_BUCKET_MB


def _flat(tree, prefix=""):
    """``(key, array)`` of a tree of dicts and lists, keys joined by /."""
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _unflat(flat: dict):
    """The inverse of :func:`_flat` for the MLP's list of dicts."""
    layers: dict = {}
    for key, v in flat.items():
        i, leaf = key.split("/")
        layers.setdefault(int(i), {})[leaf] = v
    return [layers[i] for i in sorted(layers)]


def _sub(rank: dict, prefix: str):
    pre = prefix + "/"
    return _unflat({k[len(pre):]: v for k, v in rank.items()
                    if k.startswith(pre)})


@pytest.fixture(scope="module")
def reference():
    """The reference's params of each size set (its ``init_mlp`` on a
    seed), STEPS batches of each from numpy, and each rank's grads and
    residual for the q8 sync (up to 4 ranks)."""
    out = {}
    rng = np.random.default_rng(3)
    for i, (tag, sizes) in enumerate(SIZES.items()):
        params = jax.tree.map(np.asarray,
                              JM.init_mlp(jax.random.PRNGKey(i), sizes))
        x = rng.standard_normal((STEPS, BATCH, sizes[0]), np.float32)
        y = rng.standard_normal((STEPS, BATCH, sizes[-1]), np.float32)
        out[tag] = (params, x, y)
    like = out["sq"][0]
    q8_grads = jax.tree.map(
        lambda p: (rng.standard_normal((4,) + p.shape)
                   * rng.uniform(0.01, 1.0, (4,) + (1,) * p.ndim)
                   ).astype(np.float32), like)
    q8_res = jax.tree.map(
        lambda p: (rng.standard_normal((4,) + p.shape) * 1e-3
                   ).astype(np.float32), like)
    out["q8"] = (q8_grads, q8_res)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, reference, procs2, tmp_path_factory):
    n = request.param
    work = tmp_path_factory.mktemp(f"ddpzero{n}")
    data = {}
    for tag in SIZES:
        params, x, y = reference[tag]
        data.update({f"{tag}/params/{k}": v for k, v in _flat(params)})
        data[f"{tag}/x"], data[f"{tag}/y"] = x, y
    q8_grads, q8_res = reference["q8"]
    data.update({f"q8/grads/{k}": v[:n] for k, v in _flat(q8_grads)})
    data.update({f"q8/residual/{k}": v[:n] for k, v in _flat(q8_res)})
    np.savez(work / "data.npz", **data)
    (work / "cases.json").write_text(json.dumps(CASES))
    spawn_ranks(["-c", WORKER, str(work), str(SGD_LR)], n,
                procs2.free_port())
    return n, [dict(np.load(work / f"rank{r}.npz")) for r in range(n)]


def _port(ranks, name):
    """A case's losses (rank 0's), every rank's losses and counts, and
    its params in the reference's layout: ZeRO-3's every rank's chunks
    concatenated (as the reference's chunk arrays read), EF's residuals
    stacked."""
    case = CASES[name]
    trees = [_sub(rk, name + "/params") for rk in ranks]
    params = (bridge.assemble_zero_chunks(trees) if case["kind"] == "zero3"
              else trees[0])
    out = {"losses": ranks[0][name + "/losses"],
           "rank_losses": [rk[name + "/losses"] for rk in ranks],
           "counts": [rk[name + "/counts"] for rk in ranks],
           "params": params, "rank_params": trees}
    if case.get("ef"):
        out["residual"] = bridge.stack_residuals(
            [_sub(rk, name + "/residual") for rk in ranks])
    return out


def _jax_run(n, reference, name):
    case = CASES[name]
    params, xs, ys = reference[case["sizes"]]
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    if case["kind"] == "ddp":
        state = JO.sgd_init(params)
        if case.get("ef"):
            state = (state, JD.init_grad_residual(params, n))
        step = JD.make_ddp_train_step(
            JM.mse_loss, lambda g, s, p: JO.sgd_update(g, s, p, lr=SGD_LR),
            mesh, "dp", donate=False, bucket_mb=case.get("bucket_mb"),
            quantize_grads=case.get("q8", False),
            error_feedback=case.get("ef", False))
    elif case["kind"] == "zero":
        state = JZ.init_zero_opt_state(params, mesh, "dp")
        step = JZ.make_zero_train_step(JM.mse_loss, mesh, "dp",
                                       stage=case["stage"],
                                       rebuild=case["rebuild"], donate=False)
    else:
        shapes = [{k: v.shape for k, v in layer.items()} for layer in params]
        state = JZ.init_zero_opt_state(params, mesh, "dp")
        params = JZ.shard_params_zero3(params, mesh, "dp")
        step = JZ.make_zero3_train_step(JZ.make_zero3_mlp_loss(shapes, "dp"),
                                        mesh, "dp", donate=False)
    losses = []
    for i in range(STEPS):
        params, state, loss = step(params, state, (jnp.asarray(xs[i]),
                                                   jnp.asarray(ys[i])))
        losses.append(float(loss))
    out = {"losses": losses, "params": jax.tree.map(np.asarray, params)}
    if case.get("ef"):
        out["residual"] = jax.tree.map(np.asarray, state[1])
    return out


def _assert_trees(got, want, **tol):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for k, v in g.items():
        np.testing.assert_allclose(v, w[k], err_msg=k, **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(world, reference, case):
    n, ranks = world
    got, want = _port(ranks, case), _jax_run(n, reference, case)
    for r, rl in enumerate(got["rank_losses"]):   # the mean, on every rank
        np.testing.assert_array_equal(rl, got["losses"], err_msg=f"rank {r}")
    if CASES[case]["kind"] != "zero3":   # replicated params: every rank's
        for r, t in enumerate(got["rank_params"][1:], 1):
            _assert_trees(t, got["params"], rtol=0, atol=0)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
    _assert_trees(got["params"], want["params"], rtol=0, atol=1e-4)
    if "residual" in want:
        _assert_trees(got["residual"], want["residual"], rtol=0, atol=1e-4)


def expected_counts(case: dict, n_leaves: int, param_bytes: int) -> dict:
    """The collectives one step of a ``CASES`` case issues:
    ``parallel.contracts.step_collectives``, the reference's contract
    formulas (ZeRO-3's gathers as calls; its docstring derives 2n - 1)."""
    kind = f"zero{case['stage']}" if case["kind"] == "zero" else case["kind"]
    return step_collectives(kind, n_leaves, param_bytes,
                            bucket_mb=case.get("bucket_mb"),
                            q8=case.get("q8", False),
                            rebuild=case.get("rebuild", "broadcast"))


def test_collective_counts_follow_the_contracts(world, reference):
    _, ranks = world
    for name, case in CASES.items():
        params = reference[case["sizes"]][0]
        leaves = [v for _, v in _flat(params)]
        want = expected_counts(case, len(leaves),
                               sum(v.nbytes for v in leaves))
        for r, rk in enumerate(ranks):
            for i, step in enumerate(rk[name + "/counts"]):
                assert dict(zip(KINDS, step.tolist())) == want, (name, r, i)


def test_bucketed_sizes_make_several_buckets(reference):
    """The bucket sizes of ``CASES`` split SIZES["sq"] as the count test
    assumes: several buckets at the small size, fewer at the large."""
    nbytes = sum(v.nbytes for _, v in _flat(reference["sq"][0]))
    assert [ddp_bucket_count(nbytes, CASES[c]["bucket_mb"])
            for c in ("ddp_bucket_small", "ddp_bucket_large")] == [7, 2]
    from distributed_training_sandbox_tpu.analysis.contracts import (
        ddp_bucket_count as ref_count)
    for mb in (0.004, 0.01, 0.02, 25.0):
        assert ddp_bucket_count(nbytes, mb) == ref_count(nbytes, mb)


def _one_process_sgd(params, xs, ys):
    """Plain SGD on the global batch in this process (no process group):
    the port's DDP step at one rank."""
    p = bridge.mlp_params_from_jax(params)
    step = PD.make_ddp_train_step(
        PM.mse_loss, lambda g, s, q: PO.sgd_update(g, s, q, lr=SGD_LR))
    state, losses = PO.sgd_init(p), []
    for i in range(STEPS):
        p, state, loss = step(p, state, (torch.from_numpy(xs[i]),
                                         torch.from_numpy(ys[i])))
        losses.append(float(loss))
    return losses, bridge.params_to_numpy(p)


def _one_process_adam(params, xs, ys):
    """Plain Adam (autograd, no collectives) on the global batch."""
    p = bridge.mlp_params_from_jax(params)
    state, losses = PO.adam_init(p), []
    leaves = [t for _, t in PO.tree_leaves(p)]
    for i in range(STEPS):
        for t in leaves:
            t.requires_grad_(True)
        loss = PM.mse_loss(p, (torch.from_numpy(xs[i]),
                               torch.from_numpy(ys[i])))
        grads = PO.tree_unflatten(p, torch.autograd.grad(loss, leaves))
        for t in leaves:
            t.requires_grad_(False)
        p, state = PO.adam_update(grads, state, p)
        losses.append(float(loss.detach()))
    return losses, bridge.params_to_numpy(p)


def test_ddp_equals_one_process_on_the_global_batch(world, reference):
    _, ranks = world
    params, xs, ys = reference["sq"]
    losses, want = _one_process_sgd(params, xs, ys)
    got = _port(ranks, "ddp")
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    _assert_trees(got["params"], want, rtol=0, atol=2e-5)


def test_zero_equals_plain_adam(world, reference):
    n, ranks = world
    for sz in SIZES:
        params, xs, ys = reference[sz]
        losses, want = _one_process_adam(params, xs, ys)
        chunks = [bridge.params_to_numpy(bridge.zero_chunks_from_jax(
            want, r, n)) for r in range(n)]
        for name, case in CASES.items():
            if case["kind"] == "ddp" or case["sizes"] != sz:
                continue
            got = _port(ranks, name)
            np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                       err_msg=name)
            ref = (bridge.assemble_zero_chunks(chunks)
                   if case["kind"] == "zero3" else want)
            _assert_trees(got["params"], ref, rtol=0, atol=1e-5)


def test_rebuild_broadcast_is_bitwise_all_gather(world):
    _, ranks = world
    for s in (1, 2):
        for sz in SIZES:
            a = _port(ranks, f"zero{s}_broadcast_{sz}")
            b = _port(ranks, f"zero{s}_all_gather_{sz}")
            np.testing.assert_array_equal(a["losses"], b["losses"])
            _assert_trees(a["params"], b["params"], rtol=0, atol=0)


def test_bucketed_equals_per_leaf(world):
    """Bit for bit at 2 ranks (a sum of two is order-free); at 4 within
    the reference's rtol 1e-6, since gloo may add a long flat bucket in
    another order than per-leaf calls."""
    n, ranks = world
    base = _port(ranks, "ddp")
    tol = dict(rtol=0, atol=0) if n == 2 else dict(rtol=1e-6, atol=0)
    for name in ("ddp_bucket_small", "ddp_bucket_large"):
        got = _port(ranks, name)
        np.testing.assert_allclose(got["losses"], base["losses"], **tol)
        _assert_trees(got["params"], base["params"], **tol)


def test_params_sync_error_after_broadcast(world):
    n, ranks = world
    for rk in ranks:
        # ranks skewed by their index: sum over r of r^2 per element
        assert float(rk["sync/before"]) > 0
        assert float(rk["sync/after"]) == 0.0
        assert bool(rk["sync/kept_rank0"])


def _jax_q8_sync(n, grads, residual):
    """The reference's ``quantized_bucket_all_reduce`` under jit over an
    n-device mesh, each device's grads (and residual) its row of the
    stacked trees."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))

    def f(g, r):
        g = jax.tree.map(lambda a: a[0], g)
        r = jax.tree.map(lambda a: a[0], r) if r is not None else None
        synced, new = JD.quantized_bucket_all_reduce(g, "dp", Q8_BUCKET_MB,
                                                     residual=r)
        new = (jax.tree.map(lambda a: a[None], new) if new is not None
               else None)
        return synced, new

    cut = lambda t: jax.tree.map(lambda a: a[:n], t)   # noqa: E731
    out = {}
    for tag, res in (("plain", None), ("ef", cut(residual))):
        fn = jax.jit(JC.smap(f, mesh, in_specs=(P("dp"), P("dp")),
                             out_specs=(P(), P("dp"))))
        synced, new = fn(cut(grads), res)
        out[tag] = jax.tree.map(np.asarray, synced)
        if new is not None:
            out["new_residual"] = jax.tree.map(np.asarray, new)
    return out


def _buckets(tree_np, n, residual=None):
    """Each rank's flat f32 vector of a stacked tree (plus its residual),
    and the bucket starts of ``Q8_BUCKET_MB``."""
    flat = np.concatenate([np.asarray(v)[:n].reshape(n, -1)
                           for _, v in _flat(tree_np)], axis=1)
    if residual is not None:
        flat = flat + np.concatenate([np.asarray(v)[:n].reshape(n, -1)
                                      for _, v in _flat(residual)], axis=1)
    cap = max(int(Q8_BUCKET_MB * 2 ** 20) // 4, 1)
    return flat, [(s, min(s + cap, flat.shape[1]))
                  for s in range(0, flat.shape[1], cap)]


def test_q8_sync_matches_jax_and_the_bound(world, reference):
    """Each rank's q8 sync of its own grads against the reference's under
    jit: the new residual bit for bit (the codes and scales are the
    same); the synced mean within ws roundings of its terms' magnitude,
    ``ws · 2^-23 · sum_d |q_d · s_d| / ws`` an element (the reference's
    compiled sum may fuse a product into the addition, the port rounds
    each term); and within ``mean_d(scale_d) / 2`` of the exact mean."""
    n, ranks = world
    grads, residual = reference["q8"]
    want = _jax_q8_sync(n, grads, residual)
    stacked = bridge.stack_residuals(
        [_sub(rk, "q8sync/new_residual") for rk in ranks])
    _assert_trees(stacked, want["new_residual"], rtol=0, atol=0)
    exact = np.concatenate([v.reshape(-1) for _, v in
                            _flat(_sub(ranks[0], "q8sync/exact"))])
    for tag, res in (("plain", None), ("ef", residual)):
        flat, buckets = _buckets(grads, n, res)
        want_flat = np.concatenate([v.reshape(-1)
                                    for _, v in _flat(want[tag])])
        for r, rk in enumerate(ranks):
            got = np.concatenate([v.reshape(-1) for _, v in
                                  _flat(_sub(rk, f"q8sync/{tag}"))])
            for s, e in buckets:
                terms = []
                for d in range(n):
                    q, sc = PD.quantize_bucket(torch.from_numpy(flat[d, s:e]))
                    terms.append(np.abs(q.numpy() * sc.numpy()))
                mag = np.sum(terms, axis=0) / n
                np.testing.assert_array_less(
                    np.abs(got[s:e] - want_flat[s:e]),
                    n * 2.0 ** -23 * mag + 1e-30, err_msg=f"{tag} {r}")
                if res is None:   # the bound against the exact mean
                    scales = np.abs(flat[:, s:e]).max(axis=1) / 127.0
                    bound = scales.mean() / 2 * (1 + 1e-5)
                    assert np.abs(got[s:e] - exact[s:e]).max() <= bound


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
def test_q8_codes_bitwise_vs_jitted_jax(reference, ef):
    """One rank: the synced grads are ``codes · scale`` (a sum of one),
    so bit-equal outputs mean bit-equal codes; the port's
    ``quantize_bucket`` codes are those of the reference's jitted sync,
    read back as ``output / scale``."""
    grads, residual = reference["q8"]
    want = _jax_q8_sync(1, grads, residual)
    g = bridge.residual_from_jax(grads, 0)
    r = bridge.residual_from_jax(residual, 0) if ef else None
    synced, new = PD.quantized_bucket_all_reduce(g, "dp", Q8_BUCKET_MB,
                                                 residual=r)
    tag = "ef" if ef else "plain"
    _assert_trees(bridge.params_to_numpy(synced), want[tag], rtol=0, atol=0)
    if ef:
        _assert_trees(bridge.stack_residuals([bridge.params_to_numpy(new)]),
                      want["new_residual"], rtol=0, atol=0)
    flat = torch.cat([t.reshape(-1) for _, t in PO.tree_leaves(g)])
    if ef:
        flat = flat + torch.cat([t.reshape(-1) for _, t in
                                 PO.tree_leaves(r)])
    out = np.concatenate([v.reshape(-1) for _, v in _flat(want[tag])])
    cap = max(int(Q8_BUCKET_MB * 2 ** 20) // 4, 1)
    for s in range(0, flat.numel(), cap):
        q, scale = PD.quantize_bucket(flat[s:s + cap])
        np.testing.assert_array_equal(
            q.numpy(), np.round(out[s:s + cap] / scale.numpy()))


def test_partition_owner_shard_range_match_jax():
    for n_params in (1, 5, 12, 13):
        for ws in (1, 2, 3, 4, 5, 8):
            assert PZ.partition_params(n_params, ws) == \
                JZ.partition_params(n_params, ws)
            for i in range(n_params):
                assert PZ.owner_of_param(i, n_params, ws) == \
                    JZ.owner_of_param(i, n_params, ws)
    for n in (0, 7, 32, 33):
        for ws in (1, 2, 4, 5):
            for rank in range(ws):
                assert PD.shard_range(n, ws, rank) == \
                    JD.shard_range(n, ws, rank)


def test_chunk_shapes_padding_matches_jax():
    jp = [{"w": jnp.zeros((30, 44)), "b": jnp.zeros((44,))}]
    pp = [{"w": torch.zeros(30, 44), "b": torch.zeros(44)}]
    for ws in (1, 2, 4, 8):
        js, ps = JZ.chunk_shapes(jp, ws), PZ.chunk_shapes(pp, ws)
        for k in ("w", "b"):
            assert tuple(ps[0][k].shape) == js[0][k].shape
            assert ps[0][k].dtype == torch.float32
    assert PZ.chunk_shapes(pp, 8)[0]["w"].shape == (165,)
    assert PZ.chunk_shapes(pp, 8)[0]["b"].shape == (6,)


def test_zero_chunks_bridge_bitwise_vs_shard_params_zero3(reference):
    for sz in SIZES:
        params = reference[sz][0]
        for n in WORLDS:
            mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
            want = jax.tree.map(np.asarray,
                                JZ.shard_params_zero3(params, mesh, "dp"))
            got = bridge.assemble_zero_chunks(
                [bridge.params_to_numpy(bridge.zero_chunks_from_jax(
                    params, r, n)) for r in range(n)])
            _assert_trees(got, want, rtol=0, atol=0)
            # and back: every rank's chunks gathered without a group
            shapes = [{k: v.shape for k, v in layer.items()}
                      for layer in params]
            full = [{k: got[i][k][:math.prod(s)].reshape(s)
                     for k, s in layer.items()}
                    for i, layer in enumerate(shapes)]
            _assert_trees(full, params, rtol=0, atol=0)


@pytest.mark.parametrize("sz", list(SIZES))
def test_mlp_loss_and_grads_match_jax(reference, sz):
    params, xs, ys = reference[sz]
    batch = (jnp.asarray(xs[0]), jnp.asarray(ys[0]))
    jl, jg = jax.value_and_grad(JM.mse_loss)(params, batch)
    p = bridge.mlp_params_from_jax(params)
    leaves = [t.requires_grad_(True) for _, t in PO.tree_leaves(p)]
    x, y = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
    np.testing.assert_allclose(PM.mlp_apply(p, x).detach().numpy(),
                               np.asarray(JM.mlp_apply(params, batch[0])),
                               rtol=1e-5, atol=1e-6)
    loss = PM.mse_loss(p, (x, y))
    grads = PO.tree_unflatten(p, torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    _assert_trees(bridge.params_to_numpy(grads),
                  jax.tree.map(np.asarray, jg), rtol=1e-5, atol=1e-7)
    # a non-final pipeline stage keeps its last ReLU
    np.testing.assert_array_equal(
        PM.mlp_apply_stage(p, x).detach().numpy() >= 0, True)


def test_init_mlp_ranges_are_the_reference_code():
    """The reference draws ``w`` within ``sqrt(6 / fan_in) / sqrt(2)``
    (sqrt(3) times nn.Linear's bound) and ``b`` within
    ``1 / sqrt(fan_in)``; the port copies those ranges, not the
    docstring's nn.Linear."""
    sizes = (400, 300, 20)
    jp = JM.init_mlp(jax.random.PRNGKey(0), sizes)
    pp = PM.init_mlp(torch.Generator().manual_seed(0), sizes)
    for i, fan_in in enumerate(sizes[:-1]):
        wb, bb = math.sqrt(6 / fan_in) / math.sqrt(2), 1 / math.sqrt(fan_in)
        for layer in (jp[i], pp[i]):
            w, b = np.asarray(layer["w"]), np.asarray(layer["b"])
            assert w.shape == (fan_in, sizes[i + 1]) and w.dtype == np.float32
            assert np.abs(w).max() <= wb and np.abs(w).max() > 0.98 * wb
            assert np.abs(b).max() <= bb and np.abs(b).max() > 0.9 * bb
            assert abs(w.mean()) < 0.02 * wb
    toy = PM.zero_toy_mlp(torch.Generator().manual_seed(0), scale=200)
    assert [tuple(l["w"].shape) for l in toy] == [(50, 50)] * 6
    assert [tuple(l["w"].shape) for l in PM.pp_toy_mlp(
        torch.Generator().manual_seed(0))] == \
        list(zip(PM.PP_TOY_SIZES[:-1], PM.PP_TOY_SIZES[1:]))
    assert PM.ZERO_TOY_SIZES == JM.ZERO_TOY_SIZES
    assert PM.PP_TOY_SIZES == JM.PP_TOY_SIZES


def test_tree_helpers_walk_lists_and_keep_dict_trees():
    tree = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    assert [p for p, _ in PO.tree_leaves(tree)] == [("a",), ("b", "c")]
    mlp = [{"w": torch.ones(2, 2), "b": torch.ones(2)}, (torch.ones(1),)]
    assert [p for p, _ in PO.tree_leaves(mlp)] == \
        [(0, "w"), (0, "b"), (1, 0)]
    doubled = PO.tree_map(lambda t: 2 * t, mlp)
    assert type(doubled[1]) is tuple and float(doubled[1][0]) == 2.0
    assert PO.tree_get(mlp, (0, "w")) is mlp[0]["w"]
    # a NamedTuple is a leaf
    st = PO.AdamState(mu=1, nu=2, count=0)
    assert list(PO.tree_leaves([st])) == [((0,), st)]


def test_zero_rejects_stage3_and_unknown_rebuild():
    with pytest.raises(ValueError, match="make_zero3_train_step"):
        PZ.make_zero_train_step(PM.mse_loss, stage=3)
    with pytest.raises(ValueError, match="unknown rebuild mode 'ring'"):
        PZ.make_zero_train_step(PM.mse_loss, rebuild="ring")


def test_twins_default_to_the_card_and_refuse_the_classification_leg():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.run(num_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TZ.run(1, num_steps=1)
    # the classification leg is ported: on the card by default, and it
    # refuses the GLUE MRPC source, which needs a download
    for model in ("smollm3-350m", "tiny"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TD.run(model=model, source="synthetic", num_steps=1)
        with pytest.raises(NotImplementedError, match="GLUE MRPC"):
            TD.run(model=model, source="mrpc", device="cpu")


@pytest.mark.parametrize("twin", ["zero", "ddp"])
def test_twins_under_torchrun_on_two_gloo_ranks(procs2, tmp_path, twin):
    """The twins as ``torchrun --nproc-per-node 2`` starts them, at scale
    200 for 3 steps on the CPU: finite losses, the A/B report (ZeRO-3:
    half the optimizer and param MB a rank, every loss and param equal to
    the baseline's within the reference's 1e-5), DDP's sync check and
    its collectives."""
    out = tmp_path / "res.json"
    args = ["-m", f"distributed_training_sandbox_tpu_torch.train.{twin}",
            "--device", "cpu", "--scale", "200", "--num-steps", "3",
            "--out", str(out)]
    if twin == "zero":
        args += ["--stage", "3"]
    outs = spawn_ranks(args, 2, procs2.free_port())
    res = json.loads(out.read_text())
    assert res["world_size"] == 2
    if twin == "zero":
        assert "[zero3] === A/B report ===" in outs[0]
        assert "[zero3] loss drift baseline-vs-sharded" in outs[0]
        assert "baseline losses" in outs[0]
        assert len(res["shard_losses"]) == 3
        assert all(np.isfinite(res["base_losses"] + res["shard_losses"]))
        np.testing.assert_allclose(res["shard_losses"], res["base_losses"],
                                   rtol=1e-5)
        assert res["loss_drift"] < 1e-5 and res["param_max_abs_diff"] < 1e-5
        n = 6 * (50 * 50 + 50)   # 12 leaves of width 50, none padded
        assert res["base_opt_mb"] == pytest.approx(2 * 4 * n / 2 ** 20)
        assert res["shard_opt_mb"] == pytest.approx(res["base_opt_mb"] / 2)
        assert res["shard_param_mb"] == pytest.approx(res["param_mb"] / 2)
        want = expected_counts(CASES["zero3_sq"], 12, 4 * n)
        assert all(c == want for c in res["shard_counts"])
        assert all(c == expected_counts(CASES["ddp"], 12, 4 * n)
                   for c in res["base_counts"])
    else:
        assert "[ddp] param sync check passed (divergence 0.0)" in outs[0]
        assert "[ddp] step   2 loss" in outs[0]
        assert res["sync_error"] == 0.0 and len(res["losses"]) == 3
        assert all(np.isfinite(res["losses"]))
        assert res["init_collectives"]["broadcast"] == 12
        want = expected_counts(CASES["ddp"], 12, 0)
        assert res["collectives"] == [want] * 3


def test_order_bound_holds_for_two_orders_of_cancelling_sums():
    """``zero_drift.order_bound`` is not tighter than f32 arithmetic: ws
    terms summed left to right and right to left, then divided by ws,
    part by
    no more than the bound, also where the terms cancel."""
    from distributed_training_sandbox_tpu_torch.train.zero_drift import (
        order_bound)
    rng = np.random.default_rng(0)
    for ws in (2, 3, 4, 8):
        t = rng.standard_normal((ws, 200_000)).astype(np.float32)
        t[-1] = -t[:-1].sum(0) * np.float32(1 + 1e-6)   # near-cancelling
        fwd, rev = t[0].copy(), t[-1].copy()
        for k in range(1, ws):
            fwd, rev = fwd + t[k], rev + t[ws - 1 - k]
        a, b = fwd / np.float32(ws), rev / np.float32(ws)
        err = np.abs(a.astype(np.float64) - b.astype(np.float64))
        bound = order_bound(torch.from_numpy(
            np.abs(t.astype(np.float64)).sum(0)), ws).numpy()
        assert (a != b).any() or ws == 2, ws   # a + b is b + a
        assert (err <= bound).all(), (ws, float((err / bound).max()))


def test_zero_drift_on_four_gloo_ranks(procs2, tmp_path):
    """``train.zero_drift`` as ``torchrun --nproc-per-node 4`` starts it,
    at scale 200 for 3 steps: every rank's chunk of every grad within
    the summation-order bound, a reading a step, ZeRO-3 equal to ZeRO-2,
    and no param difference where no grad differed."""
    out = tmp_path / "drift.json"
    outs = spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch."
                        "train.zero_drift", "--device", "cpu", "--scale",
                        "200", "--num-steps", "3", "--out", str(out)], 4,
                       procs2.free_port())
    res = json.loads(out.read_text())
    assert res["world_size"] == 4 and len(res["steps"]) == 3
    assert "[zero_drift] step 2: grads differ at" in outs[0]
    n = 6 * (50 * 50 + 52)   # the chunks: each bias padded to 52
    for row in res["steps"]:
        assert row["elements"] == n and row["over_bound"] == 0
        assert row["err_over_bound"] <= 1.0 and row["zero3_equals_zero2"]
        assert all(np.isfinite(row["loss"]))
    assert res["final"]["params_differ"] == 0
    assert res["final"]["max_diff_untouched"] == 0.0
