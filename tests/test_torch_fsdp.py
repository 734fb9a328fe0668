"""The port's multi-rank FSDP step (``parallel/fsdp.py``) against the JAX
reference's, on the CPU, at 2 and 4 ranks, on TINY_LM with the
reference's weights (bridged into each rank's shards) and batches.

Each world size is one spawn of n gloo ranks (child processes that
import torch, numpy and the port only) running every case for three
steps; each rank hands back its losses, its shards and the collectives
each step issued (the shim ``ops.collectives.COLLECTIVES``).  The JAX
side runs ``make_fsdp_train_step`` here on ``Mesh(jax.devices()[:n],
("dp",))``.  Cases: each ``overlap`` mode, ``reshard_after_forward=False``
and ``accum_steps=2`` (at ``overlap="none"``), and ``ring_fused_pallas``
with remat.

Tolerances, each with its reason (as ``test_torch_train.py``'s
three-step test): losses rtol 2e-4 and every reassembled param atol 1e-4
(f32 math reduced in other orders by XLA, torch and gloo; Adam's first
steps move each weight by about lr · sign(grad), which magnifies grad
differences at f32 level).  The port's own laws hold bit for bit:
``ring`` equals ``none`` (the ring moves data, the backward is the same
reduce_scatter), and ``ring_fused_pallas`` equals ``ring_fused`` (on
the CPU K7's plain version is the same f32 product).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_training_sandbox_tpu.data import packing as JD
from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import fsdp as PF
from distributed_training_sandbox_tpu_torch.parallel.contracts import (
    fsdp_quantized_step_collectives)
torch.set_num_threads(1)  # the suite's workers share the cores

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 120
STEPS, BATCH, SEQ, LR = 3, 8, 32, 1e-3
# name: (overlap, reshard_after_forward, accum_steps, remat)
CASES = {
    "none": ("none", True, 1, False),
    "ring": ("ring", True, 1, False),
    "ring_fused": ("ring_fused", True, 1, False),
    "ring_fused_pallas": ("ring_fused_pallas", True, 1, False),
    "zero2": ("none", False, 1, False),
    "accum2": ("none", True, 2, False),
    "ring_fused_pallas_remat": ("ring_fused_pallas", True, 1, True),
}
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
         "all_to_all", "collective_permute")

WORKER = r"""
import json, sys
from pathlib import Path
import dataclasses
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.ops import collectives as C
from distributed_training_sandbox_tpu_torch.parallel import fsdp
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
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
cases = json.loads((work / "cases.json").read_text())
res = {}
for name, (overlap, reshard, accum, remat) in cases.items():
    cfg = dataclasses.replace(T.TINY_LM, remat=remat)
    shards = bridge.shards_from_jax(tree, cfg, r, n)
    opt = fsdp.init_fsdp_opt_state(shards)
    step = fsdp.make_fsdp_train_step(shards, cfg, overlap=overlap,
                                     reshard_after_forward=reshard,
                                     accum_steps=accum, lr=float(sys.argv[2]))
    losses, counts = [], []
    for i in range(len(data["ids"])):
        C.COLLECTIVES.reset()
        shards, opt, loss = step(shards, opt, (torch.from_numpy(data["ids"][i]),
                                               torch.from_numpy(data["labels"][i])))
        counts.append([C.COLLECTIVES.read()[k] for k in C.CollectiveCounts.KINDS])
        losses.append(float(loss))
    res[f"{name}/losses"] = np.array(losses)
    res[f"{name}/counts"] = np.array(counts)
    for path, t in fsdp.optim.tree_leaves(bridge.params_to_numpy(shards)):
        res[f"{name}/shard/" + "/".join(path)] = t
try:
    fsdp.local_batch((torch.zeros(n + 1, 2),))
except ValueError as e:
    res["batch_error"] = np.array(str(e))
np.savez(work / f"rank{r}.npz", **res)
mesh.destroy_process_group()
"""


def spawn_ranks(args: list, n: int, port: int, env_extra=None,
                timeout=SPAWN_TIMEOUT_S) -> list[str]:
    """``python <args>`` in n gloo ranks with the environment torchrun
    gives; a hang fails after ``timeout`` instead of eating the suite's
    time.  Returns each rank's output."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(n), **(env_extra or {}))
    procs = [subprocess.Popen(
        [sys.executable, *args], cwd=REPO,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n}:\n{out[-3000:]}"
    return outs


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _unflat(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def reference():
    """The reference's TINY_LM weights and three global batches."""
    params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(2),
                                                     JT.TINY_LM))
    ii, ll = JD.make_packed_dataset(SEQ, JT.TINY_LM.vocab_size,
                                    num_tokens=STEPS * BATCH * (SEQ + 1) + 64,
                                    seed=5, source="synthetic",
                                    engine="numpy")
    ids = ii[:STEPS * BATCH].reshape(STEPS, BATCH, SEQ)
    labels = ll[:STEPS * BATCH].reshape(STEPS, BATCH, SEQ)
    return params, ids, labels


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def world(request, reference, procs2, tmp_path_factory):
    n = request.param
    params, ids, labels = reference
    work = tmp_path_factory.mktemp(f"fsdp{n}")
    np.savez(work / "params.npz", **dict(_flat(params)))
    np.savez(work / "batches.npz", ids=ids, labels=labels)
    (work / "cases.json").write_text(json.dumps(CASES))
    spawn_ranks(["-c", WORKER, str(work), str(LR)], n, procs2.free_port())
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(n)]
    for rk in ranks:   # each rank takes its rows of the global batch
        assert str(rk["batch_error"]) == (
            f"batch of {n + 1} rows is not divisible by mesh axis 'dp' "
            f"size {n}")
    port = {}
    for name in CASES:
        pre = f"{name}/shard/"
        shards = [_unflat({k[len(pre):]: v for k, v in rk.items()
                           if k.startswith(pre)}) for rk in ranks]
        port[name] = {"losses": ranks[0][f"{name}/losses"],
                      "counts": [rk[f"{name}/counts"] for rk in ranks],
                      "params": bridge.assemble_shards(shards),
                      "rank_losses": [rk[f"{name}/losses"] for rk in ranks]}
    return n, port


def _jax_run(n, params, ids, labels, overlap, reshard, accum, remat):
    cfg = dataclasses.replace(JT.TINY_LM, remat=remat)
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    shards = JF.shard_params_fsdp(params, mesh)
    opt = JF.init_fsdp_opt_state(shards)
    step = JF.make_fsdp_train_step(shards, cfg, mesh, lr=LR, donate=False,
                                   overlap=overlap,
                                   reshard_after_forward=reshard,
                                   accum_steps=accum)
    losses = []
    for i in range(STEPS):
        shards, opt, loss = step(shards, opt, (jnp.asarray(ids[i]),
                                               jnp.asarray(labels[i])))
        losses.append(float(loss))
    return losses, dict(_flat(jax.tree.map(np.asarray, shards)))


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_steps_match_jax(world, reference, case):
    n, port = world
    params, ids, labels = reference
    jl, jp = _jax_run(n, params, ids, labels, *CASES[case])
    got = port[case]
    for r, rl in enumerate(got["rank_losses"]):   # the mean, on every rank
        np.testing.assert_array_equal(rl, got["losses"], err_msg=f"rank {r}")
    np.testing.assert_allclose(got["losses"], jl, rtol=2e-4)
    flat = dict(_flat(got["params"]))
    assert sorted(flat) == sorted(jp)
    for name, v in flat.items():
        np.testing.assert_allclose(v, jp[name], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_ring_is_bitwise_none_and_pallas_is_bitwise_fused(world):
    _, port = world
    for a, b in (("ring", "none"), ("ring_fused_pallas", "ring_fused")):
        np.testing.assert_array_equal(port[a]["losses"], port[b]["losses"])
        pa, pb = dict(_flat(port[a]["params"])), dict(_flat(port[b]["params"]))
        for name in pa:
            np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


def expected_counts(n: int, overlap: str, reshard: bool, accum: int,
                    remat: bool, L: int = 4, *,
                    quantized_gather: bool = False,
                    quantized_grads: bool = False) -> dict:
    """The collectives one step issues, from the reference's contracts
    (``analysis/contracts.py``): ``fsdp`` (one gather and one
    reduce_scatter site per param leaf, one loss all_reduce), ``fsdp_ring``
    (each gather site n - 1 collective_permute hops, the backward one
    reduce_scatter a leaf) and ``fsdp_ring_fused_pallas`` (the 7
    projection leaves of a layer as fused rings of n - 1 hops forward
    and n - 1 backward; the other leaves as fsdp_ring).  The contracts
    count sites of the compiled scan, where a layer site stands once;
    a step issues each layer site L times, its forward gathers and hops
    once more under remat, and everything but the loss mean once a
    microbatch.  Root leaves (embed, final_norm): 2; leaves a layer: 9,
    of which 7 projections.  Quantised gathers (``quantized_gather``,
    ``quantized_grads``) count as ``parallel.contracts`` derives them
    (``fsdp_quantized_step_collectives``, at ``overlap="none"``) on
    TINY_LM's tree."""
    if quantized_gather:
        assert overlap == "none", overlap
        params = PT.init_params(dataclasses.replace(
            PT.TINY_LM, num_hidden_layers=L), torch.Generator(), "meta")
        return fsdp_quantized_step_collectives(
            params, reshard_after_forward=reshard, remat=remat,
            accum_steps=accum, quantized_grads=quantized_grads)
    root, layer, proj = 2, 9, 7
    fwd = 2 if remat else 1
    if not reshard:        # every stacked leaf gathered once, kept
        sites_fwd = sites_bwd = root + layer
    else:
        sites_fwd, sites_bwd = root + layer * L * fwd, root + layer * L
    out = dict.fromkeys(KINDS, 0)
    out["all_reduce"] = 1
    if overlap == "none":
        out["all_gather"] = accum * sites_fwd
        out["reduce_scatter"] = accum * sites_bwd
    elif overlap == "ring":
        out["collective_permute"] = accum * sites_fwd * (n - 1)
        out["reduce_scatter"] = accum * sites_bwd
    else:                  # ring_fused, ring_fused_pallas
        unfused_fwd = root + (layer - proj) * L * fwd
        out["reduce_scatter"] = accum * (root + (layer - proj) * L)
        out["collective_permute"] = accum * (n - 1) * (
            unfused_fwd + proj * L * fwd + proj * L)
    return out


def test_collective_counts_follow_the_contracts(world):
    n, port = world
    for name, (overlap, reshard, accum, remat) in CASES.items():
        want = expected_counts(n, overlap, reshard, accum, remat)
        for r, counts in enumerate(port[name]["counts"]):
            for i, step in enumerate(counts):
                assert dict(zip(KINDS, step.tolist())) == want, \
                    (name, r, i)


def _guard_kwargs():
    return [{"overlap": "spiral"},
            {"overlap": "ring_fused", "reshard_after_forward": False},
            {"overlap": "ring_fused_pallas", "quantized_gather": True},
            {"overlap": "ring_fused", "n_experts": 4},
            {"quantized_grads": True},
            {"accum_steps": 0},
            {"offload": "disk"}]


@pytest.mark.parametrize("kw", _guard_kwargs(),
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_guards_raise_the_reference_messages(kw):
    kw = dict(kw)
    experts = kw.pop("n_experts", 0)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    jcfg = dataclasses.replace(JT.TINY_LM, n_experts=experts) \
        if experts else JT.TINY_LM
    pcfg = dataclasses.replace(PT.TINY_LM, n_experts=experts)
    with pytest.raises(ValueError) as je:
        JF.make_fsdp_train_step({}, jcfg, mesh, **kw)
    with pytest.raises(ValueError) as pe:
        PF.make_fsdp_train_step({}, pcfg, **kw)
    assert str(pe.value) == str(je.value)


def test_unported_options_and_bad_layouts_raise():
    pp = PT.init_params(PT.TINY_LM, torch.Generator().manual_seed(0), "cpu")
    for kw in ({"offload": "opt"}, {"offload": "opt_act"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PF.make_fsdp_train_step(pp, PT.TINY_LM, **kw)
    # the divisibility message is the reference's
    bad = {"embed": np.zeros((6, 4), np.float32)}
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    with pytest.raises(ValueError) as je:
        JF.check_divisibility(bad, JF.fsdp_specs(bad), mesh)
    with pytest.raises(ValueError) as pe:
        PF.shard_tree({"embed": torch.zeros(6, 4)}, 0, 4)
    assert str(pe.value) == str(je.value)


def test_shards_round_trip_through_the_bridge(reference):
    params, _, _ = reference
    for n in WORLDS:
        ranks = [bridge.params_to_numpy(bridge.shards_from_jax(
            params, PT.TINY_LM, r, n)) for r in range(n)]
        assert ranks[1]["layers"]["wq"].shape == (4, 64 // n, 64)
        assert ranks[1]["embed"].shape == (512 // n, 64)
        back = dict(_flat(bridge.assemble_shards(ranks)))
        for name, v in _flat(params):
            np.testing.assert_array_equal(back[name], v, err_msg=name)


def test_train_fsdp_twin_under_torchrun_on_two_gloo_ranks(procs2, tmp_path):
    """The twin as ``torchrun --nproc-per-node 2`` starts it, for two
    steps on the CPU: finite losses, every rank's loss the same mean,
    and the collectives of the ``none`` mode at two ranks."""
    out = tmp_path / "res.json"
    outs = spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch.train."
                        "train_fsdp", "--device", "cpu", "--model", "tiny",
                        "--num-steps", "2", "--sequence-length", "32",
                        "--out", str(out)], 2, procs2.free_port())
    res = json.loads(out.read_text())
    assert res["world_size"] == 2 and res["batch_size"] == 2
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    want = expected_counts(2, "none", True, 1, False)
    assert res["collectives"] == [want, want]
    assert "[fsdp] step   1 loss" in outs[0]
