"""The port's bus-bandwidth sweep (``ops/busbench.py``,
``train/busbench.py``) against the JAX reference's accounting, on the
CPU.

``bus_factor`` is a copy of the reference's and must be bit-equal; the
payload sizing (the nccl-tests law: ``payload // itemsize`` elements, at
least n, rounded down to a multiple of n) is read off the reference's
own ``bench_collective`` on CPU meshes of 1 to 8 devices.  On two gloo
ranks every collective's output equals its numpy definition exactly
(the inputs are small integers, so bf16 sums are exact) and
``bench_collective`` returns the reference's schema; the twin, run as
``torchrun`` runs it, writes its JSON and markdown files.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_fsdp import spawn_ranks

from distributed_training_sandbox_tpu.ops import busbench as JB
from distributed_training_sandbox_tpu_torch.ops import busbench as PB

NAMES = PB.COLLECTIVE_NAMES + ("collective_permute",)

WORKER = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
from distributed_training_sandbox_tpu_torch.ops import busbench as B
from distributed_training_sandbox_tpu_torch.utils import mesh

work = Path(sys.argv[1])
mesh.init_process_group("cpu")
n, r = mesh.axis_size(), mesh.axis_rank()
res, outs = {}, {}
for name in B.COLLECTIVE_NAMES:
    nelems = B.payload_elems(4000, n, 2)
    x = B.make_input(name, nelems, r, n, torch.bfloat16, "cpu")
    outs[name] = B.collective_fn(name)(x).float().numpy()
    res[name] = B.bench_collective(name, 4000, iters=2, warmup=1).to_dict()
np.savez(work / f"out{r}.npz", **outs)
(work / f"res{r}.json").write_text(json.dumps(res))
mesh.destroy_process_group()
"""


@pytest.mark.parametrize("name", NAMES)
def test_bus_factor_is_the_references(name):
    for n in range(1, 9):
        assert PB.bus_factor(name, n) == JB.bus_factor(name, n)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sizing_is_the_references(n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    for payload, dtype, tdtype in ((1000, jnp.bfloat16, torch.bfloat16),
                                   (3, jnp.bfloat16, torch.bfloat16),
                                   (4098, jnp.float32, torch.float32),
                                   (1 << 12, jnp.float32, torch.float32)):
        ref = JB.bench_collective("all_reduce", payload, mesh, dtype=dtype,
                                  iters=1, warmup=0)
        size = torch.empty((), dtype=tdtype).element_size()
        assert PB.payload_elems(payload, n, size) * size == ref.payload_bytes


def _expected(name, xs):
    """The collective's output on each rank, from every rank's input."""
    n = len(xs)
    if name == "all_reduce":
        return [sum(xs)] * n
    if name == "all_gather":
        return [np.concatenate(xs)] * n
    if name == "reduce_scatter":
        return np.split(sum(xs), n)
    if name == "ppermute":
        return [xs[(r - 1) % n] for r in range(n)]
    chunks = [np.split(x, n) for x in xs]   # all_to_all
    return [np.concatenate([chunks[s][r] for s in range(n)])
            for r in range(n)]


def test_collectives_and_bench_on_two_gloo_ranks(procs2, tmp_path):
    n = 2
    spawn_ranks(["-c", WORKER, str(tmp_path)], n, procs2.free_port())
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(n)]
    res = [json.loads((tmp_path / f"res{r}.json").read_text())
           for r in range(n)]
    nelems = PB.payload_elems(4000, n, 2)
    fields = [f.name for f in dataclasses.fields(JB.BusResult)]
    for name in PB.COLLECTIVE_NAMES:
        xs = [PB.make_input(name, nelems, r, n, torch.bfloat16, "cpu")
              .float().numpy() for r in range(n)]
        for r, want in enumerate(_expected(name, xs)):
            np.testing.assert_array_equal(outs[r][name], want,
                                          err_msg=f"{name} rank {r}")
        for r in range(n):
            row = res[r][name]
            assert list(row) == fields
            assert (row["collective"], row["n_devices"]) == (name, n)
            assert row["payload_bytes"] == nelems * 2
            assert row["time_ms"] > 0
            assert row["busbw_gbps"] == pytest.approx(
                row["algbw_gbps"] * PB.bus_factor(name, n))


def test_twin_writes_both_files_under_torchrun(procs2, tmp_path):
    out = tmp_path / "bb"
    outs = spawn_ranks(["-m", "distributed_training_sandbox_tpu_torch.train"
                        ".busbench", "--device", "cpu", "--payloads-mb",
                        "0.01,0.02", "--iters", "2", "--out-dir", str(out)],
                       2, procs2.free_port())
    doc = json.loads((out / "busbench_gloo_2proc.json").read_text())
    assert (doc["transport"], doc["devices"], doc["platform"]) == (
        "gloo", 2, "cpu")
    assert len(doc["rows"]) == 2 * len(PB.COLLECTIVE_NAMES)
    assert doc["harness_validation"] is True
    md = (out / "busbench_gloo_2proc.md").read_text()
    assert "gloo over loopback" in md and "| all_to_all |" in md
    assert "[busbench] wrote" in outs[0]
