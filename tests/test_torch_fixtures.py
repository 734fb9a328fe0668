"""Every strategy's fixture (``analysis/fixtures.py``) on two gloo ranks.

One spawn of two ranks (child processes importing torch, numpy and the
port only) builds each registered strategy on the CPU, observes one step
under the shim's capture and checks it against its contract: the
verdict is ok on both ranks, and an observation with one extra
``all_gather`` is not (the contract is tight), as the reference's
``tests/test_contracts.py`` holds its fixtures.  The cross-framework
law on the six toy-MLP strategies: the port fixture's observed calls
also pass the JAX package's ``check_counts`` under its own contract, on
a context it captures from the port's params bridged to JAX arrays over
a two-device mesh.  ``contract_coverage`` leaves only ``fsdp_offload``
(the memory planner, A12b) without a factory.
"""

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

from distributed_training_sandbox_tpu.analysis import contracts as JC
from distributed_training_sandbox_tpu_torch.analysis import fixtures as F
torch.set_num_threads(1)  # the suite's workers share the cores

REPO = Path(__file__).resolve().parent.parent
TOY = ("ddp", "ddp_bucketed", "ddp_q8", "zero1", "zero2", "zero3")

WORKER = r"""
import json, sys
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)
from distributed_training_sandbox_tpu_torch.analysis import fixtures as F
from distributed_training_sandbox_tpu_torch.models import mlp
from distributed_training_sandbox_tpu_torch.utils import mesh
work = Path(sys.argv[1])
mesh.init_process_group("cpu")
rank = mesh.axis_rank()
out = {}
for s in F.STRATEGIES:
    b = F.build_strategy(s, device="cpu")
    obs = b.observe()
    tampered = dict(obs, all_gather=obs["all_gather"] + 1)
    out[s] = {"observed": obs, "verdict": b.verdict(obs).to_dict(),
              "tampered": b.verdict(tampered).to_dict(),
              "sites": len(b.sites), "axes": sorted(b.axes),
              "device": str(b.device)}
    # a second step makes the first step's calls
    out[s]["again"] = b.observe()
gen = torch.Generator().manual_seed(F.SEED)
toy = mlp.zero_toy_mlp(gen, scale=100)
np.savez(work / "toy.npz", **{f"{i}/{k}": v.numpy()
                               for i, layer in enumerate(toy)
                               for k, v in layer.items()})
(work / f"out{rank}.json").write_text(json.dumps(out))
mesh.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, procs2):
    work = tmp_path_factory.mktemp("fixtures")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(procs2.free_port()),
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(work)], cwd=REPO,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {r} ({p.returncode}):\n{o[-3000:]}"
        for r, (p, o) in enumerate(zip(procs, outs)))
    toy = dict(np.load(work / "toy.npz"))
    layers = [{k: toy[f"{i}/{k}"] for k in ("w", "b")}
              for i in range(len(toy) // 2)]
    return [json.loads((work / f"out{r}.json").read_text())
            for r in range(2)], layers


def test_contract_coverage():
    assert F.contract_coverage() == ([], ["fsdp_offload"])
    assert F.STRATEGIES == F.registered_strategies()


def test_fsdp_offload_is_refused_by_name():
    with pytest.raises(NotImplementedError, match="A12b"):
        F.build_strategy("fsdp_offload", device="cpu")
    with pytest.raises(KeyError, match="unknown strategy"):
        F.build_strategy("nope", device="cpu")


def test_a_factory_joins_its_callers_group_and_makes_none():
    with pytest.raises(RuntimeError, match="needs a process group"):
        F.build_strategy("fsdp", device="cpu")
    if not torch.cuda.is_available():   # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            F.build_strategy("gpipe")


def test_a_name_registers_once():
    with pytest.raises(ValueError, match="already registered"):
        F.register_strategy("ddp")(lambda *a, **k: None)


@pytest.mark.parametrize("strategy", F.STRATEGIES)
def test_every_fixture_meets_its_contract(ranks, strategy):
    outs, _ = ranks
    for out in outs:
        res = out[strategy]
        assert res["verdict"]["ok"], res["verdict"]["violations"]
        assert res["verdict"]["strategy"] == strategy
        assert not res["tampered"]["ok"]
        assert any(v.startswith("all_gather:")
                   for v in res["tampered"]["violations"])
        assert res["again"] == res["observed"]
        assert res["sites"] == sum(res["observed"].values())
        assert res["device"] == "cpu"


@pytest.mark.parametrize("strategy", TOY)
def test_the_references_contracts_accept_the_ports_calls(ranks, strategy):
    outs, layers = ranks
    params = [{k: jnp.asarray(v) for k, v in layer.items()}
              for layer in layers]
    extra = ({"bucket_mb": F.FIXTURE_BUCKET_MB}
             if strategy in ("ddp_bucketed", "ddp_q8") else {})
    ctx = JC.ContractContext.capture(
        params=params, mesh=Mesh(np.array(jax.devices()[:2]), ("dp",)),
        n_layers=len(params), **extra)
    assert (ctx.ws, ctx.n_leaves) == (2, 2 * len(layers))
    for out in outs:
        verdict = JC.check_counts(JC.CONTRACTS[strategy],
                                  out[strategy]["observed"], ctx)
        assert verdict.ok, verdict.summary()
        assert verdict.to_dict() == out[strategy]["verdict"]
