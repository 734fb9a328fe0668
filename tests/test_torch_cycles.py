"""The port's runs free their tensors when they end, without a garbage
collection: nothing a finished run leaves behind sits in a reference
cycle.  A cycle would hold the run's params, optimizer state and batches
(on the card: its device memory) until the collector's next full pass,
which a program that allocates few Python objects may not reach for
many runs.  The harness's resilience context once kept the training
loop's state closure, and through it the loop's locals and the context
itself, alive in such a cycle after every run.

One child process (torch, numpy and the port only; one gloo rank) runs
each case of ``CASES`` at a toy size with the collector off, drops the
result, then collects with ``gc.DEBUG_SAVEALL`` and reports the tensors
the cycles held.  ``torch._dynamo`` is imported first: its first import
inside a call (``torch.utils.checkpoint`` imports it lazily) keeps that
call's frames in a cycle, once a process, which is PyTorch's and not
the port's.  So are the references between ``fully_shard``'s module,
its FSDP state and its parameters (FSDP2's design): ``train_fsdp.run``
collects them as an auto run ends, which the ``fsdp_auto`` case holds.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores

ROOT = Path(__file__).resolve().parents[1]

CASES = ("ddp", "ddp_classification", "ddp_preempted", "zero1", "zero3",
         "fsdp", "fsdp_auto", "flagship", "moe", "engine",
         "engine_prefix_cache", "engine_disaggregated", "fleet",
         "fleet_replica_killed")

CHILD = r"""
import collections, contextlib, gc, io, json, sys, tempfile
import numpy as np
import torch
import torch._dynamo  # noqa: F401
torch.set_num_threads(1)
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.serving import Fleet
from distributed_training_sandbox_tpu_torch.serving import engine as E
from distributed_training_sandbox_tpu_torch.train import (
    ddp, flagship, moe, serve_bench, train_fsdp, zero)
from distributed_training_sandbox_tpu_torch.train.harness import (
    quiet_config)
from distributed_training_sandbox_tpu_torch.utils import mesh

cpu = dict(device="cpu")
ENG = dict(max_batch=4, page_size=8, max_seq_len=128, prefill_chunk=16)
params = serve_bench.build_params(T.TINY_LM, 0, 3.0, "cpu")
prompts = [np.random.default_rng(0).integers(1, 256, size=n)
           for n in (9, 17, 23)]


def serve(server):
    for p in prompts:
        server.submit(p, max_new_tokens=6)
    server.run()
    return server


def preempted():
    # preempted at step 3, resumed from the step-2 save by the supervisor
    with tempfile.TemporaryDirectory() as root:
        return ddp.run(scale=200, num_steps=6, device="cpu",
                       config=quiet_config(
                           telemetry=True, results_dir=f"{root}/runs",
                           trace_dir=f"{root}/tr",
                           checkpoint_dir=f"{root}/ck", checkpoint_every=2,
                           inject_fault="preempt@3", max_restarts=1))


RUNS = {
    "ddp": lambda: ddp.run(scale=200, num_steps=3, **cpu),
    "ddp_classification": lambda: ddp.run(model="tiny", num_steps=2,
                                          batch_size=4, **cpu),
    "ddp_preempted": preempted,
    "zero1": lambda: zero.run(1, scale=200, num_steps=3,
                              log=lambda *a: None, **cpu),
    "zero3": lambda: zero.run(3, scale=200, num_steps=3,
                              log=lambda *a: None, **cpu),
    "fsdp": lambda: train_fsdp.run("tiny", num_steps=2, batch_size=2,
                                   seq=32, **cpu),
    "fsdp_auto": lambda: train_fsdp.run("tiny", num_steps=2, batch_size=2,
                                        seq=32, variant="auto", **cpu),
    "flagship": lambda: flagship.run_leg("tiny", "bf16", 32, 2, 2, 0,
                                         1e-3, **cpu),
    "moe": lambda: moe.run("tiny", num_steps=2, batch_size=2, seq=32,
                           **cpu),
    "engine": lambda: serve(E.ServingEngine(params, T.TINY_LM, **cpu,
                                            **ENG)),
    "engine_prefix_cache": lambda: serve(E.ServingEngine(
        params, T.TINY_LM, prefix_cache=True, **cpu, **ENG)),
    "engine_disaggregated": lambda: serve(E.ServingEngine(
        params, T.TINY_LM, disaggregate=True, device=("cpu", "cpu"),
        **ENG)),
    "fleet": lambda: serve(Fleet(params, T.TINY_LM, replicas=2, **cpu,
                                 **ENG)),
    "fleet_replica_killed": lambda: serve(Fleet(
        params, T.TINY_LM, replicas=2, watchdog_timeout_s=0.0,
        fault="kill_replica@1:1", **cpu, **ENG)),
}

mesh.init_process_group("cpu")
out = {}
for name in sys.argv[1:]:
    gc.collect()
    gc.disable()
    with contextlib.redirect_stdout(io.StringIO()):
        res = RUNS[name]()
    del res
    gc.set_debug(gc.DEBUG_SAVEALL)
    gc.collect()
    held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    kinds = collections.Counter(
        type(o).__name__ for o in gc.garbage
        if type(o).__module__.startswith("distributed_training"))
    out[name] = {"tensors": len(held),
                 "bytes": sum(t.numel() * t.element_size() for t in held),
                 "port_objects": dict(kinds)}
    del held
    gc.garbage.clear()
    gc.set_debug(0)
    gc.collect()
    gc.enable()
mesh.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def held():
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT)}
    run = subprocess.run([sys.executable, "-c", CHILD, *CASES], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert run.returncode == 0 and lines, run.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.mark.parametrize("case", CASES)
def test_finished_run_holds_no_tensor_in_a_cycle(held, case):
    got = held[case]
    assert got["tensors"] == 0, (
        f"{case}: {got['tensors']} tensors ({got['bytes']} bytes) held by "
        f"reference cycles after the run ended; the port's objects in "
        f"them: {got['port_objects']}")
