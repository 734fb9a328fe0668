"""The port's resilience runtime (``resilience/``, ``utils/checkpoint.py``
over ``torch.distributed.checkpoint``) and its headline law, on the CPU.

Units: the RunState round trip is bitwise for every leaf kind the twins
hold (bf16 and f32 params, Adam moments and ``count``, ``Q8`` moments,
the EF residual, generator states); a torn or corrupted newest step
falls back to the previous one, and all steps corrupt is a readable
``CheckpointCorruptError``; a different seed, different generator states
and a different world size are refused; an async save commits through
``close``; ``parse_fault_spec`` equals the reference's on valid specs and
fails the same way on invalid ones; the injector fires once and scopes;
SIGTERM reaches ``GracefulShutdown``; the supervisor restarts, and an
exhausted budget re-raises.

The law, on two gloo ranks (one child process a rank, importing torch,
numpy and the port only): ``train.ddp`` preempted and crashed at step 5
(checkpoints every 2 steps at the pump's sync points), preempted with no
restart budget and then resumed, ``train.zero`` stage 3 preempted in its
sharded leg, ``train_fsdp`` on TINY_LM preempted at step 2 with full and
int8 Adam state; in each the stitched losses (and, for DDP and ZeRO-3,
the final params) equal the uninterrupted run's bit for bit.  The two
ranks' different shards come back each to its own rank.  The
uninterrupted DDP and ZeRO-3 losses still match the JAX steps on the
same params and batches, at ``tests/test_torch_ddp_zero.py``'s rtol
2e-4; ``flagship.run_leg`` resumes bit for bit (one child process).

The gate bites: the three resilience mutants of
``chip_gate_mutation.MUTANTS`` (the data cursor not applied on resume,
``AdamState.count`` not restored, the async save reading the live
tensors), each applied to a copy of the port, break their scenario's
bitwise resume.
"""

import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_fsdp import REPO, SPAWN_TIMEOUT_S

from distributed_training_sandbox_tpu.models import mlp as JM
from distributed_training_sandbox_tpu.parallel import ddp as JD
from distributed_training_sandbox_tpu.parallel import optim as JO
from distributed_training_sandbox_tpu.parallel import zero as JZ
from distributed_training_sandbox_tpu.resilience import faults as JF
from distributed_training_sandbox_tpu.resilience import state as JSTATE
from distributed_training_sandbox_tpu_torch import resilience as RZ
from distributed_training_sandbox_tpu_torch.models import mlp as PM
from distributed_training_sandbox_tpu_torch.parallel import optim, optim8
from distributed_training_sandbox_tpu_torch.resilience import elastic as EL
from distributed_training_sandbox_tpu_torch.train import ddp as TD
from distributed_training_sandbox_tpu_torch.train import zero as TZ
from distributed_training_sandbox_tpu_torch.utils import checkpoint as C
from distributed_training_sandbox_tpu_torch.utils.config import TrainConfig
torch.set_num_threads(1)  # the suite's workers share the cores

_spec = importlib.util.spec_from_file_location(
    "chip_gate_mutation", REPO / "chip_gate_mutation.py")
MUT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(MUT)

DDP_STEPS, ZERO_STEPS, FSDP_STEPS = 8, 6, 4
# the slow disk of the crash scenario: each DCP write starts late
SLOW_WRITE_S = 0.4

WORKER = r"""
import hashlib, json, os, sys, time
from pathlib import Path
work, which = Path(sys.argv[1]), sys.argv[2].split(",")
import torch
import torch.distributed.checkpoint as dcp
# a slow disk for the crash scenario, which resumes from an async save:
# the next step's update lands while that save's write is in flight
slow = [0.0]
_save = dcp.save
def save(*a, **k):
    time.sleep(slow[0])
    return _save(*a, **k)
dcp.save = save
from distributed_training_sandbox_tpu_torch import resilience as RZ
from distributed_training_sandbox_tpu_torch.train import (
    ddp, flagship, train_fsdp, zero)
from distributed_training_sandbox_tpu_torch.train.harness import quiet_config
from distributed_training_sandbox_tpu_torch.utils import checkpoint as C
from distributed_training_sandbox_tpu_torch.utils import mesh
mesh.init_process_group("cpu")
rank = mesh.axis_rank()
quiet = lambda *a, **k: None

def digest(tree):
    h = hashlib.sha256()
    for _, t in sorted(C.flatten(tree).items()):
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes()
                 if isinstance(t, torch.Tensor) else repr(t).encode())
    return h.hexdigest()

def cfg(tag, **kw):
    base = dict(dispatch="async", sync_every=2)
    if kw:
        base.update(checkpoint_dir=str(work / "ck" / tag),
                    checkpoint_every=2)
    base.update(kw)
    return quiet_config(**base)

out = {}
DDP = dict(scale=200, num_steps=8, batch_size=16, device="cpu", log=quiet)
ZERO = dict(scale=200, num_steps=6, batch_size=16, device="cpu", log=quiet,
            keep_params=True)
FSDP = dict(num_steps=4, seq=64, device="cpu", log=quiet)
for name in which:
    slow[0] = float(os.environ["SLOW_WRITE_S"]) if name == "ddp_crash" \
        else 0.0
    if name.startswith("ddp"):
        kw = {"ddp": {}, "ddp_preempt": dict(inject_fault="preempt@5",
                                             max_restarts=1),
              "ddp_crash": dict(inject_fault="crash@5", max_restarts=1),
              "ddp_nobudget": dict(inject_fault="preempt@5")}[name]
        r = ddp.run(config=cfg(name, **kw), **DDP)
        out[name] = {"losses": r["losses"], "status": r["status"]}
        if name == "ddp_nobudget":
            r = ddp.run(config=cfg(name, resume=True), **DDP)
            out[name + "_resumed"] = {"start": r["start_step"]}
            out[name]["losses"] = r["losses"]
        out[name]["params"] = digest(r["params"])
    elif name.startswith("zero3"):
        kw = {} if name == "zero3" else dict(
            inject_fault="preempt@3:sharded", max_restarts=1)
        r = zero.run(3, config=cfg(name, **kw), **ZERO)
        out[name] = {k: r[k] for k in ("base_losses", "shard_losses",
                                       "params_bit_equal", "status")}
        out[name]["params"] = [digest(r["base_params"]),
                               digest(r["shard_params"])]
    elif name.startswith("fsdp"):
        sp = "int8" if "int8" in name else "full"
        kw = dict(inject_fault="preempt@2", max_restarts=1) \
            if name.endswith("preempt") else {}
        r = train_fsdp.run("tiny", state_precision=sp,
                           config=cfg(name, **kw), **FSDP)
        out[name] = {"losses": r["losses"], "status": r["status"],
                     "start": r["start_step"]}
    elif name == "shards":
        # each rank's own values under the same path; torn newest step
        # on rank 1 only: both ranks must fall back together
        ck = RZ.Checkpointer(work / "shards")
        for step in (0, 1):
            ck.save(RZ.RunState(
                params={"w": torch.full((3,), 10.0 * step + rank)},
                step=step, loss_log=[float(rank)]), wait=False)
        ck.close()
        if rank == 1:
            for p in (work / "shards" / "1" / "r1").iterdir():
                p.write_bytes(p.read_bytes()[:8])
        torch.distributed.barrier()
        got = RZ.Checkpointer(work / "shards").restore_latest(
            RZ.RunState(params={"w": torch.zeros(3)}))
        out[name] = {"w": got.params["w"].tolist(), "step": got.step}
mesh.destroy_process_group()
if "flagship" in which and rank == 0:
    # one process, no group: run_leg crashed after step 3, then resumed
    args = ("tiny", "bf16", 32, 2, 5, 0, 1e-2)
    whole = flagship.run_leg(*args, device="cpu")
    def crash_at_3(i, loss):
        if i == 3:
            raise RuntimeError("lost the host")
    ck = work / "ck" / "flagship"
    try:
        flagship.run_leg(*args, device="cpu", ckpt_dir=ck, ckpt_every=2,
                         on_step=crash_at_3)
    except RuntimeError as e:
        crashed = str(e)
    part = flagship.run_leg(*args, device="cpu", ckpt_dir=ck,
                            ckpt_every=2, resume=True)
    out["flagship"] = {"crashed": crashed, "start": part["start_step"],
                       "equal": part["losses"] == whole["losses"]
                       and part["lrs"] == whole["lrs"]}
(work / f"out{rank}.json").write_text(json.dumps(out))
"""


def _spawn(work, which, port, cwd=REPO):
    """The worker on two gloo ranks, run from ``cwd`` (a mutated copy of
    the port or the repo); returns rank 0's results."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(cwd), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", SLOW_WRITE_S=str(SLOW_WRITE_S))
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(work), ",".join(which)], cwd=cwd,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {r} ({p.returncode}):\n{out[-3000:]}"
        for r, (p, out) in enumerate(zip(procs, outs)))
    res = [json.loads((work / f"out{r}.json").read_text()) for r in (0, 1)]
    return res


LAW = ["ddp", "ddp_preempt", "ddp_crash", "ddp_nobudget", "zero3",
       "zero3_preempt", "fsdp_full", "fsdp_full_preempt", "fsdp_int8",
       "fsdp_int8_preempt", "shards", "flagship"]


@pytest.fixture(scope="module")
def law(procs2, tmp_path_factory):
    work = tmp_path_factory.mktemp("law")
    return _spawn(work, LAW, procs2.free_port())


def test_ddp_preempt_and_crash_resume_bitwise(law):
    for rank in law:
        base = rank["ddp"]
        assert len(base["losses"]) == DDP_STEPS
        for name in ("ddp_preempt", "ddp_crash"):
            assert rank[name]["status"] == "completed"
            assert rank[name]["losses"] == base["losses"], name
            assert rank[name]["params"] == base["params"], name


def test_preempt_without_budget_then_resume_bitwise(law):
    for rank in law:
        assert rank["ddp_nobudget_resumed"]["start"] == 5
        assert rank["ddp_nobudget"]["status"] == "preempted"
        assert rank["ddp_nobudget"]["losses"] == rank["ddp"]["losses"]
        assert rank["ddp_nobudget"]["params"] == rank["ddp"]["params"]


def test_zero3_preempt_in_the_sharded_leg_resumes_bitwise(law):
    for rank in law:
        base, cut = rank["zero3"], rank["zero3_preempt"]
        assert len(base["shard_losses"]) == ZERO_STEPS
        assert cut["status"] == "completed"
        for k in ("base_losses", "shard_losses", "params"):
            assert cut[k] == base[k], k
        assert cut["params_bit_equal"] == base["params_bit_equal"]


@pytest.mark.parametrize("state", ["full", "int8"])
def test_fsdp_preempt_resumes_bitwise(law, state):
    for rank in law:
        base = rank[f"fsdp_{state}"]
        cut = rank[f"fsdp_{state}_preempt"]
        assert len(base["losses"]) == FSDP_STEPS and base["start"] == 0
        assert cut["start"] == 2 and cut["status"] == "completed"
        assert cut["losses"] == base["losses"]
    assert law[0]["fsdp_full"]["losses"] != law[0]["fsdp_int8"]["losses"]


def test_two_ranks_get_their_own_shards_back(law):
    for rank, res in enumerate(law):
        # rank 1's step 1 is torn: both ranks restore step 0, each its own
        assert res["shards"] == {"w": [float(rank)] * 3, "step": 0}


def _mesh(n=2):
    return Mesh(np.array(jax.devices()[:n]), ("dp",))


def test_uninterrupted_ddp_matches_the_jax_step(law):
    params = PM.zero_toy_mlp(torch.Generator().manual_seed(42), scale=200,
                             device="cpu")
    jparams = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
               for layer in params]
    step = JD.make_ddp_train_step(
        JM.mse_loss, lambda g, s, p: JO.sgd_update(g, s, p, lr=TD.LR),
        _mesh(), "dp", donate=False)
    state, losses = JO.sgd_init(jparams), []
    for i, (x, y) in zip(range(DDP_STEPS),
                         TD.randn_batches(50, 16, 42, "cpu")):
        jparams, state, loss = step(jparams, state, (jnp.asarray(x.numpy()),
                                                     jnp.asarray(y.numpy())))
        losses.append(float(loss))
    np.testing.assert_allclose(law[0]["ddp"]["losses"], losses, rtol=2e-4)


def test_uninterrupted_zero3_matches_the_jax_step(law):
    init_params, (x, y) = TZ.toy_problem(200, 16, 42, "cpu")
    params = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
              for layer in init_params()]
    mesh = _mesh()
    shapes = [{k: v.shape for k, v in layer.items()} for layer in params]
    state = JZ.init_zero_opt_state(params, mesh, "dp")
    chunks = JZ.shard_params_zero3(params, mesh, "dp")
    step = JZ.make_zero3_train_step(JZ.make_zero3_mlp_loss(shapes, "dp"),
                                    mesh, "dp", donate=False)
    batch, losses = (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())), []
    for _ in range(ZERO_STEPS):
        chunks, state, loss = step(chunks, state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(law[0]["zero3"]["shard_losses"], losses,
                               rtol=2e-4)


# ------------------------------------------------------- the mutants

RESILIENCE_MUTANTS = {m[0]: m for m in MUT.MUTANTS if m[4] == "resilience"}
# mutant: (the scenario it must break, the run it is held to); the sound
# port keeps the law in each (``law``), the crash one on a slow disk too
MUTANT_SCENARIOS = {
    "resume_cursor_skipped": ("ddp_preempt", "ddp"),
    "adam_count_not_restored": ("fsdp_full_preempt", "fsdp_full"),
    "ckpt_live_tensors": ("ddp_crash", "ddp"),
}


def test_the_resilience_mutants_are_the_ones_tested():
    assert set(RESILIENCE_MUTANTS) == set(MUTANT_SCENARIOS)


@pytest.mark.parametrize("name", sorted(MUTANT_SCENARIOS))
def test_each_mutant_breaks_the_bitwise_resume(name, law, procs2,
                                               tmp_path):
    _, source, sound, mutated, _, _ = RESILIENCE_MUTANTS[name]
    scenario, held_to = MUTANT_SCENARIOS[name]
    copy = tmp_path / "port"
    shutil.copytree(REPO / MUT.PKG, copy / MUT.PKG,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = copy / MUT.PKG / source
    text = path.read_text()
    assert text.count(sound + "\n") == 1
    path.write_text(text.replace(sound + "\n", mutated + "\n"))
    work = tmp_path / "work"
    work.mkdir()
    got = _spawn(work, [scenario], procs2.free_port(), cwd=copy)
    assert got[0][scenario]["status"] == "completed"
    assert got[0][scenario]["losses"] != law[0][held_to]["losses"]
    assert law[0][scenario]["losses"] == law[0][held_to]["losses"]


# -------------------------------------------------------------- units

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"wq": torch.randn(4, 6, generator=g).to(torch.bfloat16),
              "norm": torch.randn(6, generator=g)}
    adam = optim.AdamState(mu=optim.tree_map(torch.randn_like, params),
                           nu=optim.tree_map(torch.rand_like, params),
                           count=7)
    q8 = optim8.adam8_init({"w": torch.randn(3, 5, generator=g),
                            "b": torch.randn(5, generator=g)})
    q8 = q8._replace(mu={"w": q8.mu["w"]._replace(
        q=torch.randint(-127, 128, (3, 5), dtype=torch.int8, generator=g),
        scale=torch.rand(3, 1, generator=g)), "b": q8.mu["b"]}, count=3)
    residual = {"wq": torch.randn(4, 6, generator=g)}
    opt = (adam, q8, residual, optim.sgd_init(params))
    key = RZ.generator_states({"params": 42, "data": 43})
    return params, opt, key


def _fresh_like(seed=1):
    params, opt, key = _state(seed)
    adam, q8, residual, sgd = opt
    zero = lambda t: torch.zeros_like(t)
    like_opt = (optim.AdamState(optim.tree_map(zero, adam.mu),
                                optim.tree_map(zero, adam.nu), 0),
                optim8.adam8_init({"w": torch.zeros(3, 5),
                                   "b": torch.zeros(5)}),
                optim.tree_map(zero, residual), sgd)
    return RZ.RunState(params=optim.tree_map(zero, params),
                       opt_state=like_opt, prng_key=key)


def _equal(a, b):
    fa, fb = C.flatten(a), C.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_runstate_round_trip_is_bitwise_for_every_leaf_kind(tmp_path):
    params, opt, key = _state()
    ck = RZ.Checkpointer(tmp_path, fingerprint={"seed": 42})
    ck.save(RZ.RunState(params=params, opt_state=opt, step=4,
                        data_cursor=5, prng_key=key,
                        loss_log=[0.1, 1 / 3]), wait=True)
    got = RZ.Checkpointer(tmp_path, fingerprint={"seed": 42}) \
        .restore_latest(_fresh_like())
    _equal(got.params, params)
    _equal(got.opt_state, opt)
    _equal(got.prng_key, key)
    assert isinstance(got.opt_state[0], optim.AdamState)
    assert isinstance(got.opt_state[1].mu["w"], optim8.Q8)
    assert (got.step, got.data_cursor, got.loss_log) == (4, 5, [0.1, 1 / 3])
    assert ck.saves[0]["bytes"] == sum(
        t.numel() * t.element_size() for t in C.flatten(
            {"p": params, "o": opt, "k": key}).values()
        if isinstance(t, torch.Tensor))


def test_sidecar_keys_are_the_references(tmp_path):
    rs = RZ.RunState(params={"w": torch.ones(2)}, step=0)
    RZ.Checkpointer(tmp_path).save(rs, wait=True)
    ours = json.loads((tmp_path / "runstate-0.json").read_text())
    (tmp_path / "jax").mkdir()
    JSTATE._write_meta(str(tmp_path / "jax"),
                       JSTATE.RunState(params=None, step=0), {})
    theirs = json.loads((tmp_path / "jax" / "runstate-0.json").read_text())
    assert list(ours) == list(theirs)
    assert ours["fingerprint"]["world_size"] == 1


def _three_steps(tmp_path):
    ck = RZ.Checkpointer(tmp_path, keep=5)
    for step in range(3):
        ck.save(RZ.RunState(params={"w": torch.full((64,), float(step))},
                            step=step, loss_log=[0.0] * (step + 1)),
                wait=False)
    ck.close()
    return lambda: RZ.Checkpointer(tmp_path).restore_latest(
        RZ.RunState(params={"w": torch.zeros(64)}))


@pytest.mark.parametrize("tamper", [RZ.truncate_checkpoint,
                                    RZ.corrupt_checkpoint])
def test_torn_newest_step_falls_back_and_all_torn_fails_readably(
        tmp_path, tamper, capsys):
    restore = _three_steps(tmp_path)
    tamper(tmp_path, 2)
    got = restore()
    assert got.step == 1 and torch.equal(got.params["w"],
                                         torch.full((64,), 1.0))
    assert "step 2" in capsys.readouterr().out
    for step in (0, 1):
        tamper(tmp_path, step)
    with pytest.raises(RZ.CheckpointCorruptError,
                       match="failed to restore step 0 .* torn or "
                             "corrupted"):
        restore()


def test_different_seed_generators_and_world_are_refused(tmp_path):
    params, opt, key = _state()
    RZ.Checkpointer(tmp_path, fingerprint={"seed": 42}).save(RZ.RunState(
        params=params, opt_state=opt, step=0, prng_key=key), wait=True)
    with pytest.raises(SystemExit, match="seed=42, this run has seed=7"):
        RZ.Checkpointer(tmp_path, fingerprint={"seed": 7}).restore_latest(
            _fresh_like())
    like = _fresh_like()
    like.prng_key = RZ.generator_states({"params": 1, "data": 43})
    with pytest.raises(SystemExit, match="generator states differ"):
        RZ.Checkpointer(tmp_path).restore_latest(like)
    side = tmp_path / "runstate-0.json"
    meta = json.loads(side.read_text())
    meta["fingerprint"]["world_size"] = 2
    side.write_text(json.dumps(meta))
    with pytest.raises(SystemExit, match="written by 2 ranks.*A12"):
        RZ.Checkpointer(tmp_path).restore_latest(_fresh_like())


def test_async_save_snapshots_then_commits_through_close(tmp_path):
    w = torch.arange(1000.0)
    ck = RZ.Checkpointer(tmp_path)
    ck.save(RZ.RunState(params={"w": w}, step=0), wait=False)
    w.add_(1)                  # the next step's in-place update
    ck.close()
    assert (tmp_path / "0" / "r0" / ".metadata").is_file()
    assert ck.saves[0]["write_s"] is not None
    got = RZ.Checkpointer(tmp_path).restore_latest(
        RZ.RunState(params={"w": torch.zeros(1000)}))
    assert torch.equal(got.params["w"], torch.arange(1000.0))


SPECS = ["crash@5", "preempt@8:sharded", "kill_worker@5:3", "hang@4",
         "slow@3:50", "kill_replica@2:1", "hang_decode@2:0",
         "slow_replica@1:80", "corrupt_swap", " crash@0 ", None, ""]
BAD_SPECS = ["explode@3", "crash", "slow@3:abc", "crash@x", "preempt@2:a:b",
             "kill_worker@1:r1"]


def test_parse_fault_spec_equals_the_reference():
    for spec in SPECS:
        got, want = RZ.parse_fault_spec(spec), JF.parse_fault_spec(spec)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.kind, got.step, got.target, str(got)) \
                == (want.kind, want.step, want.target, str(want))
    for spec in BAD_SPECS:
        with pytest.raises(SystemExit) as p:
            RZ.parse_fault_spec(spec)
        with pytest.raises(SystemExit) as j:
            JF.parse_fault_spec(spec)
        assert str(p.value) == str(j.value)


def test_injector_fires_once_scopes_and_refuses_unported_kinds():
    inj = RZ.FaultInjector(RZ.parse_fault_spec("crash@2:legB"))
    inj.check(2, scope="legA")          # wrong scope: no fire
    inj.check(1, scope="legB")          # wrong step: no fire
    with pytest.raises(RZ.InjectedCrash, match="step 2 \\(legB\\)"):
        inj.check(2, scope="legB")
    inj.check(2, scope="legB")          # one-shot
    with pytest.raises(NotImplementedError, match="A12"):
        RZ.FaultInjector(RZ.parse_fault_spec("kill_worker@1:0"))
    # the serving kinds are the fleet's: a loop step never fires them
    inj = RZ.FaultInjector(RZ.parse_fault_spec("kill_replica@2:1"))
    inj.check(2)
    inj.check_serving(0, 2)             # wrong replica: no fire
    inj.check_serving(1, 1)             # wrong burst: no fire
    with pytest.raises(EL.WorkerLost, match="kill_replica"):
        inj.check_serving(1, 2)
    inj.check_serving(1, 2)             # one-shot
    swap = RZ.FaultInjector(RZ.parse_fault_spec("corrupt_swap"))
    assert swap.wants_corrupt_swap() and not swap.wants_corrupt_swap()
    with pytest.raises(NotImplementedError, match="A12"):
        EL.shrink_plan(8, [1])
    with pytest.raises(NotImplementedError, match="A12"):
        EL.ElasticSupervisor()
    with pytest.raises(NotImplementedError, match="A12"):
        RZ.Supervisor.from_config(TrainConfig(elastic=True), "ddp")


def test_graceful_shutdown_handles_sigterm():
    with RZ.GracefulShutdown() as sd:
        assert not sd.requested
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if sd.requested:
                break
        assert sd.requested
    assert signal.getsignal(signal.SIGTERM) is not sd.trigger


def test_supervisor_restarts_after_crash():
    attempts = []
    sup = RZ.Supervisor(max_restarts=2, fault="crash@0", backoff_s=0.0)

    def leg(ctx):
        attempts.append((ctx.attempt, ctx.resume))
        if ctx.attempt == 0:
            ctx.should_stop(0)
        return "done"

    assert sup.run(leg) == "done"
    assert attempts == [(0, False), (1, True)]
    assert sup.segments[0]["status"] == "crashed"


def test_supervisor_exhausted_budget_reraises():
    sup = RZ.Supervisor(max_restarts=0, fault="crash@0", backoff_s=0.0)
    with pytest.raises(RZ.InjectedCrash):
        sup.run(lambda ctx: ctx.should_stop(0))


def test_flagship_run_leg_resumes_bitwise(law):
    """``run_leg`` with ``ckpt_every`` 2, its host lost after step 3,
    then ``resume``: it starts at step 4, and the losses and the lr
    series equal an uninterrupted run's."""
    assert law[0]["flagship"] == {"crashed": "lost the host", "start": 4,
                                  "equal": True}


def test_the_new_modules_import_without_jax():
    code = r"""
import sys
sys.modules["jax"] = None
import distributed_training_sandbox_tpu_torch.resilience
import distributed_training_sandbox_tpu_torch.telemetry
import distributed_training_sandbox_tpu_torch.runtime
import distributed_training_sandbox_tpu_torch.train.harness
for m in ("checkpoint", "config", "memory", "profiling", "tracker"):
    __import__(f"distributed_training_sandbox_tpu_torch.utils.{m}")
assert not any(k == "distributed_training_sandbox_tpu"
               or k.startswith("distributed_training_sandbox_tpu.")
               for k in sys.modules)
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={**os.environ, "PYTHONPATH": str(REPO)})


def test_checkpoint_surface_round_trips(tmp_path, capsys):
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    with C.closing(C.checkpoint_manager(tmp_path, max_to_keep=2)) as mgr:
        for step in (3, 7, 9):
            C.save_state(mgr, step, {"params": params}, wait=False)
    assert C.latest_step(mgr) == 9 and mgr.all_steps() == [7, 9]
    got = C.restore_state(mgr, like={"params": {"w": torch.zeros(2, 3)}},
                          step=7)
    assert torch.equal(got["params"]["w"], params["w"])
    restored, step = C.restore_params(tmp_path, {"w": torch.zeros(2, 3)},
                                      tag="eval")
    assert step == 9 and torch.equal(restored["w"], params["w"])
    assert f"[eval] restored step 9 from {tmp_path}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no checkpoint steps"):
        C.restore_params(tmp_path / "empty", {"w": torch.zeros(2, 3)})
