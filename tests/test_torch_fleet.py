"""The port's serving fleet (``serving/fleet.py``) against the JAX
reference's ``Fleet``, on the CPU, on the gather path.

Weights: TINY_LM in f32, the reference's ``init_params`` scaled ×3
(chaotic greedy trajectories, so a one-ulp drift or the wrong weights
flip a continuation), bridged leaf for leaf into the port.  Every trace
arrives at virtual time 0, so dispatch, bursts, kills and swaps happen
at the same points on both sides whatever either side's wall clock
does; the events are compared without their wall-clock stamps.

* ``kill_replica`` failover and ``hang_decode`` under the watchdog: zero
  drops, the same ``replica_dead`` events and per-replica counts as the
  JAX fleet, every request's tokens bit-equal to the JAX fleet's and to
  the port's one-shot ``generate`` (replay discards partial progress);
* overload: the shed set (rid, reason, every ``Rejection`` field) equal
  to the JAX fleet's, every admitted request completed;
* hot-swap from a checkpoint of the same bridged new weights on both
  sides (the port's ``Checkpointer``, the reference's): zero drops,
  tokens equal to the JAX fleet's, both weight sets served, each
  request wholly on the old or wholly on the new weights;
* ``corrupt_swap``: the fleet keeps the old weights, the reference's
  warning;
* the report's keys are the reference's but the recompile watch, and
  ``train.serve_bench --replicas 2`` (with a kill) exits 0 on the CPU.
"""

import time

import jax
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.resilience.state import (
    Checkpointer as JCheckpointer, RunState as JRunState)
from distributed_training_sandbox_tpu.serving import Fleet as JFleet
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.models.generate import generate
from distributed_training_sandbox_tpu_torch.resilience.state import (
    Checkpointer, RunState)
from distributed_training_sandbox_tpu_torch.serving import (
    Fleet, Rejection, Request)
from distributed_training_sandbox_tpu_torch.train import serve_bench
torch.set_num_threads(1)  # the suite's workers share the cores

ENG = dict(max_batch=2, page_size=8, max_seq_len=32, prefill_chunk=8,
           sync_every=2)
NEW = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """TINY_LM's ops are too small to gain from intra-op threads; the
    suite's workers share the cores, so the module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed):
    jp = JT.init_params(jax.random.PRNGKey(seed), JT.TINY_LM)
    jp = jax.tree.map(lambda x: (x * 3.0).astype(x.dtype), jp)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      PT.TINY_LM)


@pytest.fixture(scope="module")
def old():
    return _weights(0)


def _trace(n, seed, plen=5):
    """The reference suite's trace, every arrival at virtual time 0."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, PT.TINY_LM.vocab_size, size=plen)
               .astype(np.int32) for _ in range(n)]
    return [(p, 0.0) for p in prompts]


def _fleets(params_pair, trace, **kw):
    """(JAX fleet, port fleet) after submitting ``trace`` to each, and
    their submit results."""
    jp, pp = params_pair
    fj = JFleet(jp, JT.TINY_LM, **kw, **ENG)
    fp = Fleet(pp, PT.TINY_LM, device="cpu", **kw, **ENG)
    out = []
    for fleet in (fj, fp):
        out.append([fleet.submit(p, max_new_tokens=NEW, arrival_s=t,
                                 deadline_s=kw.get("deadline_s"))
                    for p, t in trace])
    return fj, fp, out[0], out[1]


def _events(fleet):
    return [{k: v for k, v in e.items() if k != "t_s"}
            for e in fleet.events]


def _per_replica(fleet):
    return [(b["replica"], b["state"], b["death"], b["bursts"],
             b["requests"], b["completed"])
            for b in fleet.slo_report()["replica_slo"]]


def _generate(pp, prompt, capacity):
    return generate(pp, prompt[None], PT.TINY_LM, max_new_tokens=NEW,
                    cache_capacity=capacity, device="cpu")[0].numpy()


def _same_tokens(jreqs, preqs):
    for j, p in zip(jreqs, preqs):
        assert j.rid == p.rid
        assert list(j.tokens) == list(p.tokens), (j.rid, j.tokens,
                                                  p.tokens)


@pytest.mark.parametrize("fault,trigger,victim,wd", [
    ("kill_replica@1:1", "WorkerLost", 1, 0.0),
    ("hang_decode@1:0", "StepTimeoutError", 0, 0.5),
], ids=["kill", "hang"])
def test_failover_replays_as_the_jax_fleet(old, tmp_path, fault, trigger,
                                           victim, wd):
    fj, fp, jreqs, preqs = _fleets(
        old, _trace(10, seed=3), replicas=2, watchdog_timeout_s=wd,
        fault=fault, max_queue=16, heartbeat_dir=None)
    fj.run()
    t0 = time.perf_counter()
    done = fp.run()
    assert time.perf_counter() - t0 < 60.0          # the hang is bounded
    assert len(done) == 10 and fp.dropped() == []
    ev = [e for e in _events(fp) if e["event"] == "replica_dead"]
    assert len(ev) == 1 and ev[0]["replica"] == victim
    assert ev[0]["trigger"] == trigger and ev[0]["requeued"] >= 1
    assert _events(fp) == _events(fj)
    assert _per_replica(fp) == _per_replica(fj)
    assert fp.replicas[victim].death == trigger
    _same_tokens(jreqs, preqs)
    for r in preqs:
        assert (np.asarray(r.tokens) == _generate(
            old[1], r.prompt, fp.view_capacity)).all(), r.rid
    survivor = fp.replicas[1 - victim].engine
    assert survivor.pool.allocator.free_pages == survivor.n_pages - 1
    slo = fp.slo_report()
    assert slo["completed"] == 10 and slo["dropped"] == 0
    assert slo["live"] == 1


def test_heartbeat_breadcrumbs_as_the_reference(old, tmp_path):
    """A killed replica leaves the reference's ``.dead`` reason and each
    replica's last beat is its burst count."""
    import json
    from distributed_training_sandbox_tpu_torch.resilience import (
        read_heartbeats)
    fp = Fleet(old[1], PT.TINY_LM, replicas=2, watchdog_timeout_s=0.0,
               fault="kill_replica@1:1", heartbeat_dir=tmp_path / "hb",
               device="cpu", **ENG)
    for p, t in _trace(6, seed=4):
        fp.submit(p, max_new_tokens=NEW, arrival_s=t)
    fp.run()
    dead = json.loads((tmp_path / "hb" / "worker_1.dead").read_text())
    assert dead["reason"] == "WorkerLost@burst1"
    beats = read_heartbeats(tmp_path / "hb")
    assert beats[0]["step"] == fp.replicas[0].bursts
    assert beats[1]["step"] == 1


def test_overload_sheds_the_jax_fleets_set(old):
    kw = dict(replicas=1, watchdog_timeout_s=0.0, max_queue=2,
              burst_s_prior=0.05, calibrate_admission=False,
              deadline_s=0.25)
    fj, fp, jout, pout = _fleets(old, _trace(24, seed=11), **kw)
    shed = [r.as_dict() for r in pout if isinstance(r, Rejection)]
    assert shed == [r.as_dict() for r in jout if not hasattr(r, "tokens")]
    assert shed and {r["reason"] for r in shed} <= {"queue_full",
                                                     "deadline"}
    admitted = [r for r in pout if isinstance(r, Request)]
    fj.run()
    assert len(fp.run()) == len(admitted) and fp.dropped() == []
    _same_tokens([r for r in jout if hasattr(r, "tokens")], admitted)
    slo, jslo = fp.slo_report(), fj.slo_report()
    assert slo["admission"] == jslo["admission"]
    assert slo["rejections"] == jslo["rejections"]
    assert slo["shed"] == len(shed) and slo["submitted"] + slo["shed"] == 24


def _save_new(tmp_path, seed):
    """The same bridged new weights saved by each side's Checkpointer."""
    jn, pn = _weights(seed)
    ck = JCheckpointer(tmp_path / "jswap")
    ck.save(JRunState(params=jn, step=0), wait=True)
    ck.close()
    ck = Checkpointer(tmp_path / "pswap")
    ck.save(RunState(params=pn, step=0), wait=True)
    ck.close()
    return pn


def test_hot_swap_as_the_jax_fleet(old, tmp_path):
    pn = _save_new(tmp_path, 7)
    fj, fp, jreqs, preqs = _fleets(old, _trace(12, seed=13), replicas=2,
                                   watchdog_timeout_s=0.0, max_queue=32)
    fj.schedule_swap(tmp_path / "jswap", after_completed=4)
    fp.schedule_swap(tmp_path / "pswap", after_completed=4)
    fj.run()
    assert len(fp.run()) == 12 and fp.dropped() == []
    names = [e["event"] for e in fp.events]
    assert names.count("swap_replica") == 2
    assert names.index("swap_started") < names.index("swap_complete")
    assert all(r.state == "live" for r in fp.replicas)
    assert _events(fp) == _events(fj)
    _same_tokens(jreqs, preqs)
    n_old = n_new = 0
    for r in preqs:
        got = np.asarray(r.tokens)
        m_old = (got == _generate(old[1], r.prompt, fp.view_capacity)).all()
        m_new = (got == _generate(pn, r.prompt, fp.view_capacity)).all()
        assert m_old or m_new, r.rid
        n_old += bool(m_old and not m_new)
        n_new += bool(m_new and not m_old)
    assert n_old >= 1 and n_new >= 1, (n_old, n_new)
    # the swap's restore came back whole: every leaf the new weights'
    for rep in fp.replicas:
        got = rep.engine._params["layers"]["wq"]
        assert torch.equal(got, pn["layers"]["wq"])


def test_corrupt_swap_keeps_the_old_weights(old, tmp_path, capfd):
    _save_new(tmp_path, 9)
    fp = Fleet(old[1], PT.TINY_LM, replicas=2, watchdog_timeout_s=0.0,
               fault="corrupt_swap", max_queue=32, device="cpu", **ENG)
    reqs = [fp.submit(p, max_new_tokens=NEW, arrival_s=t)
            for p, t in _trace(8, seed=17)]
    fp.schedule_swap(tmp_path / "pswap", after_completed=3)
    assert len(fp.run()) == 8 and fp.dropped() == []
    names = [e["event"] for e in fp.events]
    assert "swap_fault_injected" in names and "swap_failed" in names
    assert "swap_replica" not in names
    assert "fleet keeps serving on the previous weights" in \
        capfd.readouterr().err
    for r in reqs:
        assert (np.asarray(r.tokens) == _generate(
            old[1], r.prompt, fp.view_capacity)).all(), r.rid


def test_fleet_report_has_the_reference_keys(old):
    """The fleet block's keys (and each replica block's) are the
    reference's but its recompile watch; ``chip_smoke.FLEET_KEYS``, what
    phase 19g checks on the card, is that list."""
    import chip_smoke
    fj, fp, _, _ = _fleets(old, _trace(4, seed=2), replicas=2,
                           watchdog_timeout_s=0.0)
    fj.run()
    fp.run()
    js, ps = fj.slo_report(), fp.slo_report()
    drop = "recompiles_after_warmup"
    assert set(ps) == set(js) - {drop}
    assert set(ps["replica_slo"][0]) == set(js["replica_slo"][0]) - {drop}
    want = {k: sorted(js[k]) if isinstance(js[k], dict) else None
            for k in js if k != drop}
    assert chip_smoke.FLEET_KEYS == want


def test_refusals_and_devices(old, monkeypatch):
    _, pp = old
    with pytest.raises(ValueError, match="need >= 1 replica"):
        Fleet(pp, PT.TINY_LM, replicas=0, device="cpu", **ENG)
    with pytest.raises(ValueError, match="3 replicas need 3 devices"):
        Fleet(pp, PT.TINY_LM, replicas=3, device=["cpu", "cpu"], **ENG)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Fleet(pp, PT.TINY_LM, replicas=2, **ENG)
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 replicas need >= 2 "
                                             "devices, have 1"):
            Fleet(pp, PT.TINY_LM, replicas=2, **ENG)
    f = Fleet(pp, PT.TINY_LM, replicas=2, device=["cpu", "cpu"], **ENG)
    with pytest.raises(ValueError, match="view capacity"):
        f.submit(np.ones(30, np.int32), max_new_tokens=5)
    f = Fleet(pp, PT.TINY_LM, replicas=2, device="cpu",
              fault="hang_decode@0:0", watchdog_timeout_s=0.0, **ENG)
    f.submit(np.ones(4, np.int32), max_new_tokens=3)
    with pytest.raises(SystemExit, match="needs a decode watchdog"):
        f.run()


@pytest.mark.parametrize("flags", [
    [], ["--inject-fault", "kill_replica@2:1"],
    ["--swap-at", "3", "--inject-fault", "corrupt_swap"]],
    ids=["plain", "kill", "corrupt-swap"])
def test_serve_bench_fleet_gate(tmp_path, flags):
    rc = serve_bench.main(["--device", "cpu", "--replicas", "2",
                           "--requests", "8", "--check-parity", "2",
                           "--max-batch", "2", "--sync-every", "2",
                           "--results-dir", str(tmp_path), *flags])
    assert rc == 0
    import json
    run = next(tmp_path.iterdir())
    fleet = json.loads((run / "summary.json").read_text())["fleet"]
    assert fleet["dropped"] == 0 and fleet["failures"] == []
    assert fleet["completed"] + fleet["shed"] == 8
    if flags[:1] == ["--inject-fault"]:
        assert [e["event"] for e in fleet["events"]] == ["replica_dead"]
    if "--swap-at" not in flags:
        assert fleet["parity"] == {"checked": 2, "exact": True}
    else:
        assert "swap_failed" in [e["event"] for e in fleet["events"]]
