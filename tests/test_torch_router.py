"""The port's router (``serving/router.py``) and the serving fault kinds
(``resilience/faults.py``) against the JAX reference's, on the CPU.

Both are pure host Python, so every decision is held bit for bit:

* ``AdmissionController`` on scripted and random offer sequences —
  arrivals, ``max_new``, deadlines, ``observe_burst`` and
  ``note_cache_hit_rate`` calls interleaved, calibrated or frozen — the
  same ``(reason, modeled TTFT, depth)`` for every offer, the same
  prior and counters after;
* ``Router.submit`` on the same requests: the same ``Rejection``
  records (``as_dict()``) and trace ids; ``dispatch`` over the same
  fake replicas (live, draining, dead; seats and loads scripted) and
  ``requeue_front``: the same placements in the same order;
* the fault kinds: every registry example parses and round-trips as the
  reference's, malformed specs fail with the reference's message, and
  the injector's serving hooks fire (or not) alike.
"""

import numpy as np
import pytest

from distributed_training_sandbox_tpu.resilience import elastic as JEL
from distributed_training_sandbox_tpu.resilience import faults as JF
from distributed_training_sandbox_tpu.serving import router as JR
from distributed_training_sandbox_tpu.serving import scheduler as JS
from distributed_training_sandbox_tpu_torch.resilience import elastic as PEL
from distributed_training_sandbox_tpu_torch.resilience import faults as PF
from distributed_training_sandbox_tpu_torch.serving import router as PR
from distributed_training_sandbox_tpu_torch.serving import scheduler as PS
import torch  # noqa: E402
torch.set_num_threads(1)  # the suite's workers share the cores


def _script(seed, n=120):
    """A random offer script: ('offer', arrival, max_new, deadline) in
    arrival order, with 'burst' and 'hit' feedback calls between."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(0.01))
        dl = None if rng.random() < 0.4 else float(rng.uniform(0.02, 0.4))
        out.append(("offer", t, int(rng.integers(1, 40)), dl))
        u = rng.random()
        if u < 0.15:
            out.append(("burst", float(rng.uniform(0.0, 0.2))))
        elif u < 0.25:
            out.append(("hit", float(rng.uniform(-0.2, 1.2))))
    return out


def _replay(mod, script, **kw):
    adm = mod.AdmissionController(**kw)
    got = []
    for step in script:
        if step[0] == "offer":
            got.append(adm.offer(step[1], step[2], step[3]))
        elif step[0] == "burst":
            adm.observe_burst(step[1])
        else:
            adm.note_cache_hit_rate(step[1])
    return got, (adm.burst_s, adm.cache_hit_rate, adm.offered_total,
                 adm.shed_total, sorted(adm._backlog))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(total_slots=2, max_queue=2, calibrate=False),
    dict(total_slots=4, max_queue=8, burst_s=0.03, steps_per_burst=2),
    dict(total_slots=1, max_queue=0, burst_s=0.1),
    dict(total_slots=0, max_queue=-3, steps_per_burst=0),
], ids=["frozen", "calibrated", "no-queue", "clamped"])
def test_admission_decides_as_the_reference(seed, kw):
    script = _script(seed)
    got_p, state_p = _replay(PR, script, **kw)
    got_j, state_j = _replay(JR, script, **kw)
    assert got_p == got_j
    assert state_p == state_j
    reasons = {g[0] for g in got_p}
    if kw["max_queue"] <= 0:
        assert reasons == {"queue_full"}


def test_admission_reference_table():
    """The reference suite's worked example, on both."""
    for mod in (PR, JR):
        adm = mod.AdmissionController(2, max_queue=2, burst_s=0.05,
                                      steps_per_burst=4, calibrate=False)
        for _ in range(3):
            assert adm.offer(0.0, max_new_tokens=4)[:2] == (
                None, pytest.approx(0.05))
        reason, ttft, _ = adm.offer(0.0, 4, deadline_s=0.06)
        assert reason == "deadline" and ttft == pytest.approx(0.10)
        assert adm.offer(0.0, 4)[0] is None
        assert adm.offer(0.0, 4)[0] == "queue_full"
        assert (adm.offered_total, adm.shed_total) == (6, 2)
        assert adm.offer(10.0, 4)[0] is None


def _requests(mod, seed, n=60):
    rng = np.random.default_rng(seed)
    arr = np.sort(rng.uniform(0.0, 0.3, size=n))
    return [mod.Request(rid=i, prompt=np.ones(int(rng.integers(1, 9)),
                                              np.int32),
                        max_new_tokens=int(rng.integers(1, 30)),
                        arrival_s=None if i % 7 == 3 else float(arr[i]))
            for i in range(n)]


@pytest.mark.parametrize("seed", [3, 4])
def test_router_submit_rejections_equal(seed):
    rng = np.random.default_rng(seed + 100)
    deadlines = [None if rng.random() < 0.3 else float(rng.uniform(0.05, 0.3))
                 for _ in range(60)]
    out = {}
    for mod, smod in ((PR, PS), (JR, JS)):
        router = mod.Router(mod.AdmissionController(
            3, max_queue=2, burst_s=0.04, calibrate=False))
        reqs = _requests(smod, seed)
        reqs[5].trace_id = "tr-given"
        res = [router.submit(r, d) for r, d in zip(reqs, deadlines)]
        out[mod] = ([None if x is None else x.as_dict() for x in res],
                    [r.as_dict() for r in router.rejections],
                    [r.trace_id for r in reqs])
    assert out[PR] == out[JR]
    assert any(x is not None for x in out[PR][0])
    assert any(x is None for x in out[PR][0])
    assert out[PR][2][5] == "tr-given" and out[PR][2][6] == "tr-000006"


class _Eng:
    """A scripted engine: seats while its free slots last."""

    def __init__(self, seats, load):
        self.seats, self.load, self.got = seats, load, []

    def can_accept(self, req):
        return self.seats > 0

    def in_flight(self):
        return self.load

    def enqueue(self, req, now):
        self.seats -= 1
        self.load += 1
        self.got.append((req.rid, now))


class _Rep:
    def __init__(self, idx, state, seats, load):
        self.idx, self.state = idx, state
        self.engine = _Eng(seats, load)


class _Metrics:
    def __init__(self):
        self.calls = []

    def inc(self, name, value=1.0, **labels):
        self.calls.append((name, value, tuple(sorted(labels.items()))))


def _dispatch_run(mod, smod):
    router = mod.Router(mod.AdmissionController(8))
    router.metrics = _Metrics()
    reqs = _requests(smod, 9, n=12)
    for r in reqs[:8]:
        router.enqueue(r)
    reps = [_Rep(0, "live", 2, 1), _Rep(1, "draining", 5, 0),
            _Rep(2, "live", 3, 0), _Rep(3, "dead", 9, 0),
            _Rep(4, "live", 1, 1)]
    first = [(rep.idx, req.rid) for rep, req in router.dispatch(reps, 0.5)]
    # failover: the dead replica's orphans go back to the head in order
    router.requeue_front(reqs[8:11])
    for rep in reps:
        rep.engine.seats += 2
    second = [(rep.idx, req.rid) for rep, req in router.dispatch(reps, 1.5)]
    return (first, second, [r.rid for r in router.queue],
            router.dispatched_total, [rep.engine.got for rep in reps],
            router.metrics.calls)


def test_router_dispatch_and_requeue_front_equal():
    got, want = _dispatch_run(PR, PS), _dispatch_run(JR, JS)
    assert got == want
    first, second, left = got[:3]
    assert [i for i, _ in first] == [2, 0, 2, 4, 0, 2]   # least loaded
    assert [rid for _, rid in second][:3] == [8, 9, 10]  # replays first
    assert left == []


# ---- the serving fault kinds --------------------------------------------

def test_fault_registry_round_trips_as_the_reference():
    assert PF.FAULT_KINDS == JF.FAULT_KINDS
    assert PF.SERVING_FAULT_KINDS == JF.SERVING_FAULT_KINDS
    for name, info in PF.FAULT_REGISTRY.items():
        j = JF.FAULT_REGISTRY[name]
        assert (info.int_target, info.target_what, info.step_required,
                info.example) == (j.int_target, j.target_what,
                                  j.step_required, j.example)
        p, q = PF.parse_fault_spec(info.example), JF.parse_fault_spec(
            info.example)
        assert (p.kind, p.step, p.target, str(p)) == (
            q.kind, q.step, q.target, str(q)) == (name, q.step, q.target,
                                                  info.example)


@pytest.mark.parametrize("bad", [
    "bogus@3", "crash", "hang_decode:1", "kill_replica@2:fast",
    "slow_replica@1:soon", "kill_replica", "corrupt_swap:x@3",
])
def test_fault_parse_rejects_malformed_as_the_reference(bad):
    with pytest.raises(SystemExit) as p:
        PF.parse_fault_spec(bad)
    with pytest.raises(SystemExit) as j:
        JF.parse_fault_spec(bad)
    assert str(p.value) == str(j.value)


class _Wd:
    def __init__(self):
        self.wedged = 0

    def wedge(self):
        self.wedged += 1


def _hook_trace(mod, el, spec, calls):
    inj = mod.FaultInjector(mod.parse_fault_spec(spec))
    wd, out = _Wd(), []
    for replica, burst, with_wd in calls:
        try:
            inj.check_serving(replica, burst, wd if with_wd else None)
            out.append(("ok", wd.wedged, inj.fired))
        except el.WorkerLost as e:
            out.append(("lost", e.ranks, e.step, e.trigger, str(e)))
        except SystemExit as e:
            out.append(("exit", str(e)))
    inj2 = mod.FaultInjector(mod.parse_fault_spec(spec))
    inj2.check(calls[0][1])           # a training step never fires them
    out.append((inj2.fired, inj2.wants_corrupt_swap(),
                inj2.wants_corrupt_swap()))
    return out


@pytest.mark.parametrize("spec", ["kill_replica@2:1", "hang_decode@1:0",
                                  "slow_replica@1:5", "corrupt_swap"])
@pytest.mark.parametrize("wd", [True, False], ids=["watchdog", "none"])
def test_injector_serving_hooks_fire_as_the_reference(spec, wd):
    calls = [(0, 1, wd), (1, 1, wd), (0, 2, wd), (1, 2, wd), (1, 2, wd),
             (0, 1, wd)]
    got = _hook_trace(PF, PEL, spec, calls)
    assert got == _hook_trace(JF, JEL, spec, calls)
    if spec == "kill_replica@2:1":
        assert got[3][0] == "lost" and got[3][3] == "kill_replica"
    if spec == "corrupt_swap":
        assert got[-1] == (False, True, False)
