"""The port's step pump and device prefetcher (``runtime/``) against the
JAX package's, on the CPU.

The pump bit for bit: over a grid of mode, ``sync_every``,
``max_in_flight`` and 0–25 steps, with a profiler stub that asks for a
boundary barrier at fixed steps, the port's ``emit`` flags, its
``sync_breakdown``, the order in which it resolves losses and calls
each step's ``log``, and the order of its calls into the telemetry run
(deferred steps, resolved steps, flushes) equal the reference pump's.
Then: the tracker is fed the resolved losses (``avg_loss``), a profile
boundary is a full sync point, and the collective watchdog turns a
wedged sync into ``StepTimeoutError``.  The prefetcher yields in order,
relays a producer error, joins its thread, and shuts down when the loop
crashes; it refuses a card that is not there.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.runtime import pump as JP
from distributed_training_sandbox_tpu_torch.resilience import (
    StepTimeoutError, Watchdog)
from distributed_training_sandbox_tpu_torch.runtime import (
    DevicePrefetcher, StepPump, sharded_put)
from distributed_training_sandbox_tpu_torch.utils.tracker import (
    PerformanceTracker)

BOUNDARIES = {2, 9, 10, 17}


class _Profiler:
    """Asks for a barrier on the emits whose index is in BOUNDARIES."""
    enabled = True

    def __init__(self):
        self.calls = 0

    def pending_transition(self):
        self.calls += 1
        return self.calls - 1 in BOUNDARIES


class _Telem:
    """Records the pump's calls; a deferred step is logged as such."""
    profiler = None
    metrics = None
    spans = None

    def __init__(self):
        self.calls = []

    def step(self, *, loss=None, tokens=None, tracker_metrics=None):
        deferred = not isinstance(loss, (float, type(None)))
        self.calls.append(("step", "deferred" if deferred else loss,
                           tokens))

    def flush(self, up_to=None):
        self.calls.append(("flush", up_to))


def _drive(Pump, value, mode, sync_every, max_in_flight, n, profiler):
    telem, logs = _Telem(), []
    pump = Pump(telem=telem, mode=mode, sync_every=sync_every,
                max_in_flight=max_in_flight,
                profiler=_Profiler() if profiler else None)
    flags = [pump.emit(value(i), tokens=i,
                       log=lambda lf, i=i: logs.append((i, lf)))
             for i in range(n)]
    pump.close()
    return {"flags": flags, "breakdown": pump.sync_breakdown,
            "resolved": pump.resolved, "logs": logs, "telem": telem.calls,
            "losses": pump.losses, "syncs": pump.host_sync_count}


@pytest.mark.parametrize("mode", ["async", "sync"])
@pytest.mark.parametrize("sync_every", [0, 1, 3, 4])
@pytest.mark.parametrize("profiler", [False, True], ids=["noprof", "prof"])
def test_pump_equals_the_reference(mode, sync_every, profiler):
    for max_in_flight in (1, 2, 5):
        for n in range(26):
            got = _drive(StepPump, lambda i: torch.tensor(0.5 * i), mode,
                         sync_every, max_in_flight, n, profiler)
            want = _drive(JP.StepPump, lambda i: jnp.asarray(0.5 * i),
                          mode, sync_every, max_in_flight, n, profiler)
            assert got == want, (max_in_flight, n)


def test_pump_feeds_the_tracker_the_resolved_losses():
    tracker = PerformanceTracker(warmup_steps=0, num_devices=1,
                                 device="cpu")
    with StepPump(tracker=tracker, sync_every=3, max_in_flight=2) as pump:
        for i in range(7):
            pump.emit(torch.tensor(float(i)), tokens=10)
    assert pump.metrics["avg_loss"] == sum(range(7)) / 7
    assert pump.metrics["total_tokens"] == 70


def test_profile_boundary_is_a_barrier():
    pump = StepPump(sync_every=0, max_in_flight=16, profiler=_Profiler())
    flags = [pump.emit(torch.tensor(float(i))) for i in range(4)]
    assert flags == [False, False, True, False]
    assert pump.sync_breakdown == {"profile_boundary": 1}
    assert pump.losses == [0.0, 1.0, 2.0]   # everything up to it resolved
    pump.close()
    assert pump.sync_breakdown == {"profile_boundary": 1, "exit": 1}


def test_watchdog_times_out_a_wedged_sync():
    wd = Watchdog(0.2, context=lambda: {"contract": "ddp ok"})
    pump = StepPump(mode="sync", watchdog=wd)
    assert pump.emit(torch.tensor(1.0))          # a healthy sync passes
    wd.wedge()
    t0 = time.perf_counter()
    with pytest.raises(StepTimeoutError, match="step 1 did not retire "
                       "within 0.2s.*ddp ok"):
        pump.emit(torch.tensor(2.0))
    assert time.perf_counter() - t0 < 5


# ----------------------------------------------------------- prefetcher

def test_prefetcher_yields_in_order_and_joins():
    batches = [(torch.full((4, 2), float(i)), np.full(4, i))
               for i in range(9)]
    with DevicePrefetcher(iter(batches), device="cpu", depth=2) as pref:
        got = list(pref)
    assert len(got) == 9
    for i, (x, y) in enumerate(got):
        assert torch.equal(x, batches[i][0])
        assert torch.equal(y, torch.full((4,), i))
    assert not pref.alive


def test_prefetcher_takes_this_ranks_rows_through_sharded_put():
    """Without a process group the one rank holds every row."""
    batch = (torch.arange(8).reshape(4, 2), np.arange(4))
    with DevicePrefetcher(iter([batch]), device="cpu",
                          transform=lambda b: sharded_put(b, "cpu")) as pref:
        x, y = next(pref)
    assert torch.equal(x, batch[0]) and torch.equal(y, torch.arange(4))
    x, y = sharded_put(batch, "cpu", axis=None)
    assert torch.equal(x, batch[0])


def test_prefetcher_relays_a_producer_error():
    def stream():
        yield (torch.zeros(1),)
        raise ValueError("bad shard")

    pref = DevicePrefetcher(stream(), device="cpu")
    next(pref)
    with pytest.raises(ValueError, match="bad shard"):
        next(pref)
    assert not pref.alive
    with pytest.raises(StopIteration):
        next(pref)


def test_prefetcher_shuts_down_when_the_loop_crashes():
    def endless():
        i = 0
        while True:
            yield (torch.tensor([i]),)
            i += 1

    before = threading.active_count()
    with pytest.raises(RuntimeError, match="step failed"):
        with DevicePrefetcher(endless(), device="cpu", depth=3) as pref:
            for i, (x,) in enumerate(pref):
                assert int(x) == i
                if i == 4:
                    raise RuntimeError("step failed")
    assert not pref.alive and threading.active_count() == before


def test_prefetcher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(iter([]))
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter([]), device="cpu", depth=0)
