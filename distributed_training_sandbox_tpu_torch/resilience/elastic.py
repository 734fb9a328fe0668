"""The part of the JAX package's ``resilience/elastic.py`` that the
supervisor and the fault injector reach: :class:`WorkerLost`,
:class:`StepTimeoutError`, :class:`Heartbeat` (a per-worker liveness
file) and :class:`Watchdog` (the step pump's guarded sync points; the
``hang@N`` fault wedges it).

Not ported — ROADMAP.md queue A item A12, the elastic runtime:
failure detection across workers (``HeartbeatMonitor``), the shrink
policy (``shrink_plan``), the shrinking restart loop
(``ElasticSupervisor``) and the resharding restore they need.  Each
raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

A12 = "ROADMAP.md queue A item A12"


class WorkerLost(RuntimeError):
    """One or more workers of the current mesh are gone (SIGKILLed,
    preempted without notice, or declared dead by the heartbeat
    monitor).  Restartable under :class:`ElasticSupervisor`, fatal
    under the plain :class:`~.supervisor.Supervisor`."""

    def __init__(self, ranks, *, step: int | None = None,
                 trigger: str = "worker_lost"):
        self.ranks = sorted(int(r) for r in ranks)
        self.step = step
        self.trigger = trigger
        at = f" at step {step}" if step is not None else ""
        super().__init__(f"worker(s) {self.ranks} lost{at} ({trigger})")


class StepTimeoutError(RuntimeError):
    """A pump sync point did not retire within the watchdog budget —
    the diagnosable form of a hung collective.  Carries the in-flight
    step index and the last contract verdict so the failure names the
    choreography it hung inside, instead of a silent deadlock."""

    def __init__(self, *, step: int | None = None,
                 timeout_s: float | None = None,
                 contract: str | None = None):
        self.step = step
        self.timeout_s = timeout_s
        self.contract = contract
        msg = (f"step {step if step is not None else '?'} did not retire "
               f"within {timeout_s:.1f}s — hung collective or wedged rank"
               if timeout_s is not None else
               f"step {step} did not retire — hung collective")
        if contract:
            msg += f"; last contract verdict: {contract}"
        super().__init__(msg)


def _hb_path(directory, rank: int) -> Path:
    return Path(directory) / f"worker_{int(rank)}.hb"


def _dead_path(directory, rank: int) -> Path:
    return Path(directory) / f"worker_{int(rank)}.dead"


class Heartbeat:
    """Per-worker liveness file.  ``beat(step)`` atomically rewrites
    ``worker_<rank>.hb`` with the last completed step and a wall-clock
    stamp; ``mark_dead`` drops a ``.dead`` breadcrumb (written by the
    ``kill_worker`` fault right before SIGKILL) so the monitor learns of
    a deliberate death instantly instead of after the stale timeout."""

    def __init__(self, directory, rank: int = 0):
        self.directory = Path(directory)
        self.rank = int(rank)
        self.directory.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int) -> None:
        path = _hb_path(self.directory, self.rank)
        tmp = path.with_suffix(".hb.tmp")
        tmp.write_text(json.dumps({"rank": self.rank, "step": int(step),
                                   "time": time.time()}))
        os.replace(tmp, path)   # atomic: the monitor never reads a torn beat

    def mark_dead(self, reason: str = "") -> None:
        _dead_path(self.directory, self.rank).write_text(
            json.dumps({"rank": self.rank, "reason": reason,
                        "time": time.time()}))


def read_heartbeats(directory) -> dict[int, dict]:
    """rank -> last beat record (empty when the dir doesn't exist)."""
    out: dict[int, dict] = {}
    root = Path(directory)
    if not root.is_dir():
        return out
    for p in root.glob("worker_*.hb"):
        try:
            out[int(p.stem.split("_", 1)[1])] = json.loads(p.read_text())
        except (ValueError, json.JSONDecodeError, OSError):
            continue
    return out


def _elastic(what: str):
    raise NotImplementedError(
        f"{what} belongs to the elastic runtime, not ported yet — see {A12}")


class HeartbeatMonitor:
    """Not ported (A12): the coordinator-side liveness probe."""

    def __init__(self, *args, **kwargs):
        _elastic("HeartbeatMonitor")


def shrink_plan(world: int, lost_ranks, **kwargs):
    """Not ported (A12): the shrink-to-survivors policy."""
    _elastic("shrink_plan")


class ElasticSupervisor:
    """Not ported (A12): the restart loop that survives worker loss."""

    def __init__(self, *args, **kwargs):
        _elastic("ElasticSupervisor")


# --------------------------------------------------------------- watchdog

class Watchdog:
    """Timeout/backoff wrapper around the pump's blocking sync points.

    ``block(fn, *args, step=i)`` runs the wait in a daemon thread and
    joins with the budget; a wait that outlives it raises
    :class:`StepTimeoutError` with the in-flight step index and the
    last contract verdict from ``context()`` — the wedged thread is
    abandoned (the process is about to be torn down and relaunched on
    the survivors, which is the only real cure for a hung collective).

    ``wedge()`` is the deterministic-fault hook: the ``hang@N`` fault
    calls it, after which the next guarded wait blocks on an event that
    never fires — exactly the shape a dead peer gives a collective."""

    def __init__(self, timeout_s: float, *, context=None):
        self.timeout_s = float(timeout_s)
        self._context = context
        self._wedged = False

    def wedge(self) -> None:
        self._wedged = True

    def block(self, fn, *args, step: int | None = None):
        if self.timeout_s <= 0 and not self._wedged:
            return fn(*args)
        done: dict = {}
        never = threading.Event()

        def run():
            try:
                if self._wedged:
                    never.wait()   # the injected hung collective
                done["value"] = fn(*args)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                done["error"] = e

        t = threading.Thread(target=run, daemon=True,
                             name="collective-watchdog-wait")
        t.start()
        t.join(self.timeout_s if self.timeout_s > 0 else None)
        if t.is_alive():
            info = {}
            if self._context is not None:
                try:
                    info = dict(self._context() or {})
                except Exception:  # noqa: BLE001 - diagnosis must not mask
                    pass
            raise StepTimeoutError(step=step, timeout_s=self.timeout_s,
                                   contract=info.get("contract"))
        if "error" in done:
            raise done["error"]
        return done.get("value")
