"""Serving fleet: N engine replicas behind the router, with failover,
deadline shedding and zero-drop weight hot-swap — the port of the JAX
package's ``serving/fleet.py``.

**Failover with deterministic replay.**  Each replica is a
:class:`~.engine.ServingEngine` on one device, running its decode bursts
under a :class:`~..resilience.elastic.Watchdog` and beating a
:class:`~..resilience.elastic.Heartbeat`.  A replica death —
``kill_replica`` raising :class:`~..resilience.elastic.WorkerLost`, or
a wedged burst that the watchdog converts into
:class:`~..resilience.elastic.StepTimeoutError` — marks it dead, frees
its batcher and pool bookkeeping, and puts its unfinished requests back
at the router's queue head, reset for replay.  Greedy decode is a
function of (params, prompt) alone, and every engine contracts
attention over the same fixed pool view, so a replayed request's tokens
are those of an undisturbed run.  Partial progress is discarded, not
migrated: the dead replica's KV pages died with it.

**SLO-driven admission.**  Every ``submit`` runs through
:class:`~.router.AdmissionController` on the trace's virtual clock:
bounded queue, deadline shedding from the modeled TTFT, structured
:class:`~.router.Rejection` records.  Shed is not dropped: a request is
*dropped* only if it was admitted and never completed, and the fleet's
invariant is that none is, through kills, hangs and swaps.

**Zero-drop hot-swap.**  :meth:`Fleet.swap_weights` (or
``schedule_swap`` mid-traffic) restores the new params once, through
``resilience.state.Checkpointer.restore_latest`` (fingerprint-checked,
falling back past a torn newest step), then drains one replica at a
time at round boundaries: mark it ``draining`` (the router stops
dispatching to it), let its residents finish, ``swap_params`` at zero
in flight, return it live, go on to the next.  Traffic keeps flowing
through the other replicas.  A torn checkpoint (the ``corrupt_swap``
fault tears it) aborts the swap with a readable warning, and the fleet
keeps serving on the old weights.

**Devices.**  The reference carves ``jax.devices()`` into one device a
replica; torch has no fake host devices, so by default replica ``i``
takes ``cuda:i·stride`` (``stride = device_count // replicas``) and
``n`` replicas need ``n`` cards.  An explicit ``device`` (one device,
or a list of one a replica) may put several replicas on one device, as
the CPU tests and the chip smoke's one-card phase do.

Not ported: the reference's ``retraces_after_warmup`` (its replicas'
jit-cache growth; PyTorch runs eagerly and nothing retraces, so the
report leaves ``recompiles_after_warmup`` out) and its telemetry
facade's ``attach_step_hlo`` (there is no compiled step to attach).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..resilience.elastic import (Heartbeat, StepTimeoutError, Watchdog,
                                  WorkerLost)
from ..resilience.faults import FaultInjector, FaultSpec, parse_fault_spec
from ..telemetry.metrics import maybe_inc
from .engine import ServingEngine
from .router import AdmissionController, Rejection, Router
from .scheduler import Request

__all__ = ["Fleet", "Replica"]


class _ReplicaTelem:
    """Thin TelemetryRun facade: every step event a replica's engine
    emits carries its ``replica`` index, so that one steps.jsonl
    interleaves every replica's prefill and decode events
    distinguishably."""

    def __init__(self, telem, idx: int):
        self._telem = telem
        self.replica = int(idx)

    @property
    def spans(self):
        return getattr(self._telem, "spans", None)

    @property
    def metrics(self):
        return getattr(self._telem, "metrics", None)

    def step(self, **kw):
        kw.setdefault("replica", self.replica)
        return self._telem.step(**kw)


class Replica:
    """One engine and its liveness machinery.  ``state``: ``live`` (takes
    traffic), ``draining`` (finishes its residents, the router skips it:
    the hot-swap window), ``dead`` (failed over, never touched again)."""

    def __init__(self, idx: int, engine: ServingEngine,
                 watchdog: Watchdog | None,
                 heartbeat: Heartbeat | None):
        self.idx = int(idx)
        self.engine = engine
        self.watchdog = watchdog
        self.heartbeat = heartbeat
        self.state = "live"
        self.bursts = 0          # rounds with work this replica ran
        self.death: str | None = None


def _replica_devices(device, n: int) -> list:
    """One device a replica (module docstring)."""
    if device is None:
        resolve_device(None)               # raises without a card
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"{n} replicas need >= {n} devices, have "
                             f"{have}")
        stride = have // n
        return [torch.device("cuda", i * stride) for i in range(n)]
    if isinstance(device, (str, torch.device)):
        return [resolve_device(device)] * n
    devs = [resolve_device(d) for d in device]
    if len(devs) != n:
        raise ValueError(f"{n} replicas need {n} devices, got {len(devs)}")
    return devs


class Fleet:
    """N replicas, the router and the fault plumbing (module docstring).

    ``device``: see the module docstring.  ``fault``: a spec string or
    :class:`FaultSpec` of the serving kinds (``kill_replica@N:k`` /
    ``hang_decode@N:k`` / ``slow_replica@N:ms`` / ``corrupt_swap``).
    ``deadline_s`` is the per-request deadline ``submit`` applies when
    the caller gives none.  Engine kwargs (``max_batch``, ``page_size``,
    ``max_seq_len``, ``sync_every``, the kernel flags, ...) pass through
    to every replica."""

    def __init__(self, params, cfg, *, replicas: int = 2,
                 watchdog_timeout_s: float = 5.0,
                 fault: FaultSpec | str | None = None,
                 heartbeat_dir=None, telem=None,
                 max_queue: int = 8, burst_s_prior: float = 0.05,
                 calibrate_admission: bool = True,
                 deadline_s: float | None = None, device=None,
                 **engine_kwargs):
        n = int(replicas)
        if n < 1:
            raise ValueError(f"need >= 1 replica, got {n}")
        devs = _replica_devices(device, n)
        if isinstance(fault, str):
            fault = parse_fault_spec(fault)
        self.injector = FaultInjector(fault)
        self.telem = telem
        self.deadline_s = deadline_s
        self._params_host = params   # the restore's ``like`` tree
        self.cfg = cfg

        self.replicas: list[Replica] = []
        for i in range(n):
            wd = (Watchdog(watchdog_timeout_s)
                  if watchdog_timeout_s and watchdog_timeout_s > 0
                  else None)
            hb = (Heartbeat(heartbeat_dir, i)
                  if heartbeat_dir is not None else None)
            eng = ServingEngine(
                params, cfg, device=devs[i], watchdog=wd,
                telem=_ReplicaTelem(telem, i) if telem is not None
                else None,
                **engine_kwargs)
            eng.replica = i
            self.replicas.append(Replica(i, eng, wd, hb))

        eng0 = self.replicas[0].engine
        self.view_capacity = eng0.view_capacity
        self.admission = AdmissionController(
            n * eng0.max_batch, max_queue=max_queue,
            burst_s=burst_s_prior, steps_per_burst=eng0.sync_every,
            calibrate=calibrate_admission)
        self.router = Router(self.admission)
        self.router.metrics = getattr(telem, "metrics", None)

        self._pending: list[Request] = []
        self._rid = 0
        self.completed: list[Request] = []
        self.submitted: list[Request] = []
        self.events: list[dict] = []
        self._swap: dict | None = None
        self._t0: float | None = None

    # ---- intake -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               arrival_s: float | None = None,
               deadline_s: float | None = None
               ) -> Request | Rejection:
        """Admission-controlled submit: the Request when admitted, the
        structured :class:`Rejection` when shed.  Call in virtual-arrival
        order: the admission model is sequential, which is what makes
        the shed set reproducible."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1 or max_new_tokens < 1:
            raise ValueError("need >= 1 prompt token and >= 1 new token")
        if prompt.size + max_new_tokens > self.view_capacity:
            raise ValueError(
                f"prompt {prompt.size} + new {max_new_tokens} exceeds "
                f"the fleet's view capacity {self.view_capacity} "
                f"(raise max_seq_len)")
        req = Request(rid=self._rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      arrival_s=(None if arrival_s is None
                                 else float(arrival_s)))
        self._rid += 1
        if deadline_s is None:
            deadline_s = self.deadline_s
        rej = self.router.submit(req, deadline_s)
        if rej is not None:
            return rej
        self._pending.append(req)
        self.submitted.append(req)
        return req

    # ---- hot-swap -----------------------------------------------------
    def schedule_swap(self, ckpt_dir, *, after_completed: int = 0,
                      fingerprint: dict | None = None) -> None:
        """Arm a weight hot-swap: once ``after_completed`` requests have
        finished, restore the newest intact step of ``ckpt_dir`` and roll
        it across the replicas one drain at a time.  ``swap_weights`` is
        the immediate form."""
        self._swap = {"dir": ckpt_dir, "after": int(after_completed),
                      "fingerprint": fingerprint, "state": "armed",
                      "new_params": None, "queue": []}

    def swap_weights(self, ckpt_dir, *,
                     fingerprint: dict | None = None) -> None:
        self.schedule_swap(ckpt_dir, after_completed=0,
                           fingerprint=fingerprint)

    def _event(self, now: float, event: str, **kw) -> None:
        ev = {"t_s": round(now, 4), "event": event, **kw}
        self.events.append(ev)

    def _restore_swap_params(self, now: float):
        """One restore for the whole fleet, through Checkpointer's
        fingerprint check and torn-step fallback.  Returns the new param
        tree, or None when the checkpoint is unusable (the fleet keeps
        the old weights: the corrupt_swap path)."""
        from ..resilience.faults import corrupt_checkpoint
        from ..resilience.state import (CheckpointCorruptError,
                                        Checkpointer, RunState)
        sw = self._swap
        if self.injector.wants_corrupt_swap():
            corrupt_checkpoint(sw["dir"])
            self._event(now, "swap_fault_injected", kind="corrupt_swap")
        ckpt = Checkpointer(sw["dir"],
                            fingerprint=sw["fingerprint"] or {})
        try:
            state = ckpt.restore_latest(
                RunState(params=self._params_host))
        except CheckpointCorruptError as e:
            print(f"[fleet] WARNING: weight swap from {sw['dir']} "
                  f"aborted — every step is torn or corrupt ({e}); "
                  f"fleet keeps serving on the previous weights",
                  file=sys.stderr, flush=True)
            self._event(now, "swap_failed", reason="corrupt_checkpoint")
            return None
        finally:
            ckpt.close()
        if state is None:
            print(f"[fleet] WARNING: weight swap from {sw['dir']} "
                  f"aborted — no checkpoint steps found; fleet keeps "
                  f"serving on the previous weights",
                  file=sys.stderr, flush=True)
            self._event(now, "swap_failed", reason="no_steps")
            return None
        return state.params

    def _maybe_swap(self, now: float, force: bool = False) -> None:
        sw = self._swap
        if sw is None:
            return
        if sw["state"] == "armed":
            # ``force``: the trace drained before the trigger count was
            # reached — swap now rather than stay armed forever
            if len(self.completed) < sw["after"] and not force:
                return
            new = self._restore_swap_params(now)
            if new is None:
                self._swap = None
                return
            sw["new_params"] = new
            sw["queue"] = [r for r in self.replicas
                           if r.state != "dead"]
            sw["state"] = "draining"
            self._event(now, "swap_started",
                        replicas=[r.idx for r in sw["queue"]])
        if sw["state"] == "draining":
            while sw["queue"]:
                rep = sw["queue"][0]
                if rep.state == "dead":
                    sw["queue"].pop(0)
                    continue
                rep.state = "draining"
                if not rep.engine.drained():
                    return        # let its residents finish first
                rep.engine.swap_params(sw["new_params"])
                rep.state = "live"
                sw["queue"].pop(0)
                self._event(now, "swap_replica", replica=rep.idx)
            self._event(now, "swap_complete")
            self._swap = None

    # ---- failover -----------------------------------------------------
    def _on_replica_death(self, rep: Replica, exc: BaseException,
                          now: float) -> None:
        rep.state = "dead"
        rep.death = type(exc).__name__
        rep.engine.abandon_pump()
        if rep.heartbeat is not None:
            rep.heartbeat.mark_dead(f"{type(exc).__name__}@burst"
                                    f"{rep.bursts}")
        orphans = rep.engine.release_all()
        self.router.requeue_front(orphans)
        survivors = [r.idx for r in self.replicas if r.state == "live"]
        print(f"[fleet] WARNING: replica {rep.idx} died "
              f"({type(exc).__name__} at burst {rep.bursts}) — "
              f"re-enqueued {len(orphans)} in-flight request(s) onto "
              f"survivors {survivors}", file=sys.stderr, flush=True)
        self._event(now, "replica_dead", replica=rep.idx,
                    trigger=type(exc).__name__, burst=rep.bursts,
                    requeued=len(orphans))
        maybe_inc(getattr(self.telem, "metrics", None),
                  "fleet_replica_deaths_total", replica=rep.idx)
        if not survivors:
            raise RuntimeError(
                f"all {len(self.replicas)} replicas dead — last "
                f"failure: {type(exc).__name__} on replica {rep.idx}")

    # ---- the drive loop ----------------------------------------------
    def _has_work(self) -> bool:
        return bool(self.router.queue) or any(
            r.state != "dead" and r.engine.in_flight() > 0
            for r in self.replicas)

    def run(self) -> list[Request]:
        """Drive every admitted request to completion (arrivals on the
        shared virtual clock), applying faults, failover and any armed
        swap along the way.  Returns the requests completed by this
        call; the zero-drop invariant — every admitted request
        completes — is the caller-visible contract."""
        def vt(r: Request) -> float:
            return r.arrival_s if r.arrival_s is not None else 0.0

        pending = sorted(self._pending, key=vt)
        self._pending = []
        if self._t0 is None:
            self._t0 = time.perf_counter()
        t0 = self._t0
        for rep in self.replicas:
            if rep.state != "dead":
                rep.engine.start(t0)
        done_base = len(self.completed)
        try:
            while pending or self._has_work() or (
                    self._swap is not None):
                now = time.perf_counter() - t0
                while pending and vt(pending[0]) <= now:
                    req = pending.pop(0)
                    self.router.enqueue(req)
                self._maybe_swap(
                    now, force=not pending and not self._has_work())
                self.router.dispatch(self.replicas, now)
                progressed = False
                for rep in self.replicas:
                    if rep.state == "dead" \
                            or rep.engine.in_flight() == 0:
                        continue
                    try:
                        self.injector.check_serving(
                            rep.idx, rep.bursts, rep.watchdog)
                        t_b = time.perf_counter()
                        done = rep.engine.step_round(now)
                        self.admission.observe_burst(
                            time.perf_counter() - t_b)
                        if rep.engine.prefix_cache is not None:
                            # hits skip prefill chunks: the admission
                            # model discounts the service round for
                            # later offers
                            self.admission.note_cache_hit_rate(
                                rep.engine.prefix_cache.hit_rate)
                        rep.bursts += 1
                        if rep.heartbeat is not None:
                            rep.heartbeat.beat(rep.bursts)
                            maybe_inc(
                                getattr(self.telem, "metrics", None),
                                "heartbeat_beats_total",
                                replica=rep.idx)
                        self.completed.extend(done)
                        progressed = True
                    except (WorkerLost, StepTimeoutError) as e:
                        self._on_replica_death(rep, e, now)
                if not progressed and not self.router.queue \
                        and pending:
                    # idle until the next virtual arrival
                    time.sleep(min(max(vt(pending[0]) - now, 0.0),
                                   0.05))
                if self._swap is None and not pending \
                        and not self._has_work():
                    break
        finally:
            for rep in self.replicas:
                if rep.state != "dead":
                    rep.engine.close_pump()
        wall = time.perf_counter() - t0
        for rep in self.replicas:
            rep.engine.stats["wall_s"] = wall
        return self.completed[done_base:]

    # ---- reporting ----------------------------------------------------
    def dropped(self) -> list[int]:
        """rids that were ADMITTED but never completed — the zero-drop
        invariant says this is empty after ``run()``.  Shed requests
        are rejections, not drops."""
        done = {r.rid for r in self.completed}
        return [r.rid for r in self.submitted if r.rid not in done]

    def slo_report(self) -> dict:
        """Fleet-level SLO aggregate, per-replica blocks and the event
        timeline: what ``train.serve_bench --replicas N`` files under
        summary.json's ``fleet`` key."""
        done = [r for r in self.completed if r.t_done is not None]
        ttft = np.array([r.ttft_s for r in done
                         if r.ttft_s is not None]) * 1e3
        ptl = np.array([r.per_token_s for r in done
                        if r.per_token_s is not None]) * 1e3

        def pct(a, q):
            return round(float(np.percentile(a, q)), 3) if a.size else None

        per_replica = []
        for rep in self.replicas:
            slo = rep.engine.slo_report()
            per_replica.append({
                "replica": rep.idx, "state": rep.state,
                "death": rep.death, "bursts": rep.bursts,
                "requests": slo["requests"],
                "completed": slo["completed"],
                "ttft_ms": slo["ttft_ms"],
                "per_token_ms": slo["per_token_ms"],
                "tokens_per_s": slo["tokens_per_s"],
                "pool": slo["pool"],
                # the per-phase measured totals, so that an archived
                # fleet run can calibrate a simulator's cost model
                "scheduler": slo["scheduler"],
            })
        return {
            "replicas": len(self.replicas),
            "live": sum(r.state == "live" for r in self.replicas),
            "submitted": len(self.submitted),
            "shed": len(self.router.rejections),
            "completed": len(done),
            "dropped": len(self.dropped()),
            "ttft_ms": {"p50": pct(ttft, 50), "p99": pct(ttft, 99)},
            "per_token_ms": {"p50": pct(ptl, 50), "p99": pct(ptl, 99)},
            "admission": {
                "offered": self.admission.offered_total,
                "shed": self.admission.shed_total,
                "max_queue": self.admission.max_queue,
                "burst_s_prior": round(self.admission.burst_s, 5),
                "total_slots": self.admission.total_slots,
            },
            "rejections": [r.as_dict()
                           for r in self.router.rejections],
            "replica_slo": per_replica,
            "events": list(self.events),
        }
