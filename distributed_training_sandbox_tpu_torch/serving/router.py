"""SLO-driven admission control and load-aware dispatch for the fleet: a
copy of the JAX package's ``serving/router.py`` (it never touched JAX;
the port keeps its own copy and imports nothing of that package).

Two pieces, both pure host bookkeeping, line for line the reference's so
that their decisions can be held against it bit for bit:

:class:`AdmissionController` — deadline-aware load shedding decided at
submit time on the trace's *virtual* clock.  Modeled TTFT = (modeled
queue wait + 1 service round) × the per-burst latency, the wait being
the queue depth beyond capacity.  A request is rejected with a
structured :class:`Rejection` when the bounded queue is full
(``queue_full``) or its modeled TTFT exceeds its deadline
(``deadline``).  Every decision is a pure function of (virtual arrival
order, arrival times, max_new, the burst-latency prior), so the shed set
reproduces from the traffic seed.  Measured per-burst latency feeds back
through :meth:`observe_burst` (EWMA) and affects only offers made after
it: a driver that submits the whole trace up front sheds identically on
every run.

:class:`Router` — one fleet-global FCFS dispatch queue in front of the
replicas (head-of-line blocking here, not inside every engine),
least-loaded dispatch among the live replicas that can seat the request
(a free slot and its full page grant), and :meth:`requeue_front` for
failover: a dead replica's requests go back to the queue head in their
original order, so the survivors take them before newer traffic.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass

from ..telemetry.metrics import maybe_inc
from .scheduler import Request

__all__ = ["AdmissionController", "Rejection", "Router"]


@dataclass(frozen=True)
class Rejection:
    """Structured load-shed record: what the client gets instead of a
    silent tail blowup, and what the fleet report renders."""
    rid: int
    reason: str                    # "queue_full" | "deadline"
    t_s: float                     # virtual arrival of the decision
    modeled_ttft_ms: float
    deadline_ms: float | None
    queue_depth: int

    def as_dict(self) -> dict:
        return {"rid": self.rid, "reason": self.reason,
                "t_s": round(self.t_s, 4),
                "modeled_ttft_ms": round(self.modeled_ttft_ms, 3),
                "deadline_ms": (None if self.deadline_ms is None
                                else round(self.deadline_ms, 3)),
                "queue_depth": self.queue_depth}


class AdmissionController:
    """Virtual-time occupancy model and shed policy (module docstring).

    ``total_slots``: fleet-wide concurrent capacity (replicas ×
    max_batch); arrivals beyond it are modeled as waiting.
    ``max_queue``: the bound on the modeled waiting line; deeper
    arrivals are shed ``queue_full``.  ``burst_s``: the per-burst
    latency prior; ``steps_per_burst``: tokens a request earns a burst
    (the engine's ``sync_every``), which models service time.
    ``calibrate=False`` freezes the prior (deterministic even for
    closed-loop drivers)."""

    def __init__(self, total_slots: int, *, max_queue: int = 8,
                 burst_s: float = 0.05, steps_per_burst: int = 4,
                 calibrate: bool = True):
        self.total_slots = max(int(total_slots), 1)
        self.max_queue = max(int(max_queue), 0)
        self.burst_s = float(burst_s)
        self.steps_per_burst = max(int(steps_per_burst), 1)
        self.calibrate = bool(calibrate)
        #: prefix-cache hit-rate prior (the fraction of prompt pages
        #: served from the cache), EWMA-fed by the engines through
        #: :meth:`note_cache_hit_rate`; 0 = no cache
        self.cache_hit_rate = 0.0
        #: heap of the modeled completion times of admitted requests
        self._backlog: list[float] = []
        self.offered_total = 0
        self.shed_total = 0

    # ---- the submit-time decision ------------------------------------
    def offer(self, arrival_s: float, max_new_tokens: int,
              deadline_s: float | None = None
              ) -> tuple[str | None, float, int]:
        """Decide one arrival: ``(reason, modeled_ttft_s, queue_depth)``
        with reason None on admit.  Admitting pushes the request's
        modeled completion into the backlog, so later offers see it
        occupying capacity until then."""
        self.offered_total += 1
        while self._backlog and self._backlog[0] <= arrival_s:
            heapq.heappop(self._backlog)
        depth = len(self._backlog)
        waiting = max(0, depth - self.total_slots)
        # the service round (the +1) is mostly prefill for a fresh
        # arrival; a prefix-cache hit skips the cached pages' chunks, so
        # the hit-rate prior discounts it (floored: the last prompt page
        # is always prefilled for the first token's logits)
        service_round = max(1.0 - self.cache_hit_rate, 0.25)
        modeled_ttft = (waiting + service_round) * self.burst_s
        if waiting >= self.max_queue:
            self.shed_total += 1
            return "queue_full", modeled_ttft, depth
        if deadline_s is not None and modeled_ttft > deadline_s:
            self.shed_total += 1
            return "deadline", modeled_ttft, depth
        service = self.burst_s * (
            -(-int(max_new_tokens) // self.steps_per_burst))
        heapq.heappush(self._backlog,
                       arrival_s + modeled_ttft + service)
        return None, modeled_ttft, depth

    def observe_burst(self, burst_s: float) -> None:
        """EWMA-calibrate the prior from a measured burst.  Only offers
        made after this call see the update."""
        if self.calibrate and burst_s > 0:
            self.burst_s = 0.8 * self.burst_s + 0.2 * float(burst_s)

    def note_cache_hit_rate(self, rate: float) -> None:
        """Prefix-cache hit-rate feedback from an engine (its
        ``RadixPrefixCache.hit_rate``): discounts the modeled-TTFT
        service round for offers made after this call, under the same
        EWMA and ``calibrate`` gate as :meth:`observe_burst`."""
        if self.calibrate and 0.0 <= rate <= 1.0:
            self.cache_hit_rate = (0.8 * self.cache_hit_rate
                                   + 0.2 * float(rate))


class Router:
    """Fleet-global dispatch queue and structured rejections."""

    def __init__(self, admission: AdmissionController):
        self.admission = admission
        self.queue: deque[Request] = deque()
        self.rejections: list[Rejection] = []
        self.dispatched_total = 0
        # live MetricsRegistry, assigned by the fleet
        # (``router.metrics = telem.metrics``); the feeds take None
        self.metrics = None

    def submit(self, req: Request,
               deadline_s: float | None = None) -> Rejection | None:
        """Admission decision for one request at its (virtual) arrival:
        the Rejection when shed (the request never enters the system),
        None when admitted — the caller then hands it to :meth:`enqueue`
        once its arrival is due.  Mints the request's ``trace_id``:
        submit is the one front door, so every attempt at serving the
        request (a failover replay on another replica included) shares
        the id."""
        if req.trace_id is None:
            req.trace_id = f"tr-{req.rid:06d}"
        maybe_inc(self.metrics, "router_offered_total")
        arrival = req.arrival_s if req.arrival_s is not None else 0.0
        reason, ttft_s, depth = self.admission.offer(
            arrival, req.max_new_tokens, deadline_s)
        if reason is None:
            return None
        maybe_inc(self.metrics, "router_shed_total", reason=reason)
        rej = Rejection(
            rid=req.rid, reason=reason, t_s=arrival,
            modeled_ttft_ms=1e3 * ttft_s,
            deadline_ms=None if deadline_s is None else 1e3 * deadline_s,
            queue_depth=depth)
        self.rejections.append(rej)
        return rej

    def enqueue(self, req: Request) -> None:
        self.queue.append(req)

    def requeue_front(self, reqs: list[Request]) -> None:
        """Failover: replayed requests re-enter at the queue head in
        their original order; the survivors serve them before new
        work."""
        self.queue.extendleft(reversed(reqs))

    def dispatch(self, replicas, now: float) -> list[tuple[object, Request]]:
        """Drain the queue head onto the least-loaded live replica that
        can seat it (a free slot and its full page grant).  FCFS: a head
        that no replica can seat blocks the queue, as the engines' own
        no-starvation policy does."""
        sent = []
        while self.queue:
            req = self.queue[0]
            cands = [r for r in replicas
                     if r.state == "live" and r.engine.can_accept(req)]
            if not cands:
                break
            rep = min(cands,
                      key=lambda r: (r.engine.in_flight(), r.idx))
            self.queue.popleft()
            rep.engine.enqueue(req, now)
            self.dispatched_total += 1
            maybe_inc(self.metrics, "router_dispatched_total",
                      replica=rep.idx)
            sent.append((rep, req))
        return sent
