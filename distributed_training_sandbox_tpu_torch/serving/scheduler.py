"""Continuous-batching scheduler: the per-request state machine — a copy
of the JAX package's ``serving/scheduler.py`` (it never touched JAX),
without the radix prefix cache, which is a later slice of the port.

Requests move WAITING → PREFILL → DECODE → DONE.  The decode step has a
fixed shape — ``max_batch`` slots and an active mask — so admission and
eviction are host bookkeeping between decode bursts.

Admission policy: FCFS with head-of-line blocking, and ALL pages a
request can ever need — ``ceil((prompt + max_new) / page_size)`` — are
granted at admit time, so an admitted request runs to completion with no
page-fault path.  Eviction (page + slot release) happens at the sync
point where a request's emission count reaches ``max_new``.

Timestamps are elapsed seconds on the engine's clock: ``t_submit`` is
the request's (virtual) arrival, ``t_first`` when its first token
resolved on the host, ``t_done`` at the retiring sync point.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .kv_pool import PageAllocator

WAITING = "WAITING"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"


def maybe_inc(registry, name: str, n: int = 1) -> None:
    """Counter hook kept at the reference's call sites; the port has no
    metrics registry yet (telemetry is a later slice), so it does
    nothing."""


@dataclass
class Request:
    """One generation request plus its runtime state.  ``tokens`` holds
    the emitted ids; the first comes from the prefill's last-position
    logits."""
    rid: int
    prompt: np.ndarray          # (S0,) int32
    max_new_tokens: int
    #: virtual arrival time; None = "now" at submit (0.0 is a real time)
    arrival_s: float | None = None

    state: str = WAITING
    slot: int | None = None
    pages: list[int] | None = None
    prefill_pos: int = 0
    tokens: list[int] = field(default_factory=list)
    t_submit: float | None = None
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None

    @property
    def n_prompt(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def ttft_s(self) -> float | None:
        if self.t_first is None or self.t_submit is None:
            return None
        return self.t_first - self.t_submit

    @property
    def per_token_s(self) -> float | None:
        """Mean decode latency per token AFTER the first, sync-granular."""
        if self.t_done is None or self.t_first is None:
            return None
        return (self.t_done - self.t_first) / max(len(self.tokens) - 1, 1)


class ContinuousBatcher:
    """Slot + page bookkeeping for the engine.  Owns the waiting queue,
    the ``max_batch`` slot table and the page allocator; knows nothing
    about devices."""

    def __init__(self, max_batch: int, allocator: PageAllocator,
                 page_size: int):
        self.max_batch = int(max_batch)
        self.allocator = allocator
        self.page_size = int(page_size)
        self.waiting: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * self.max_batch
        self.admitted_total = 0
        self.completed_total = 0
        self.metrics = None

    def has_work(self) -> bool:
        return bool(self.waiting) or any(
            r is not None for r in self.slots)

    def slot_request(self, b: int) -> Request | None:
        return self.slots[b]

    def next_prefill(self) -> Request | None:
        """The oldest request still in PREFILL."""
        cands = [r for r in self.slots
                 if r is not None and r.state == PREFILL]
        return min(cands, key=lambda r: r.t_admit) if cands else None

    def pages_needed(self, req: Request) -> int:
        total = req.n_prompt + req.max_new_tokens
        return -(-total // self.page_size)

    def submit(self, req: Request, now: float) -> None:
        req.state = WAITING
        req.t_submit = req.arrival_s if req.arrival_s is not None else now
        self.waiting.append(req)

    def admit(self, now: float) -> list[Request]:
        """FCFS: admit while a slot AND the full page grant are free."""
        admitted = []
        while self.waiting:
            free = [b for b, r in enumerate(self.slots) if r is None]
            if not free:
                break
            req = self.waiting[0]
            pages = self.allocator.alloc(self.pages_needed(req))
            if pages is None:
                break
            self.waiting.popleft()
            req.pages = pages
            req.prefill_pos = 0
            req.slot = free[0]
            req.state = PREFILL
            req.t_admit = now
            self.slots[req.slot] = req
            self.admitted_total += 1
            maybe_inc(self.metrics, "batcher_admitted_total")
            admitted.append(req)
        return admitted

    def retire(self, req: Request, now: float) -> None:
        """DONE: release the slot and every page.  Retiring a request
        that is not resident raises, never a silent double free."""
        if req.slot is None or self.slots[req.slot] is not req:
            raise ValueError(
                f"retire(rid={req.rid}): request is not resident in "
                f"this batcher (slot={req.slot}, state={req.state}) — "
                f"double retire or foreign request")
        self.slots[req.slot] = None
        self.allocator.free(req.pages)
        req.pages = None
        req.slot = None
        req.state = DONE
        req.t_done = now
        self.completed_total += 1
        maybe_inc(self.metrics, "batcher_completed_total")

    def release_all(self) -> list[Request]:
        """Failover teardown: free every resident request's slot and
        pages and drain the waiting queue, returning all unfinished
        requests (resident first, in slot order, then waiting FCFS)."""
        orphans: list[Request] = []
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            self.slots[b] = None
            self.allocator.free(req.pages)
            reset_for_replay(req)
            orphans.append(req)
        while self.waiting:
            req = self.waiting.popleft()
            reset_for_replay(req)
            orphans.append(req)
        return orphans


def reset_for_replay(req: Request) -> None:
    """Rewind a request to its just-submitted state (identity kept,
    runtime state cleared) so that it can be replayed from scratch."""
    req.state = WAITING
    req.slot = None
    req.pages = None
    req.prefill_pos = 0
    req.tokens = []
    req.t_admit = None
    req.t_first = None
    req.t_done = None
