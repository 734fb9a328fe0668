"""Continuous-batching scheduler: the per-request state machine — a copy
of the JAX package's ``serving/scheduler.py`` (it never touched JAX),
prefix-aware admission over the radix cache included.

Requests move WAITING → PREFILL → DECODE → DONE.  The decode step has a
fixed shape — ``max_batch`` slots and an active mask — so admission and
eviction are host bookkeeping between decode bursts.

Admission policy: FCFS with head-of-line blocking, and ALL pages a
request can ever need — ``ceil((prompt + max_new) / page_size)`` — are
granted at admit time, so an admitted request runs to completion with no
page-fault path; with a prefix cache only the non-cached suffix is
granted.  Eviction (page + slot release) happens at the sync point where
a request's emission count reaches ``max_new``.

Timestamps are elapsed seconds on the engine's clock: ``t_submit`` is
the request's (virtual) arrival, ``t_first`` when its first token
resolved on the host, ``t_done`` at the retiring sync point.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..telemetry.metrics import maybe_inc
from .kv_pool import PageAllocator

WAITING = "WAITING"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"


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
    #: trace id, minted once at submit; identity, not runtime state:
    #: ``reset_for_replay`` keeps it
    trace_id: str | None = None

    state: str = WAITING
    slot: int | None = None
    pages: list[int] | None = None
    #: radix-cache nodes this request holds refs on; a prefix of
    #: ``pages`` (same order) — those pages are TRIE-owned, only
    #: ``pages[len(cache_nodes):]`` go back to the allocator at retire
    cache_nodes: list = field(default_factory=list)
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
        # live MetricsRegistry, late-assigned by the engine; None-safe
        self.metrics = None
        # RadixPrefixCache, late-assigned by the engine when prefix
        # caching is on; None = every page comes from the allocator
        self.prefix_cache = None

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
        """FCFS: admit while a slot AND the full page grant are free.

        With a prefix cache attached, the grant counts only the
        NON-CACHED suffix: cached full-prompt pages are aliased (refs
        taken, never written — see ``kv_pool.RadixPrefixCache``) and
        prefill starts at the matched page boundary.  Under pool
        pressure the cache is asked to evict idle pages before the
        head request is declared blocked."""
        admitted = []
        cache = self.prefix_cache
        while self.waiting:
            free = [b for b, r in enumerate(self.slots) if r is None]
            if not free:
                break
            req = self.waiting[0]
            nodes = cache.match(req.prompt) if cache is not None else []
            need = self.pages_needed(req) - len(nodes)
            pages = self.allocator.alloc(need)
            if pages is None and cache is not None:
                # pin the matched prefix first: its refs-0 nodes are
                # legal LRU victims, and evicting a page this request
                # is about to alias would hand it a freed page
                cache.acquire(nodes)
                ev = cache.evict(need - self.allocator.free_pages)
                cache.release(nodes)
                if ev:
                    maybe_inc(self.metrics,
                              "prefix_cache_evictions_total", ev)
                pages = self.allocator.alloc(need)
            if pages is None:
                break
            self.waiting.popleft()
            req.pages = [n.page for n in nodes] + pages
            req.cache_nodes = list(nodes)
            req.prefill_pos = len(nodes) * self.page_size
            if cache is not None:
                cache.acquire(nodes)
                n_full = (req.n_prompt - 1) // self.page_size
                cache.note_lookup(len(nodes), n_full)
                maybe_inc(self.metrics, "prefix_cache_hit_pages_total",
                          len(nodes))
                maybe_inc(self.metrics,
                          "prefix_cache_lookup_pages_total", n_full)
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
        self._release_pages(req)
        req.slot = None
        req.state = DONE
        req.t_done = now
        self.completed_total += 1
        maybe_inc(self.metrics, "batcher_completed_total")

    def _release_pages(self, req: Request) -> None:
        """Cached pages go back to the trie (deref, stay resident for
        the next prefix twin); only request-OWNED pages return to the
        allocator."""
        if req.cache_nodes:
            self.prefix_cache.release(req.cache_nodes)
        owned = req.pages[len(req.cache_nodes):]
        if owned:
            self.allocator.free(owned)
        req.pages = None
        req.cache_nodes = []

    def release_all(self) -> list[Request]:
        """Failover teardown: free every resident request's slot and
        pages and drain the waiting queue, returning all unfinished
        requests (resident first, in slot order, then waiting FCFS)."""
        orphans: list[Request] = []
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            self.slots[b] = None
            self._release_pages(req)
            reset_for_replay(req)
            orphans.append(req)
        while self.waiting:
            req = self.waiting.popleft()
            reset_for_replay(req)
            orphans.append(req)
        return orphans


def reset_for_replay(req: Request) -> None:
    """Rewind a request to its just-submitted state so that it can be
    replayed from scratch.  Identity (rid, prompt, max_new_tokens,
    arrival_s, t_submit, trace_id) is kept; runtime state is cleared."""
    req.state = WAITING
    req.slot = None
    req.pages = None
    req.cache_nodes = []
    req.prefill_pos = 0
    req.tokens = []
    req.t_admit = None
    req.t_first = None
    req.t_done = None
