"""Host-side phase spans: the fourth telemetry artifact.  Port of the JAX
package's ``telemetry/spans.py``; it keeps its own copy of
``memledger.phase_for_span`` (the memory ledger itself is ROADMAP.md
queue A item A12).

``steps.jsonl`` says what each optimizer step cost; it cannot say *where
the host spent the gaps* — blocked on the prefetch queue, barriered at a
pump sync point, throttled on in-flight backpressure, inside a
checkpoint write.  Each of those sites records a :func:`maybe_span`
here, appended to ``spans.jsonl`` in the run dir.

Schema (one JSON line per span, ``schema.span_event``):

    {"schema": 1, "name": "pump/sync_every", "cat": "pump",
     "ts_us": <unix-epoch µs of span start>, "dur_us": <float>, ...attrs}

Timestamps are unix-epoch microseconds derived from a
``perf_counter``-anchored clock captured at stream construction, so
spans from different threads (the prefetcher's producer records from its
own thread) share one monotonic timebase.  The anchor is a
bounded-error midpoint capture — ``perf_counter`` is read immediately
before *and* after ``time.time()``, the anchor sits at the midpoint and
half the window is the error bound — and is persisted to a
``clock_anchor.json`` sidecar (lazily, alongside the first span, so
span-free runs produce no extra files).  Every span is stamped with the
emitting ``rank`` (``DTS_PROCESS_ID``, else torchrun's ``RANK``) and
``pid``.  The stream is thread-safe and crash-tolerant: appends are
flushed every :data:`FLUSH_EVERY` events and on ``close()``, which
``TelemetryRun.finalize`` reaches on every path.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from .schema import span_event

FLUSH_EVERY = 32


def env_rank() -> int:
    """The emitting process's rank: ``DTS_PROCESS_ID`` (the reference's
    launcher), else ``RANK`` (torchrun), else 0."""
    for key in ("DTS_PROCESS_ID", "RANK"):
        v = os.environ.get(key)
        if v:
            return int(v)
    return 0


def phase_for_span(name: str, cat: str | None = None) -> str | None:
    """Map a host span (name, cat) onto the memory ledger's phase
    vocabulary, or None for spans outside the memory timeline: the JAX
    package's ``telemetry.memledger.phase_for_span``."""
    name = name or ""
    cat = cat or ""
    if cat == "prefetch" or name.startswith("prefetch"):
        return "prefetch"
    if cat == "checkpoint" or name.startswith("checkpoint"):
        return "checkpoint"
    if "prefill" in name:
        return "prefill"
    if "decode" in name:
        return "decode"
    if cat == "pump" or name.startswith("pump"):
        if any(t in name for t in ("sync", "drain", "throttle")):
            return "sync"
        return "dispatch"
    return None


class SpanStream:
    """Append-only ``spans.jsonl`` writer with a shared time anchor."""

    FILENAME = "spans.jsonl"

    ANCHOR_FILENAME = "clock_anchor.json"

    def __init__(self, run_dir: str, flush_every: int = FLUSH_EVERY):
        self.path = os.path.join(run_dir, self.FILENAME)
        self.anchor_path = os.path.join(run_dir, self.ANCHOR_FILENAME)
        # one anchor pair: unix epoch + the perf_counter reading at the
        # same instant; every span timestamp is
        # epoch + (perf_now - perf_anchor), monotonic across threads.
        # perf_counter is sampled before AND after time.time() so the
        # anchor can sit at the midpoint with a known error bound of
        # half the capture window — cross-rank merges need the bound.
        perf_before = time.perf_counter()
        epoch = time.time()
        perf_after = time.perf_counter()
        self._epoch_us = epoch * 1e6
        self._perf_anchor = (perf_before + perf_after) / 2.0
        self.anchor_error_us = (perf_after - perf_before) / 2.0 * 1e6
        self.rank = env_rank()
        self.pid = os.getpid()
        self._anchor_written = False
        # optional sampler with ``sample(phase=...)``: when wired, every
        # span append also folds one allocator read into the span's
        # memory phase (the memory ledger that reads it is A12)
        self.sampler = None
        self._lock = threading.Lock()
        self._f = None
        self._unflushed = 0
        self.flush_every = max(int(flush_every), 1)
        self.spans_written = 0
        self._closed = False

    def _now_us(self) -> float:
        return self._epoch_us + (time.perf_counter()
                                 - self._perf_anchor) * 1e6

    def record(self, name: str, *, start_perf: float, end_perf: float,
               cat: str | None = None, **attrs) -> None:
        """File one completed span given its ``perf_counter`` bounds —
        the form for call sites that already stopwatch themselves (the
        serving engine's burst timers)."""
        ts = self._epoch_us + (start_perf - self._perf_anchor) * 1e6
        self._append(span_event(name, ts_us=ts,
                                dur_us=(end_perf - start_perf) * 1e6,
                                cat=cat, **attrs))

    @contextlib.contextmanager
    def span(self, name: str, cat: str | None = None, **attrs):
        """Context-manager form: times the body, files on exit (also on
        exception — a crashed wait still shows in the timeline)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, start_perf=t0,
                        end_perf=time.perf_counter(), cat=cat, **attrs)

    # ---- file plumbing --------------------------------------------------
    def _write_anchor(self) -> None:
        """Persist the clock-anchor sidecar (caller holds the lock).
        Written lazily with the first span so span-free runs keep their
        exact artifact set."""
        anchor = {
            "schema": 1,
            "epoch_us": self._epoch_us,
            "perf_anchor_s": self._perf_anchor,
            "anchor_error_us": self.anchor_error_us,
            "rank": self.rank,
            "pid": self.pid,
        }
        tmp = self.anchor_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(anchor, f, indent=2)
        os.replace(tmp, self.anchor_path)
        self._anchor_written = True

    def _append(self, ev: dict) -> None:
        ev.setdefault("rank", self.rank)
        ev.setdefault("pid", self.pid)
        if self.sampler is not None:
            # outside the file lock: the sampler has its own, and a
            # device round-trip under the append lock would serialize
            # producer threads
            ph = phase_for_span(ev.get("name", ""), ev.get("cat"))
            if ph:
                try:
                    self.sampler.sample(phase=ph)
                except Exception:
                    pass
        with self._lock:
            if self._closed:
                return
            if self._f is None:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                self._f = open(self.path, "a")
            if not self._anchor_written:
                self._write_anchor()
            self._f.write(json.dumps(ev, default=str) + "\n")
            self.spans_written += 1
            self._unflushed += 1
            if self._unflushed >= self.flush_every:
                self._f.flush()
                self._unflushed = 0

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None


@contextlib.contextmanager
def maybe_span(stream, name: str, cat: str | None = None, **attrs):
    """``stream.span(...)`` when a stream is wired, no-op when ``stream``
    is None — the guard every runtime call site uses so spans never
    impose a telemetry dependency."""
    if stream is None:
        yield
        return
    # forwarder: the caller's literal passes through (lint checks THEM)
    with stream.span(name, cat=cat, **attrs):   # span-ok
        yield


def read_clock_anchor(run_dir: str) -> dict | None:
    """Parse ``<run_dir>/clock_anchor.json`` (missing -> None)."""
    path = os.path.join(run_dir, SpanStream.ANCHOR_FILENAME)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def read_spans(run_dir: str) -> list[dict]:
    """Parse ``<run_dir>/spans.jsonl`` (missing file -> empty list)."""
    path = os.path.join(run_dir, SpanStream.FILENAME)
    out = []
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
    return out
