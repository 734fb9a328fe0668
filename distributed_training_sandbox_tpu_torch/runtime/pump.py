"""Bounded async dispatch with a declared host-sync policy: port of the
JAX package's ``runtime/pump.py`` (``StepPump``), which the training
twins and the serving engine drive.

Each dispatched step hands the pump its loss (any scalar result) still
on the device.  On CUDA the pump copies it into pinned host memory
behind the step's work and records an event after the copy; resolving a
loss is a wait on that event, never a sync of the whole stream, so work
dispatched later keeps running.  The host blocks only

  * every step in ``mode="sync"`` (the classic loop, the A/B baseline),
  * at profile-schedule boundaries (``Profiler.pending_transition``), so
    traces bound exactly the intended steps,
  * every ``sync_every`` steps,
  * when more than ``max_in_flight`` steps are pending (backpressure:
    the oldest is retired),
  * at ``close()``.

Every blocking event is counted by reason (``sync_breakdown``), recorded
as a ``pump/<reason>`` span when the telemetry run has a span stream,
and guarded by the collective watchdog when one is given.  Resolved
losses go, in step order, to the ``TelemetryRun`` (which buffered the
deferred events), to ``PerformanceTracker.record_loss`` and to each
step's ``log`` callback.  On the CPU the work is done when the step
returns, and a wait is free.
"""

from __future__ import annotations

from collections import deque

import torch

from ..telemetry.metrics import maybe_inc
from ..telemetry.spans import maybe_span


class PendingLoss:
    """One step's result on its way to the host: on CUDA a pinned copy
    and the event recorded after it."""

    __slots__ = ("value", "host", "event", "_lf")

    def __init__(self, value):
        self.value = value
        self.host = self.event = None
        self._lf = None
        if isinstance(value, torch.Tensor) and value.device.type == "cuda":
            self.host = torch.empty(value.shape, dtype=value.dtype,
                                    pin_memory=True)
            self.host.copy_(value.detach(), non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(value.device))

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def resolve(self) -> float:
        if self._lf is None:
            self.wait()
            v = self.host if self.host is not None else self.value
            self._lf = float(v.item() if isinstance(v, torch.Tensor)
                             else v)
        return self._lf


class StepPump:
    """Drive one loop's loss retirement and sync policy::

        with TelemetryRun(...) as telem:
            with StepPump(telem=telem, tracker=tracker, mode=cfg.dispatch,
                          sync_every=cfg.sync_every,
                          max_in_flight=cfg.max_in_flight) as pump:
                for i, batch in zip(range(cfg.num_steps), prefetcher):
                    params, opt, loss = step(params, opt, batch)
                    pump.emit(loss, tokens=..., log=maybe_print)
            metrics = pump.metrics
    """

    def __init__(self, *, telem=None, tracker=None, mode: str = "async",
                 sync_every: int = 10, max_in_flight: int = 16,
                 profiler=None, watchdog=None):
        if mode not in ("async", "sync"):
            raise ValueError(f"dispatch mode must be async|sync, got {mode!r}")
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.telem = telem
        self.tracker = tracker
        self.mode = mode
        self.sync_every = max(int(sync_every), 0)
        self.max_in_flight = int(max_in_flight)
        self.watchdog = watchdog
        self.profiler = profiler if profiler is not None \
            else getattr(telem, "profiler", None)
        self._pending: deque = deque()   # (step_idx, PendingLoss, log cb)
        self._emitted = 0
        self._closed = False
        self.resolved: list[tuple[int, float]] = []  # (step_idx, loss)
        self.sync_breakdown: dict[str, int] = {}
        self.metrics: dict | None = None

    # ---- accounting ------------------------------------------------------
    @property
    def host_sync_count(self) -> int:
        return sum(self.sync_breakdown.values())

    @property
    def losses(self) -> list[float]:
        """Resolved losses in step order (complete after ``close()``)."""
        return [l for _, l in self.resolved]

    def _count(self, reason: str) -> None:
        self.sync_breakdown[reason] = self.sync_breakdown.get(reason, 0) + 1
        maybe_inc(getattr(self.telem, "metrics", None),
                  "pump_host_sync_total", reason=reason)

    def _block(self, pending: PendingLoss, step: int | None = None,
               reason: str = "sync") -> None:
        """One blocking wait at a sync point, watchdog-guarded and
        recorded as a ``pump/<reason>`` span (the reason set is closed:
        per_step, profile_boundary, sync_every, throttle, drain)."""
        with maybe_span(getattr(self.telem, "spans", None),  # span-ok
                        f"pump/{reason}", cat="pump", step=step):
            if self.watchdog is not None:
                self.watchdog.block(pending.wait, step=step)
            else:
                pending.wait()

    # ---- resolution ------------------------------------------------------
    def _resolve_one(self, idx: int, pending: PendingLoss,
                     log) -> float | None:
        try:
            lf = pending.resolve()
        except Exception:   # crash path: a poisoned value must not mask
            return None     # the original loop exception
        self.resolved.append((idx, lf))
        if self.tracker is not None:
            self.tracker.record_loss(lf)
        if log is not None:
            log(lf)
        return lf

    def _drain(self) -> None:
        """Resolve every pending loss (oldest first) and flush the
        telemetry events that were deferred on them."""
        if not self._pending:
            return
        self._block(self._pending[-1][1], step=self._pending[-1][0],
                    reason="drain")
        while self._pending:
            self._resolve_one(*self._pending.popleft())
        if self.telem is not None:
            self.telem.flush()

    # ---- the per-step call ----------------------------------------------
    def emit(self, loss, *, tokens: int | None = None, log=None,
             **extra) -> bool:
        """Record one dispatched step whose result is ``loss``.  ``log``,
        if given, is called with the resolved float at sync time.
        Returns True when this step was a full sync point (everything up
        to and including this loss resolved) — the signal the
        checkpointer rides."""
        if self._closed:
            raise RuntimeError("emit() after close()")
        i = self._emitted
        self._emitted += 1
        pending = PendingLoss(loss)
        metrics = None
        if self.tracker is not None:
            metrics = self.tracker.step(tokens or 0)
        boundary = (self.profiler is not None
                    and getattr(self.profiler, "enabled", False)
                    and self.profiler.pending_transition())
        if self.mode == "sync" or boundary or (
                self.sync_every and (i + 1) % self.sync_every == 0):
            reason = ("per_step" if self.mode == "sync"
                      else "profile_boundary" if boundary
                      else "sync_every")
            self._block(pending, step=i, reason=reason)
            self._drain()
            lf = self._resolve_one(i, pending, log)
            self._count(reason)
            if self.telem is not None:
                self.telem.step(loss=lf, tokens=tokens,
                                tracker_metrics=metrics, **extra)
            return True
        self._pending.append((i, pending, log))
        if self.telem is not None:
            # deferred: TelemetryRun buffers the event and resolves the
            # pending loss at flush time
            self.telem.step(loss=pending, tokens=tokens,
                            tracker_metrics=metrics, **extra)
        if len(self._pending) > self.max_in_flight:
            idx0, p0, log0 = self._pending.popleft()
            self._block(p0, step=idx0, reason="throttle")
            self._resolve_one(idx0, p0, log0)
            if self.telem is not None:
                self.telem.flush(up_to=1)
            self._count("throttle")
        return False

    # ---- lifecycle -------------------------------------------------------
    def close(self) -> None:
        """Drain in-flight losses (one final barrier when any are
        pending), snapshot final tracker metrics, and report the sync
        accounting into the owning TelemetryRun's summary."""
        if self._closed:
            return
        self._closed = True
        if self._pending:
            try:
                self._drain()
            finally:
                self._count("exit")
        if self.tracker is not None:
            self.metrics = self.tracker.metrics(sample_memory=True)
        if self.telem is not None:
            self.telem.host_sync_count = self.host_sync_count
            self.telem.host_sync_breakdown = dict(self.sync_breakdown)

    def __enter__(self) -> "StepPump":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
