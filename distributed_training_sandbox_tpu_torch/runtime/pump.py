"""Bounded async dispatch with a declared host-sync policy — the port of
the JAX package's ``runtime/pump.py`` in its ``"async"`` mode, as the
serving engine drives it.

Each dispatched step hands the pump a scalar device tensor.  On CUDA the
pump records an event behind it and blocks the host only

  * every ``sync_every`` steps,
  * when more than ``max_in_flight`` steps are pending (backpressure:
    the oldest pending step's event is waited on),
  * at ``close()``.

On the CPU the work is already done when the step returns, and resolving
a value with ``.item()`` is the only sync there is.  Every blocking
event is counted by reason.
"""

from __future__ import annotations

from collections import deque

import torch


class StepPump:
    def __init__(self, *, sync_every: int = 10, max_in_flight: int = 16):
        if max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.sync_every = max(int(sync_every), 0)
        self.max_in_flight = int(max_in_flight)
        self._pending: deque = deque()   # (step_idx, value, event | None)
        self._emitted = 0
        self._closed = False
        self.resolved: list[tuple[int, float]] = []
        self.sync_breakdown: dict[str, int] = {}

    @property
    def host_sync_count(self) -> int:
        return sum(self.sync_breakdown.values())

    def _count(self, reason: str) -> None:
        self.sync_breakdown[reason] = self.sync_breakdown.get(reason, 0) + 1

    @staticmethod
    def _event_after(value: torch.Tensor):
        if value.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(value.device))
        return ev

    def _resolve(self, idx: int, value: torch.Tensor, event) -> None:
        if event is not None:
            event.synchronize()
        self.resolved.append((idx, float(value.item())))

    def _drain(self) -> None:
        while self._pending:
            self._resolve(*self._pending.popleft())

    def emit(self, value: torch.Tensor) -> bool:
        """Record one dispatched step whose scalar result is ``value``.
        Returns True when this step was a sync point (everything up to
        it resolved)."""
        if self._closed:
            raise RuntimeError("emit() after close()")
        i = self._emitted
        self._emitted += 1
        event = self._event_after(value)
        if self.sync_every and (i + 1) % self.sync_every == 0:
            self._drain()
            self._resolve(i, value, event)
            self._count("sync_every")
            return True
        self._pending.append((i, value, event))
        if len(self._pending) > self.max_in_flight:
            self._resolve(*self._pending.popleft())
            self._count("throttle")
        return False

    def close(self) -> None:
        """Resolve every pending step (one final wait when any are)."""
        if self._closed:
            return
        self._closed = True
        if self._pending:
            self._drain()
            self._count("exit")
