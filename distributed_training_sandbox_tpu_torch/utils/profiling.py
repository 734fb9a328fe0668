"""Schedule-driven ``torch.profiler`` sessions: port of the JAX package's
``utils/profiling.py``.

The reference drives ``jax.profiler.start_trace / stop_trace`` from a
``(skip_first, wait, warmup, active, repeat)`` state machine
(:class:`ProfileSchedule`, kept here as it is).  :class:`Profiler`
starts a ``torch.profiler.profile`` (CPU, and CUDA when a card is
present; ``record_shapes`` only where asked, for a run whose collective
ledger reads the payloads back, since it adds host work to every op) at
exactly the schedule's transitions and, at each stop, exports
a Chrome trace into a session directory of its own under ``trace_dir``
(``plugins/profile/<timestamp>/``, the layout the reference's traces
take), recording the directories it owns.  ``torch.profiler.schedule``
is not used: its phase arithmetic is not the reference's.  Warmup steps
are traced too, as the reference traces them.  :func:`annotate` and
:func:`scope` map to ``torch.profiler.record_function``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import time
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ProfileSchedule:
    """skip_first → (wait → warmup+active)×repeat, as in torch.profiler.

    The reference's DDP/zero schedule: skip_first=5, wait=1, warmup=2,
    active=5, repeat=1; fsdp uses wait=5, warmup=5, active=10.
    """
    skip_first: int = 5
    wait: int = 1
    warmup: int = 2
    active: int = 5
    repeat: int = 1

    def phase(self, step: int) -> str:
        """Phase for 0-based step index: 'skip' | 'wait' | 'trace' | 'done'."""
        if step < self.skip_first:
            return "skip"
        s = step - self.skip_first
        cycle = self.wait + self.warmup + self.active
        if self.repeat and s >= cycle * self.repeat:
            return "done"
        pos = s % cycle
        return "wait" if pos < self.wait else "trace"


def default_trace_dir() -> str:
    """TRACE_DIR env contract: the launcher exports TRACE_DIR, scripts
    default to ./profiler_traces."""
    return os.environ.get("TRACE_DIR",
                          os.environ.get("DDP_TRACE_DIR", "./profiler_traces"))


def _rank() -> int:
    from .mesh import axis_rank
    return axis_rank()


class Profiler:
    """Schedule-driven ``torch.profiler`` session.  Call ``step()`` once
    per training step.  Rank 0 traces unless ``enabled`` says otherwise,
    as every reference script does.  After a window closes,
    ``last_profile`` holds its ``torch.profiler.profile`` (for
    ``key_averages()`` / ``events()``), ``owned_sessions`` the session
    directories this profiler wrote, newest last, and ``windows`` each
    window's host-clock seconds (start to stop, the device drained) and
    ``window_steps`` the steps each window traced."""

    def __init__(self, trace_dir: str | None = None,
                 schedule: ProfileSchedule | None = None,
                 enabled: bool | None = None, record_shapes: bool = False):
        self.trace_dir = trace_dir or default_trace_dir()
        self.record_shapes = record_shapes
        self.schedule = schedule or ProfileSchedule()
        self.enabled = (_rank() == 0) if enabled is None else enabled
        self._step = 0
        self._tracing = False
        self._prof = None
        self.last_profile = None
        self.owned_sessions: list[str] = []
        self.trace_files: list[str] = []
        self.windows: list[float] = []
        self.window_steps: list[int] = []
        self._traced = 0
        self._t_start = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def pending_transition(self) -> bool:
        """True iff the NEXT ``step()`` call will start or stop a trace.
        The async step pump barriers exactly there, so traces bound the
        intended steps even with work in flight."""
        if not self.enabled:
            return False
        return (self.schedule.phase(self._step + 1) == "trace") \
            != self._tracing

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts,
                                            record_shapes=self.record_shapes)
        self._prof.start()
        self._t_start = time.perf_counter()
        self._traced = 0
        self._tracing = True

    def _finish(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()   # the window's device work, whole
        self.windows.append(time.perf_counter() - self._t_start)
        self.window_steps.append(self._traced)
        self._prof.stop()
        self._tracing = False
        stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S_%f")
        session = os.path.join(self.trace_dir, "plugins", "profile", stamp)
        n, base = 2, session
        while os.path.exists(session):
            session = f"{base}_{n}"
            n += 1
        os.makedirs(session)
        path = os.path.join(
            session, f"{socket.gethostname()}.r{_rank()}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        self.owned_sessions.append(session)
        self.trace_files.append(path)
        self.last_profile, self._prof = self._prof, None

    def step(self) -> None:
        if not self.enabled:
            return
        self._traced += self._tracing   # the step that just ended
        self._step += 1
        phase = self.schedule.phase(self._step)  # phase of the *next* step
        if phase == "trace" and not self._tracing:
            os.makedirs(self.trace_dir, exist_ok=True)
            self._start()
        elif phase in ("wait", "done", "skip") and self._tracing:
            self._finish()

    def stop(self) -> None:
        if self._tracing:
            self._finish()


@contextlib.contextmanager
def annotate(name: str):
    """Host-side phase marker (the reference's ``record_function`` phase
    labels): a span in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


def scope(name: str):
    """Marker around device work: the ops launched inside it attribute to
    ``name`` in the trace (the reference's ``jax.named_scope``)."""
    return torch.profiler.record_function(name)
