"""TelemetryRun: the one object a training twin holds.  Port of the JAX
package's ``telemetry/run.py``.

Around the step loop it

  * captures and writes the :class:`RunManifest` at entry;
  * appends one ``schema.step_event`` per optimizer step — every rank
    emits, rank > 0 under a ``-r<rank>`` run-id suffix — timing steps
    host-side and lifting rates from the ``PerformanceTracker`` metrics;
  * owns the live :class:`~.metrics.MetricsRegistry` (fed by the pump,
    prefetcher and checkpointer) and, when ``metrics_port`` is set, its
    Prometheus endpoint plus periodic ``metrics.jsonl`` snapshots;
  * owns the ``Profiler``: ``step()`` advances it and ``__exit__`` stops
    it on *every* path, so an exception mid-loop still exports the
    in-flight trace;
  * owns the host-phase ``SpanStream`` (``spans.jsonl``);
  * writes ``summary.json`` at exit; a crash writes status="crashed"
    with the error.

Not ported: ``attach_hlo`` / ``attach_step_hlo`` and what the reference
builds from them at finalize (the collective ledger, the memory ledger,
``split_from_trace``'s comm/compute split): ROADMAP.md queue A item A12.
Calling them raises ``NotImplementedError``; where the reference writes
their results (``comm_split``, ``ledger``, ``memory`` in
``summary.json``), a profiled run writes null.

A loss handed to :meth:`step` may be a host float or a value still on
the device — a tensor, or the step pump's pending loss, whose
``resolve()`` waits on its own event — and is then resolved at the next
:meth:`flush` (the pump's sync points), rows staying in step order.
"""

from __future__ import annotations

import os
import statistics
import time

import torch

from ..utils.config import build_run_id, default_results_dir
from .manifest import RunManifest
from .schema import step_event
from .spans import env_rank
from .writer import MetricsWriter

A12 = "ROADMAP.md queue A item A12"


def resolve_loss(loss) -> float:
    """A host float of a loss: the pump's pending loss resolves through
    its own event; a tensor through ``.item()``."""
    if hasattr(loss, "resolve"):
        return loss.resolve()
    if isinstance(loss, torch.Tensor):
        return float(loss.item())
    return float(loss)


def _deferred(loss) -> bool:
    return loss is not None and (hasattr(loss, "resolve")
                                 or isinstance(loss, torch.Tensor))


class TelemetryRun:
    def __init__(self, strategy: str, *, config=None, device=None,
                 model: str | None = None,
                 collective_counts: dict | None = None,
                 contract: dict | None = None,
                 rules: dict | None = None,
                 lineage: dict | None = None,
                 extra: dict | None = None,
                 results_dir: str | None = None,
                 run_name: str | None = None,
                 profiler=None, enabled: bool | None = None,
                 metrics_port: int | None = None,
                 metrics_snapshot_s: float = 10.0):
        self.strategy = strategy
        self.config = config
        self.device = device
        self.model = model
        self.collective_counts = collective_counts
        self.contract = contract
        self.rules = rules
        self.lineage = lineage
        self.extra = extra
        self.profiler = profiler
        if results_dir is None:
            results_dir = getattr(config, "results_dir", None) \
                or default_results_dir()
        if run_name is None:
            run_name = getattr(config, "run_name", None)
        want = getattr(config, "telemetry", True) if enabled is None \
            else enabled
        if os.environ.get("DTS_PROCESS_ID"):
            self.rank = env_rank()
        else:
            from ..utils.mesh import axis_rank
            self.rank = axis_rank()
        self.enabled = bool(want)
        self.results_dir = results_dir
        self.run_id = self._unique_run_id(results_dir, strategy, run_name,
                                          rank=self.rank)
        self.run_dir = os.path.join(results_dir, self.run_id) \
            if self.enabled else None
        if metrics_port is None:
            metrics_port = getattr(config, "metrics_port", None)
        self._metrics_port = metrics_port
        self.metrics_snapshot_s = float(metrics_snapshot_s)
        self.metrics = None
        self.metrics_server = None
        self._t_metrics_snapshot: float | None = None
        self._metrics_snapshots = 0
        if self.enabled:
            from .metrics import MetricsRegistry
            self.metrics = MetricsRegistry()
        self.writer: MetricsWriter | None = None
        self.manifest: RunManifest | None = None
        self._step_idx = 0
        self._losses: list[float] = []
        self._step_times: list[float] = []
        self._last_tracker_metrics: dict | None = None
        self._tokens_total = 0
        self._t_prev: float | None = None
        self._finalized = False
        self._deferred: list[tuple[dict, object]] = []
        self.host_sync_count: int | None = None
        self.host_sync_breakdown: dict | None = None
        self.spans = None

    @staticmethod
    def _unique_run_id(results_dir: str, strategy: str,
                       run_name: str | None, rank: int = 0) -> str:
        label = strategy if not run_name else f"{strategy}-{run_name}"
        rid = build_run_id(label)
        if rank:
            rid = f"{rid}-r{rank}"
        # second-resolution timestamps collide when two runs start in the
        # same second (a restarted segment does exactly that)
        n, base = 2, rid
        while os.path.exists(os.path.join(results_dir, rid)):
            rid = f"{base}-{n}"
            n += 1
        return rid

    # ---- lifecycle ------------------------------------------------------
    def start(self) -> "TelemetryRun":
        if self.enabled:
            extra = dict(self.extra or {})
            extra.setdefault("rank", self.rank)
            group = os.environ.get("DTS_LAUNCH_GROUP")
            if group:
                extra.setdefault("launch_group", group)
            coord = os.environ.get("DTS_COORDINATOR")
            if coord:
                extra.setdefault("coordinator", coord)
            self.manifest = RunManifest.capture(
                self.strategy, run_id=self.run_id, config=self.config,
                device=self.device, model=self.model,
                collective_counts=self.collective_counts,
                contract=self.contract, rules=self.rules,
                lineage=self.lineage, extra=extra)
            self.writer = MetricsWriter(self.run_dir)
            self.writer.write_manifest(self.manifest)
            from .spans import SpanStream
            self.spans = SpanStream(self.run_dir)
            if self._metrics_port is not None:
                from .metrics import MetricsServer
                self.metrics_server = MetricsServer(
                    self.metrics, port=int(self._metrics_port)).start()
                self._t_metrics_snapshot = time.perf_counter()
        self._t_prev = time.perf_counter()
        return self

    def attach_hlo(self, compiled_text: str) -> None:
        raise NotImplementedError(
            "the collective ledger (attach_hlo) is not ported yet — see "
            + A12)

    def attach_step_hlo(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            "the collective and memory ledgers (attach_step_hlo) are not "
            "ported yet — see " + A12)

    def __enter__(self) -> "TelemetryRun":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        # profiler first: export the in-flight trace whatever happened
        if self.profiler is not None:
            self.profiler.stop()
        if exc_type is not None:
            self.finalize(status="crashed",
                          error=f"{exc_type.__name__}: {exc}")
        else:
            self.finalize()
        return False

    # ---- per-step -------------------------------------------------------
    def step(self, *, loss=None, tokens: int | None = None,
             tracker_metrics: dict | None = None, **extra) -> None:
        """Record one optimizer step; also advances the owned profiler.
        A loss still on the device is buffered and resolved at the next
        :meth:`flush`."""
        now = time.perf_counter()
        dt = now - self._t_prev if self._t_prev is not None else None
        self._t_prev = now
        if self.profiler is not None:
            self.profiler.step()
        tm = tracker_metrics or {}
        step_time = tm.get("last_step_time_s") or dt
        extra.setdefault("rank", self.rank)
        if self.metrics is not None:
            self.metrics.inc("steps_total")
            if tokens:
                self.metrics.inc("tokens_total", int(tokens))
            if step_time is not None:
                self.metrics.set("last_step_time_s", float(step_time))
            self._maybe_snapshot_metrics(now)
        if step_time is not None:
            self._step_times.append(float(step_time))
        if tokens:
            self._tokens_total += int(tokens)
        if tm:
            self._last_tracker_metrics = tm
        idx = self._step_idx
        self._step_idx += 1
        if _deferred(loss):
            ev = step_event(idx, loss=None, tokens=tokens,
                            step_time_s=step_time,
                            tracker_metrics=tracker_metrics, **extra)
            self._deferred.append((ev, loss))
            return
        if self._deferred:       # keep steps.jsonl in step order
            self.flush()
        if loss is not None:
            self._losses.append(float(loss))
        if self.writer is not None:
            self.writer.append_step(step_event(
                idx, loss=loss, tokens=tokens, step_time_s=step_time,
                tracker_metrics=tracker_metrics, **extra))

    def _maybe_snapshot_metrics(self, now: float) -> None:
        if self.metrics_server is None or self.run_dir is None \
                or self._t_metrics_snapshot is None:
            return
        if now - self._t_metrics_snapshot < self.metrics_snapshot_s:
            return
        self._t_metrics_snapshot = now
        try:
            self.metrics.write_snapshot(
                os.path.join(self.run_dir, "metrics.jsonl"))
            self._metrics_snapshots += 1
        except OSError:
            pass

    def flush(self, up_to: int | None = None) -> None:
        """Resolve buffered deferred-loss events (oldest first; all of
        them, or the first ``up_to``) and hand them to the writer.  A
        loss that fails to resolve degrades to null rather than
        raising."""
        n = len(self._deferred) if up_to is None \
            else min(up_to, len(self._deferred))
        for _ in range(n):
            ev, arr = self._deferred.pop(0)
            try:
                lf = resolve_loss(arr)
            except Exception:   # crash path: keep the original exception
                lf = None
            if lf is not None:
                ev["loss"] = lf
                self._losses.append(lf)
            if self.writer is not None:
                self.writer.append_step(ev)
        if self.writer is not None:
            self.writer.flush()

    # ---- end-of-run -----------------------------------------------------
    def _aggregates(self) -> dict:
        out: dict = {
            "steps_recorded": self._step_idx,
            "total_tokens": self._tokens_total,
        }
        if self._losses:
            out["first_loss"] = self._losses[0]
            out["final_loss"] = self._losses[-1]
            out["avg_loss"] = sum(self._losses) / len(self._losses)
        if self._step_times:
            # median over the tail: step 0 carries the kernel builds
            times = self._step_times[1:] or self._step_times
            out["step_time_ms"] = statistics.median(times) * 1e3
            out["step_time_ms_mean"] = sum(times) / len(times) * 1e3
        tm = self._last_tracker_metrics or {}
        for k in ("tokens_per_second", "steps_per_second",
                  "tflops_per_device", "peak_memory_gb"):
            if tm.get(k) is not None:
                out[k] = tm[k]
        return out

    def finalize(self, status: str = "completed", error: str | None = None,
                 **extra) -> dict | None:
        """Write ``summary.json``.  Idempotent: explicit double calls are
        no-ops."""
        if self._finalized:
            return None
        self._finalized = True
        try:
            self.flush()
        except Exception:
            pass
        if not self.enabled or self.writer is None:
            return None
        summary: dict = {
            "run_id": self.run_id,
            "strategy": self.strategy,
            "model": self.model,
            "status": status,
        }
        if error:
            summary["error"] = error
        cfg = self.manifest.config if self.manifest else {}
        for k in ("sequence_length", "batch_size", "num_steps",
                  "precision", "seed"):
            if k in cfg:
                summary[k] = cfg[k]
        summary.update(self._aggregates())
        if self.host_sync_count is not None:
            summary["host_sync_count"] = self.host_sync_count
            summary["host_sync_breakdown"] = self.host_sync_breakdown
        summary.update(extra)
        prof = self.profiler
        if prof is not None and getattr(prof, "enabled", False):
            summary["trace_dir"] = prof.trace_dir
            owned = list(getattr(prof, "owned_sessions", None) or [])
            if owned:
                summary["profile_sessions"] = owned
            # the trace-derived verdicts are A12's: null, not absent
            summary["comm_split"] = None
            summary["ledger"] = None
            summary["memory"] = None
            if self.manifest is not None and owned:
                self.manifest.profile_sessions = owned
                self.writer.write_manifest(self.manifest)
        if self.spans is not None:
            self.spans.close()
            if self.spans.spans_written:
                summary["spans_recorded"] = self.spans.spans_written
        if self.metrics is not None and self.metrics:
            summary["metrics"] = self.metrics.snapshot()
        if self.metrics_server is not None:
            try:
                self.metrics.write_snapshot(
                    os.path.join(self.run_dir, "metrics.jsonl"))
            except OSError:
                pass
            self.metrics_server.stop()
            self.metrics_server = None
        self.writer.write_summary(summary)
        self.writer.close()
        return summary
