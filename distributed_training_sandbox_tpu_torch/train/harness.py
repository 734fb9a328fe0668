"""The run harness the training twins share: their ``TrainConfig``, the
supervisor around each run, and the pieces each loop opens (telemetry
run, profiler, step pump, prefetcher), wired as the JAX package's
drivers wire them (``scripts/ddp.py``, ``scripts/train_fsdp.py``,
``scripts/_zero_driver.py``).

A twin's ``run(..., config=None)`` without a config gets
:func:`quiet_config`: no run directory, no profiler, no checkpoints, and
``dispatch="sync"`` (a host sync ends every step, so per-step times keep
their meaning).  Its ``main()`` takes the reference's flags through
``TrainConfig.from_args``, whose defaults are the reference's
(``dispatch="async"``, telemetry and profiling on).
"""

from __future__ import annotations

import dataclasses

from ..resilience import Supervisor
from ..runtime import StepPump
from ..telemetry import TelemetryRun
from ..utils.config import TrainConfig
from ..utils.profiling import ProfileSchedule, Profiler


def quiet_config(**fields) -> TrainConfig:
    """A config that writes nothing and syncs every step; ``fields``
    override any of it."""
    return TrainConfig(**{"telemetry": False, "profile": False,
                          "dispatch": "sync", **fields})


def run_config(config: TrainConfig | None, **fields) -> TrainConfig:
    """``config`` (default :func:`quiet_config`) with the run's own
    values of ``fields`` (its step count, batch, seed)."""
    return dataclasses.replace(config if config is not None
                               else quiet_config(), **fields)


def supervise(cfg: TrainConfig, strategy: str, leg,
              extra_fingerprint: dict | None = None,
              refusals: dict | None = None) -> dict:
    """``leg(ctx, holder)`` under ``Supervisor.from_config``.  The leg
    stores its stitched losses in ``holder["losses"]`` before
    ``ctx.finalize``, so a run preempted with no restart budget left
    still returns them beside ``status="preempted"``.  ``refusals``:
    fingerprint key -> why a resume across its values is refused."""
    holder: dict = {}
    sup = Supervisor.from_config(cfg, strategy, extra_fingerprint, refusals)
    res = sup.run(lambda ctx: leg(ctx, holder))
    if res.get("status") == "preempted" and "losses" not in res:
        res["losses"] = holder.get("losses", [])
    res.setdefault("status", "completed")
    res.setdefault("lineage", {"segments": sup.segments})
    return res


def track(holder: dict, *ctxs) -> None:
    """Keep each attempt's checkpointers, so the run's result can report
    every segment's saves (:func:`ckpt_report`)."""
    holder.setdefault("ckptrs", []).extend(
        c.ckptr for c in ctxs if c.ckptr is not None)


def ckpt_report(holder: dict) -> dict:
    """``saves``: every save of every segment (``step``, ``bytes``,
    ``blocking_s``, ``write_s``, ``dir``); ``restore_s``: each restore's
    seconds.  Waits for the write in flight first."""
    ckptrs = holder.get("ckptrs", [])
    for c in ckptrs:
        c.close()
    return {"saves": [{**s, "dir": c.directory} for c in ckptrs
                      for s in c.saves],
            "restore_s": [c.restore_s for c in ckptrs
                          if c.restore_s is not None]}


def profiler(cfg: TrainConfig, schedule: ProfileSchedule | None,
             default: ProfileSchedule, trace_dir: str | None = None
             ) -> Profiler | None:
    """The run's profiler when ``cfg.profile``: ``schedule``, else the
    twin's reference ``default``."""
    if not cfg.profile:
        return None
    return Profiler(trace_dir=trace_dir or cfg.trace_dir,
                    schedule=schedule or default)


def telemetry(strategy: str, cfg: TrainConfig, ctx, dev, *, model: str,
              profiler=None, extra: dict | None = None,
              **manifest) -> TelemetryRun:
    """The leg's ``TelemetryRun``, its lineage the context's;
    ``manifest``: more of its manifest's fields (``contract``,
    ``rules``)."""
    return TelemetryRun(strategy, config=cfg, device=dev, model=model,
                        lineage=ctx.manifest_lineage(), profiler=profiler,
                        extra=extra, **manifest)


def wire(telem: TelemetryRun, ctx, pref=None) -> None:
    """Point the prefetcher's and the checkpointer's spans and metrics
    at the entered telemetry run."""
    for part in (pref, ctx.ckptr):
        if part is not None:
            part.spans, part.metrics = telem.spans, telem.metrics


def pump(cfg: TrainConfig, telem, tracker, ctx) -> StepPump:
    return StepPump(telem=telem, tracker=tracker, mode=cfg.dispatch,
                    sync_every=cfg.sync_every,
                    max_in_flight=cfg.max_in_flight,
                    watchdog=ctx.make_watchdog())
