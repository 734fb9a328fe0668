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

from ..analysis.contracts import (CONTRACTS, ContractContext,
                                  ContractVerdict, check_counts)
from ..ops.collectives import COLLECTIVES
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
             default: ProfileSchedule, trace_dir: str | None = None,
             record_shapes: bool = False) -> Profiler | None:
    """The run's profiler when ``cfg.profile``: ``schedule``, else the
    twin's reference ``default``; ``record_shapes`` for a leg whose
    collective ledger reads the payloads."""
    if not cfg.profile:
        return None
    return Profiler(trace_dir=trace_dir or cfg.trace_dir,
                    schedule=schedule or default,
                    record_shapes=record_shapes)


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


class Verdict:
    """A twin's collective contract, judged on the first step of each
    segment as the reference's scripts judge the compiled step: the
    verdict's ``summary()`` printed (rank 0), the verdict handed to the
    resilience context's ``verify_contract`` (a resume whose calls break
    the contract stops there), its ``to_dict()`` put in the manifest's
    ``contract``, and that step's calls (``COLLECTIVES.sites()``) handed
    with the verdict's expected counts to the telemetry run's collective
    ledger (``attach_sites``; a profiled run joins its trace to them).

    ``strategy`` names the contract (``contract`` another one, say a
    generated one); ``params``, ``axes``, ``n_layers`` and ``extra`` (the
    knobs) make its ``ContractContext``.  Around each step the loop calls
    :meth:`begin` and then :meth:`end`, which returns the step's counts.
    ``filed=False``: the sites and the verdict's expected counts go to
    the ledger, and the verdict nowhere else (a mode the reference's
    script files no verdict for)."""

    def __init__(self, strategy: str, *, params=None, axes=None,
                 n_layers: int = 0, contract=None, label: str = "",
                 rank: int = 0, log=print, filed: bool = True, **extra):
        self.contract = contract or CONTRACTS[strategy]
        self.ctx = ContractContext.capture(params=params, axes=axes,
                                           n_layers=n_layers, **extra)
        self.label, self.rank, self.log = label or strategy, rank, log
        self.filed = filed
        self.verdict: ContractVerdict | None = None
        self.counts: list[dict] = []

    def begin(self) -> None:
        COLLECTIVES.reset()
        if self.verdict is None:
            COLLECTIVES.capture()

    def end(self, telem, ctx) -> dict:
        counts = COLLECTIVES.read()
        self.counts.append(counts)
        if self.verdict is None:
            sites = COLLECTIVES.sites()
            v = self.verdict = check_counts(self.contract, counts,
                                            self.ctx)
            if self.filed:
                if self.rank == 0:
                    self.log(f"[{self.label}] contract[{v.strategy}]: "
                             f"{v.summary()}")
                ctx.verify_contract(v)
                telem.file_contract(v.to_dict())
            telem.attach_sites(sites, v.expected, v.strategy)
        return counts

    @property
    def holds(self) -> bool:
        """The first step's verdict is ok and every step of the segment
        made the same calls (no step run: nothing to break it)."""
        return (self.verdict is None or self.verdict.ok) and all(
            c == self.counts[0] for c in self.counts)

    def result(self) -> dict:
        """What a twin's result carries: the verdict's dict (None when
        the segment ran no step) and whether it holds."""
        filed = self.verdict is not None and self.filed
        return {"contract": self.verdict.to_dict() if filed else None,
                "contract_ok": self.holds}
