"""In-process restart supervisor + the per-attempt driver context: port
of the JAX package's ``resilience/supervisor.py``.

  * SIGTERM is a *notice*, not a kill — the run drains the step pump,
    flushes telemetry, takes a final checkpoint and exits cleanly
    (:class:`GracefulShutdown` + ``ResilienceContext.finalize``);
  * a crash or preemption with restart budget left resumes from the
    latest checkpoint with exponential backoff (:class:`Supervisor`),
    and every segment is recorded as *lineage* — in the checkpoint
    sidecar and in each segment's ``manifest.json``, which the JAX
    package's ``telemetry.report`` renders as stitched segments.

Every training twin runs its leg body through ``Supervisor.run``; when
nothing resilience-related is configured the supervisor is inert — one
pass, no checkpoint manager.  The elastic supervisor (``--elastic``) is
ROADMAP.md queue A item A12.
"""

from __future__ import annotations

import os
import signal
import threading
import time

from .faults import FaultInjector, InjectedCrash, parse_fault_spec
from .state import Checkpointer, RunState

LINEAGE_SCHEMA_VERSION = 1


class Preempted(RuntimeError):
    """Raised after the graceful-shutdown path completed (final
    checkpoint committed, telemetry finalized) to unwind to the
    supervisor, which either restarts or exits cleanly."""

    def __init__(self, step: int, scope: str = ""):
        super().__init__(f"preempted after step {step}"
                         + (f" ({scope})" if scope else ""))
        self.step = step
        self.scope = scope


class GracefulShutdown:
    """SIGTERM -> a flag the step loop polls.  Installs only in the
    main thread (signal.signal's requirement); elsewhere — or for the
    fault injector's direct path — ``trigger()`` sets the same flag."""

    def __init__(self):
        self.requested = False
        self._prev = None
        self._installed = False

    def trigger(self, signum=None, frame=None) -> None:
        self.requested = True

    def install(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(signal.SIGTERM, self.trigger)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False

    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False


class ResilienceContext:
    """What one attempt of one leg sees.  Drivers call, in loop order:

        rs = ctx.restore(like=RunState(params=..., opt_state=...,
                                       prng_key=key))      # maybe None
        ctx.verify_contract(verdict)                       # after counts
        for i, batch in zip(range(ctx.start_step, n), pref):
            if ctx.should_stop(i):                         # faults+SIGTERM
                break
            ... step ...
            synced = pump.emit(loss, ...)
            ctx.after_step(i, synced, state_fn)            # async ckpt
        ctx.finalize(telem)    # final save; raises Preempted on SIGTERM

    Multi-leg drivers (``train.zero``) take per-leg children via
    ``ctx.scope("baseline")`` — own checkpoint subdirectory and resume
    position, shared shutdown flag / fault injector / lineage.
    """

    def __init__(self, *, attempt: int = 0, resume: bool = False,
                 ckptr: Checkpointer | None = None,
                 injector: FaultInjector | None = None,
                 shutdown: GracefulShutdown | None = None,
                 lineage: dict | None = None, label: str = "",
                 supervisor: "Supervisor | None" = None,
                 watchdog_timeout: float = 0.0,
                 heartbeat_dir: str | None = None):
        self.attempt = attempt
        self.resume = resume
        self.ckptr = ckptr
        self.injector = injector or FaultInjector(None)
        self.shutdown = shutdown or GracefulShutdown()
        self.label = label
        self._lineage = lineage if lineage is not None else {}
        self._sup = supervisor
        self.watchdog_timeout = float(watchdog_timeout or 0.0)
        self.heartbeat_dir = heartbeat_dir
        self.start_step = 0
        self.restored: RunState | None = None
        self.last_verdict = None
        self._watchdog = None
        self._heartbeat = None
        self._restored_losses: list[float] = []
        self._state_fn = None
        self._last_step: int | None = None
        self._preempted_at: int | None = None
        self._children: list[ResilienceContext] = []

    # ---- configuration-derived properties --------------------------------
    @property
    def active(self) -> bool:
        return (self.ckptr is not None or self.injector.spec is not None
                or bool(self._lineage))

    @property
    def data_cursor(self) -> int:
        """Host batches segment 1..n-1 already consumed — skip this many
        from the (deterministically rebuilt) batch stream on resume."""
        return self.restored.data_cursor if self.restored else 0

    def scope(self, label: str) -> "ResilienceContext":
        child = ResilienceContext(
            attempt=self.attempt, resume=self.resume,
            ckptr=Checkpointer(os.path.join(self.ckptr.directory, label),
                               every=self.ckptr.every,
                               keep=self.ckptr.keep,
                               fingerprint=self.ckptr.fingerprint,
                               refusals=self.ckptr.refusals)
            if self.ckptr else None,
            injector=self.injector, shutdown=self.shutdown,
            lineage=self._lineage, label=label, supervisor=self._sup,
            watchdog_timeout=self.watchdog_timeout,
            heartbeat_dir=self.heartbeat_dir)
        self._children.append(child)
        return child

    def make_watchdog(self):
        """The collective watchdog the driver hands the step pump:
        None when ``--watchdog-timeout`` is unset (zero-cost default);
        otherwise a :class:`~.elastic.Watchdog` whose timeout error
        carries this context's last contract verdict.  Also the wedge
        target of the deterministic ``hang@N`` fault."""
        if self.watchdog_timeout > 0 and self._watchdog is None:
            from .elastic import Watchdog
            self._watchdog = Watchdog(
                self.watchdog_timeout,
                context=lambda: {
                    "contract": self.last_verdict.summary()
                    if self.last_verdict is not None else None})
        return self._watchdog

    def _beat(self, step: int) -> None:
        if not self.heartbeat_dir:
            return
        if self._heartbeat is None:
            from .elastic import Heartbeat
            from ..telemetry.spans import env_rank
            self._heartbeat = Heartbeat(self.heartbeat_dir, rank=env_rank())
        self._heartbeat.beat(step)

    # ---- resume ----------------------------------------------------------
    def restore(self, like: RunState) -> RunState | None:
        """Restore the latest RunState when this attempt should resume
        (``--resume`` or a restart), else None.  Sets ``start_step`` /
        ``data_cursor`` and adopts the saved loss log so downstream
        reporting sees the stitched sequence."""
        if not (self.resume and self.ckptr is not None):
            return None
        rs = self.ckptr.restore_latest(like)
        if rs is None:
            return None
        self.restored = rs
        self.start_step = rs.step + 1
        self._restored_losses = list(rs.loss_log)
        self._scope_lineage()["resumed_from_step"] = rs.step
        # a cross-process resume carries the prior segments in the
        # checkpoint sidecar; merge them when the supervisor has none
        prior = (rs.lineage or {}).get("segments")
        if prior and self._sup is not None and not self._sup.segments:
            self._sup.segments.extend(prior)
            self._lineage["segments"] = self._sup.segments
        print(f"[resilience] resumed{' ' + self.label if self.label else ''}"
              f" from step {rs.step} in {self.ckptr.directory} "
              f"(cursor {rs.data_cursor}, {len(rs.loss_log)} losses)")
        return rs

    def verify_contract(self, verdict) -> None:
        """Re-check the strategy's collective contract after a restore —
        a resume whose choreography changed (different mesh/sharding
        than the checkpoint expects) must fail loudly, and the verdict
        is recorded in the lineage the manifest captures."""
        self.last_verdict = verdict   # the watchdog attaches this
        if verdict is None or self.restored is None:
            return
        self._scope_lineage()["resume_contract"] = {
            "ok": bool(verdict.ok), "summary": verdict.summary()}
        if not verdict.ok:
            raise SystemExit(
                f"resume aborted: collective contract re-check failed "
                f"after restore{' (' + self.label + ')' if self.label else ''}"
                f" — {verdict.summary()}; the restored state is sharded "
                f"differently than this run's step choreography expects")

    # ---- per-step --------------------------------------------------------
    def should_stop(self, i: int) -> bool:
        """Top-of-iteration check: fires any due injected fault (crash
        raises from here), then reports whether a preemption notice has
        arrived — the loop breaks and ``finalize`` handles the rest."""
        self.injector.check(i, shutdown=self.shutdown, scope=self.label,
                            watchdog=self._watchdog)
        if self.shutdown.requested:
            self._preempted_at = i - 1
            return True
        return False

    def after_step(self, i: int, synced: bool, state_fn) -> None:
        """Record step ``i`` complete; ride the pump's sync schedule for
        due asynchronous checkpoints.  ``state_fn`` is a zero-arg
        closure over the loop's live state — evaluated only when a save
        actually happens."""
        self._state_fn = state_fn
        self._last_step = i
        self._beat(i)
        if self.ckptr is not None:
            self.ckptr.maybe_save(i, lambda: self._stamped(state_fn()),
                                  synced=synced)

    def full_losses(self, new_losses) -> list[float]:
        """Restored segment losses + this segment's — the stitched
        sequence the headline bitwise test compares."""
        return self._restored_losses + [float(l) for l in new_losses]

    # ---- exit ------------------------------------------------------------
    def finalize(self, telem=None) -> None:
        """After the pump has drained: take the final checkpoint (waited
        — the resume step must be fully committed before exit), and on
        preemption finalize telemetry as status="preempted" then raise
        :class:`Preempted` for the supervisor."""
        if self.ckptr is not None and self._state_fn is not None:
            self.ckptr.save_final(self._stamped(self._state_fn()))
        preempted = self.shutdown.requested
        self._record_segment(telem, "preempted" if preempted
                             else "completed")
        if preempted:
            if telem is not None:
                telem.finalize(status="preempted")
            raise Preempted(self._preempted_at
                            if self._preempted_at is not None
                            else (self._last_step if self._last_step
                                  is not None else -1),
                            scope=self.label)

    def manifest_lineage(self) -> dict | None:
        """The lineage block for this attempt's RunManifest; None when
        resilience is inert so plain runs keep a clean manifest."""
        return self._lineage if self.active else None

    def close(self) -> None:
        """Wait out in-flight checkpoint writes — runs in the
        supervisor's finally, crash included (the torn-save guarantee).
        Then drop the loop's state closure: it holds the loop's params
        and optimizer state, and, through the loop's locals, this
        context, a cycle that would keep them alive until a collection."""
        for child in self._children:
            child.close()
        if self.ckptr is not None:
            self.ckptr.close()
        self._state_fn = None

    # ---- internals -------------------------------------------------------
    def _scope_lineage(self) -> dict:
        if not self.label:
            return self._lineage
        return self._lineage.setdefault("scopes", {}).setdefault(
            self.label, {})

    def _stamped(self, state: RunState) -> RunState:
        state.lineage = dict(state.lineage or {})
        state.lineage.update({
            "schema": LINEAGE_SCHEMA_VERSION,
            "attempt": self.attempt,
            "segments": list(self._sup.segments) if self._sup else [],
        })
        return state

    def _record_segment(self, telem, status: str) -> None:
        if self._sup is None or not self.active:
            return
        self._sup.segments.append({
            "attempt": self.attempt,
            "scope": self.label,
            "run_id": getattr(telem, "run_id", None),
            "start_step": self.start_step,
            "end_step": self._last_step,
            "status": status,
        })


class Supervisor:
    """The restart loop.  ``run(leg)`` calls ``leg(ctx)`` with a fresh
    context per attempt; :class:`Preempted` and :class:`InjectedCrash`
    consume restart budget (exponential backoff) and resume from the
    latest checkpoint; anything else propagates.  Exhausted budget after
    a preemption returns a clean ``{"status": "preempted", ...}`` result
    — the preemption contract is a clean exit, not a traceback."""

    #: failure types whose handling may restart the loop
    _restartable: tuple = (InjectedCrash,)

    def __init__(self, *, checkpoint_dir=None, checkpoint_every: int = 0,
                 resume: bool = False, max_restarts: int = 0,
                 fault: str | None = None, strategy: str = "",
                 fingerprint: dict | None = None,
                 refusals: dict | None = None, keep: int = 3,
                 backoff_s: float = 0.25, watchdog_timeout: float = 0.0,
                 heartbeat_dir: str | None = None):
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        self.max_restarts = max(int(max_restarts), 0)
        self.spec = parse_fault_spec(fault)
        self.strategy = strategy
        self.fingerprint = dict(fingerprint or {})
        self.refusals = dict(refusals or {})
        self.keep = keep
        self.backoff_s = backoff_s
        self.watchdog_timeout = float(watchdog_timeout or 0.0)
        self.heartbeat_dir = heartbeat_dir
        self.segments: list[dict] = []
        self._injector = FaultInjector(self.spec)   # shared: one-shot

    @classmethod
    def from_config(cls, cfg, strategy: str,
                    extra_fingerprint: dict | None = None,
                    refusals: dict | None = None) -> "Supervisor":
        fp = {"strategy": strategy,
              "seed": getattr(cfg, "seed", None),
              "batch_size": getattr(cfg, "batch_size", None),
              "precision": getattr(cfg, "precision", None)}
        fp.update(extra_fingerprint or {})
        for flag, on in (("--elastic", getattr(cfg, "elastic", False)),
                         ("--world-size", getattr(cfg, "world_size", 0))):
            if on:
                raise NotImplementedError(
                    f"{flag}: the elastic mesh runtime is not ported yet "
                    f"— see ROADMAP.md queue A item A12")
        return cls(
            checkpoint_dir=getattr(cfg, "checkpoint_dir", None),
            checkpoint_every=getattr(cfg, "checkpoint_every", 0),
            resume=getattr(cfg, "resume", False),
            max_restarts=getattr(cfg, "max_restarts", 0),
            fault=getattr(cfg, "inject_fault", None),
            strategy=strategy, fingerprint=fp, refusals=refusals,
            watchdog_timeout=getattr(cfg, "watchdog_timeout", 0.0) or 0.0,
            heartbeat_dir=getattr(cfg, "heartbeat_dir", None)
            or os.environ.get("DTS_HEARTBEAT_DIR"))

    @property
    def active(self) -> bool:
        return bool(self.checkpoint_dir or self.spec
                    or self.max_restarts or self.resume)

    def _make_ctx(self, attempt: int,
                  shutdown: GracefulShutdown) -> ResilienceContext:
        ckptr = Checkpointer(self.checkpoint_dir,
                             every=self.checkpoint_every,
                             keep=self.keep,
                             fingerprint=self.fingerprint,
                             refusals=self.refusals) \
            if self.checkpoint_dir else None
        lineage = {"schema": LINEAGE_SCHEMA_VERSION,
                   "attempt": attempt,
                   "max_restarts": self.max_restarts,
                   "segments": self.segments} if self.active else {}
        return ResilienceContext(
            attempt=attempt, resume=self.resume or attempt > 0,
            ckptr=ckptr, injector=self._injector, shutdown=shutdown,
            lineage=lineage, supervisor=self,
            watchdog_timeout=self.watchdog_timeout,
            heartbeat_dir=self.heartbeat_dir)

    def _on_failure(self, e, ctx, attempt: int) -> bool:
        """Handle one restartable failure; True = restart, False =
        re-raise (budget exhausted / unrecoverable)."""
        if attempt >= self.max_restarts:
            return False
        self.segments.append({
            "attempt": attempt, "scope": "", "run_id": None,
            "start_step": ctx.start_step,
            "end_step": ctx._last_step,
            "status": "crashed", "error": str(e)})
        print(f"[resilience] crashed ({e}); restart "
              f"{attempt + 1}/{self.max_restarts}")
        return True

    def run(self, leg):
        """Run ``leg(ctx)`` under the restart policy and return its
        result (or the clean preempted-status dict)."""
        attempt = 0
        with GracefulShutdown() as shutdown:
            while True:
                ctx = self._make_ctx(attempt, shutdown)
                try:
                    return leg(ctx)
                except Preempted as e:
                    if attempt >= self.max_restarts:
                        print(f"[resilience] preempted at step {e.step} "
                              f"with no restart budget left — exiting "
                              f"cleanly (resume with --resume)")
                        return {"status": "preempted", "step": e.step,
                                "scope": e.scope,
                                "lineage": {"segments": self.segments}}
                    print(f"[resilience] preempted at step {e.step}; "
                          f"restart {attempt + 1}/{self.max_restarts}")
                except self._restartable as e:
                    if not self._on_failure(e, ctx, attempt):
                        raise
                finally:
                    ctx.close()   # torn-save guarantee, every exit path
                # fresh attempt: clear a consumed preemption notice so
                # the resumed segment is not instantly re-preempted
                shutdown.requested = False
                time.sleep(min(8.0, self.backoff_s * (2 ** attempt)))
                attempt += 1
