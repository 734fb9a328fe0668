"""Deterministic fault injection for the resilience runtime: port of the
JAX package's ``resilience/faults.py``.

  * ``--inject-fault crash@N`` — raise :class:`InjectedCrash` when the
    loop is about to execute step N (no final checkpoint: the recovery
    path must come from the last *periodic* save);
  * ``--inject-fault preempt@N`` — deliver a real ``SIGTERM`` to this
    process at step N, exercising the supervisor's graceful-shutdown
    path (drain pump, flush telemetry, final checkpoint, clean exit);
  * ``crash@N:label`` / ``preempt@N:label`` — scope the fault to one
    named leg of a multi-leg driver (``train.zero``'s ``baseline`` /
    ``sharded`` legs);
  * ``--inject-fault hang@N`` — wedge the collective watchdog at step
    N: the next pump sync point blocks and the watchdog converts it into
    a :class:`~.elastic.StepTimeoutError` (needs ``--watchdog-timeout``);
  * ``--inject-fault slow@N:ms`` — a straggler: sleep ``ms`` at step N;
  * the serving-fleet kinds, checked at each replica's decode *burst*
    (:meth:`FaultInjector.check_serving`), not at a training step:
    ``kill_replica@N:k`` — replica ``k`` dies at its burst N (raises
    :class:`~.elastic.WorkerLost`; the fleet re-enqueues its requests
    onto the survivors); ``hang_decode@N:k`` — replica ``k``'s watchdog
    is wedged at burst N, so that burst's sync point converts into a
    :class:`~.elastic.StepTimeoutError`; ``slow_replica@N:ms`` — a
    straggler burst: sleep ``ms`` at burst N; ``corrupt_swap`` — no
    step: the hot-swap checkpoint is torn before the fleet restores it
    (:meth:`FaultInjector.wants_corrupt_swap`), which must leave the
    fleet serving on the old weights;
  * :func:`truncate_checkpoint` / :func:`corrupt_checkpoint` — tamper
    with a saved step's files on disk (the port's DCP files), for
    pinning that a torn restore fails with a readable error.

The grammar (``FAULT_REGISTRY``, :func:`parse_fault_spec`) is the
reference's whole, so a spec parses alike in both packages.  Not ported:
the elastic kind ``kill_worker`` (ROADMAP.md queue A item A12): an
injector given one raises ``NotImplementedError``.

Faults fire exactly once per process (the injector is shared across
in-process restart attempts), so a resumed segment runs to completion.
"""

from __future__ import annotations

import os
import re
import signal
import time
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class FaultKindInfo:
    """One registered fault kind.  Everything derived from the spec
    grammar — the valid-kind tuple, the integer-target rule, the parse
    error message's examples — reads from :data:`FAULT_REGISTRY`, so a
    new kind cannot drift out of sync with its validation."""
    name: str
    int_target: bool     # :target is an integer, not a leg label
    target_what: str     # what the integer means, for error messages
    step_required: bool  # "@STEP" mandatory (False: fires at a
                         # context-defined moment, e.g. swap time)
    example: str


FAULT_REGISTRY: dict[str, FaultKindInfo] = {k.name: k for k in (
    FaultKindInfo("crash", False, "", True, "crash@5"),
    FaultKindInfo("preempt", False, "", True, "preempt@8:sharded"),
    FaultKindInfo("kill_worker", True, "worker rank", True,
                  "kill_worker@5:3"),
    FaultKindInfo("hang", False, "", True, "hang@4"),
    FaultKindInfo("slow", True, "milliseconds", True, "slow@3:50"),
    FaultKindInfo("kill_replica", True, "replica index", True,
                  "kill_replica@2:1"),
    FaultKindInfo("hang_decode", True, "replica index", True,
                  "hang_decode@2:0"),
    FaultKindInfo("slow_replica", True, "milliseconds", True,
                  "slow_replica@1:80"),
    FaultKindInfo("corrupt_swap", False, "", False, "corrupt_swap"),
)}

FAULT_KINDS = tuple(FAULT_REGISTRY)
#: kinds whose ``:target`` suffix is an integer (worker rank / replica
#: index / milliseconds), not a leg label — derived, never hand-listed
_INT_TARGET_KINDS = tuple(
    k for k, info in FAULT_REGISTRY.items() if info.int_target)
#: kinds consumed by the serving fleet (per-burst), not the train loop
SERVING_FAULT_KINDS = (
    "kill_replica", "hang_decode", "slow_replica", "corrupt_swap")
_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)(?:@(?P<step>\d+))?(?::(?P<target>[\w-]+))?$")


class InjectedCrash(RuntimeError):
    """The simulated hard failure — semantically a power cut: no
    graceful path runs, no final checkpoint is taken."""


@dataclass(frozen=True)
class FaultSpec:
    kind: str            # one of FAULT_KINDS (see FAULT_REGISTRY)
    step: int            # loop step / decode burst at which it fires
    target: str = ""     # scope label or int target ("" = any leg)

    def __str__(self) -> str:
        base = self.kind
        if FAULT_REGISTRY[self.kind].step_required:
            base = f"{base}@{self.step}"
        return f"{base}:{self.target}" if self.target else base


def parse_fault_spec(spec: str | None) -> FaultSpec | None:
    """``"crash@5"`` / ``"preempt@8:sharded"`` -> FaultSpec; None/""
    -> None.  Bad specs fail loudly (a typo'd fault flag that silently
    never fires would make a passing resilience test meaningless)."""
    if not spec:
        return None
    m = _SPEC_RE.match(spec.strip())
    if not m or m.group("kind") not in FAULT_REGISTRY:
        examples = ", ".join(
            info.example for info in FAULT_REGISTRY.values())
        raise SystemExit(
            f"--inject-fault {spec!r} not understood: expected "
            f"KIND@STEP[:target] with KIND in {'/'.join(FAULT_KINDS)} "
            f"(e.g. {examples})")
    kind, target = m.group("kind"), m.group("target") or ""
    info = FAULT_REGISTRY[kind]
    if m.group("step") is None and info.step_required:
        raise SystemExit(
            f"--inject-fault {spec!r}: {kind} needs @STEP "
            f"(e.g. {info.example})")
    if info.int_target and target and not target.isdigit():
        raise SystemExit(
            f"--inject-fault {spec!r}: {kind}'s :target is a "
            f"{info.target_what} (an integer), got {target!r}")
    return FaultSpec(kind=kind, step=int(m.group("step") or 0),
                     target=target)


class FaultInjector:
    """One-shot trigger checked at the top of every loop iteration."""

    def __init__(self, spec: FaultSpec | None):
        if spec is not None and spec.kind == "kill_worker":
            raise NotImplementedError(
                f"--inject-fault {spec}: worker loss is the elastic "
                f"runtime's, not ported yet — see ROADMAP.md queue A item "
                f"A12")
        self.spec = spec
        self.fired = False

    def check(self, step: int, shutdown=None, scope: str = "",
              watchdog=None) -> None:
        """Fire the configured fault if ``step``/``scope`` match.
        ``crash`` raises; ``preempt`` delivers SIGTERM to this process
        and returns once the handler has observed it (deterministic for
        the caller's next ``shutdown.requested`` check); ``hang`` wedges
        ``watchdog``; ``slow`` sleeps its target ms."""
        if self.fired or self.spec is None or step != self.spec.step:
            return
        if self.spec.kind in SERVING_FAULT_KINDS:
            return  # the fleet's: fired by check_serving / the swap path
        if self.spec.kind in ("crash", "preempt") \
                and self.spec.target and self.spec.target != scope:
            return
        self.fired = True
        kind = self.spec.kind
        if kind == "crash":
            raise InjectedCrash(
                f"injected crash at step {step}"
                + (f" ({scope})" if scope else ""))
        if kind == "slow":
            # every rank parses the same argv: DTS_FAULT_RANK restricts
            # the sleep to one rank (unset: every rank sleeps)
            only = os.environ.get("DTS_FAULT_RANK")
            if only is not None and only != "" and \
                    int(only) != int(os.environ.get("DTS_PROCESS_ID",
                                                    "0") or 0):
                return
            time.sleep(int(self.spec.target or "100") / 1000.0)
            return
        if kind == "hang":
            if watchdog is None:
                raise SystemExit(
                    f"--inject-fault hang@{step} needs a collective "
                    f"watchdog — pass --watchdog-timeout SECONDS > 0, "
                    f"otherwise the injected hang would block forever")
            watchdog.wedge()
            return
        os.kill(os.getpid(), signal.SIGTERM)
        # CPython runs the handler between bytecodes; wait until the
        # flag is visible so the caller's very next check sees it
        deadline = time.monotonic() + 2.0
        while shutdown is not None and not shutdown.requested \
                and time.monotonic() < deadline:
            time.sleep(0.001)

    def check_serving(self, replica: int, burst: int,
                      watchdog=None) -> None:
        """The serving fleet's twin of :meth:`check`, called before each
        replica's round with that replica's own burst counter.
        ``kill_replica`` raises :class:`~.elastic.WorkerLost` for the
        targeted replica (the fleet's failover consumes it);
        ``hang_decode`` wedges the replica's watchdog, so the burst's
        sync point converts into a :class:`~.elastic.StepTimeoutError`;
        ``slow_replica`` sleeps its target ms on whichever replica
        reaches burst N first.  ``corrupt_swap`` never fires here: the
        fleet consumes it at swap time (:meth:`wants_corrupt_swap`)."""
        if self.fired or self.spec is None:
            return
        kind = self.spec.kind
        if kind not in ("kill_replica", "hang_decode", "slow_replica"):
            return
        if burst != self.spec.step:
            return
        if kind in ("kill_replica", "hang_decode") \
                and int(self.spec.target or "0") != replica:
            return
        self.fired = True
        if kind == "slow_replica":
            time.sleep(int(self.spec.target or "100") / 1000.0)
            return
        if kind == "hang_decode":
            if watchdog is None:
                raise SystemExit(
                    f"--inject-fault hang_decode@{burst} needs a "
                    f"decode watchdog — pass --watchdog-timeout "
                    f"SECONDS > 0, otherwise the injected hang would "
                    f"block forever")
            watchdog.wedge()
            return
        from .elastic import WorkerLost
        raise WorkerLost([replica], step=burst, trigger="kill_replica")

    @staticmethod
    def unreaped(procs) -> list[int]:
        """Alias of :func:`unreaped_workers` on the injector, so fault
        call sites can verify the kill they caused was fully collected."""
        return unreaped_workers(procs)

    def wants_corrupt_swap(self) -> bool:
        """True exactly once when the configured fault is
        ``corrupt_swap``: the fleet asks at swap time and, if true,
        tears the incoming checkpoint before restoring it."""
        if self.fired or self.spec is None \
                or self.spec.kind != "corrupt_swap":
            return False
        self.fired = True
        return True


# ---- reap verification (coordinator side) --------------------------------

def unreaped_workers(procs) -> list[int]:
    """Pids of spawned workers that are NOT fully collected: either
    never waited on (``returncode`` unset) or still pinned as a zombie
    in the kernel process table.  The ``kill_worker`` fault SIGKILLs a
    real process; before the coordinator may shrink the group and
    relaunch, the kill must have been *reaped* — a zombie keeps its pid
    entry (and on a real host its device slots) and would poison the
    next attempt.  Empty list == clean teardown."""
    bad = []
    for p in procs:
        pid = getattr(p, "pid", None)
        if getattr(p, "returncode", None) is None:
            bad.append(pid)
            continue
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
        except OSError:
            continue   # no /proc entry: fully reaped (or non-Linux)
        # state is the field after the parenthesized comm (which may
        # itself contain spaces/parens — split on the LAST close-paren)
        state = stat.rsplit(")", 1)[-1].split()
        if state and state[0] == "Z":
            bad.append(pid)
    return bad


# ---- checkpoint tampering (tests + manual debugging) ---------------------

def _step_files(directory, step: int | None) -> list[Path]:
    root = Path(directory)
    if step is None:
        step_dirs = sorted((d for d in root.iterdir()
                            if d.is_dir() and d.name.isdigit()),
                           key=lambda d: int(d.name))
        if not step_dirs:
            raise FileNotFoundError(f"no checkpoint step dirs in {root}")
        root = step_dirs[-1]
    else:
        root = root / str(step)
    files = [p for p in root.rglob("*") if p.is_file()]
    if not files:
        raise FileNotFoundError(f"no files under checkpoint step {root}")
    return files


def truncate_checkpoint(directory, step: int | None = None,
                        *, keep_bytes: int = 8) -> list[Path]:
    """Truncate every file of a saved step (every rank's DCP data and
    ``.metadata``) — the torn-write shape a preemption mid-flush leaves
    behind.  Returns the mangled paths."""
    files = _step_files(directory, step)
    for p in files:
        with open(p, "r+b") as f:
            f.truncate(min(keep_bytes, p.stat().st_size))
    return files


def corrupt_checkpoint(directory, step: int | None = None) -> list[Path]:
    """Overwrite the head of every file in a saved step with garbage —
    the bit-rot/partial-overwrite shape.  Returns the mangled paths."""
    files = _step_files(directory, step)
    for p in files:
        size = p.stat().st_size
        with open(p, "r+b") as f:
            f.write(b"\xde\xad\xbe\xef" * max(1, min(size, 64) // 4))
    return files
