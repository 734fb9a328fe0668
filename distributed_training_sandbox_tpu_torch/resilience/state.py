"""RunState: the strategy-agnostic unit of resumability.  Port of the JAX
package's ``resilience/state.py``.

Resuming bit-exactly needs, beyond this rank's params and optimizer
state, the host-side position of the run: which batch the loop would
consume next (``data_cursor``), the run's random roots (``prng_key``: the
seed's generator states, a dict of ``torch.Generator.get_state()``
tensors; a resume under a different seed must fail loudly, not silently
fork the trajectory), the last completed step, and the loss sequence so
far.

Tensor leaves and host scalars (``AdamState.count``) travel through
``utils/checkpoint.py`` (DCP, one checkpoint a rank); the step, cursor,
loss log and lineage ride in a ``runstate-<step>.json`` sidecar that
rank 0 writes beside the step directory after the save's snapshot, with
the reference's keys.  The sidecar's fingerprint carries the world size:
restoring into another world is elastic resharding (ROADMAP.md queue A
item A12) and is refused.

:class:`Checkpointer` is the driver-facing policy object: ``--checkpoint
-every N`` saves are asynchronous and deferred to the step pump's next
sync point; ``close()`` waits for the write in flight on every exit
path.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any

import torch

from ..telemetry.metrics import maybe_inc
from ..telemetry.spans import maybe_span
from ..utils import checkpoint as C

STATE_SCHEMA_VERSION = 1
A12 = "ROADMAP.md queue A item A12"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step exists on disk but cannot be restored (torn
    write, truncation, bit rot).  The message names the step and
    directory and says what to do next."""


@dataclass
class RunState:
    """Everything one strategy run needs to resume bit-exactly.

    ``params``/``opt_state`` are this rank's trees; ``prng_key`` the
    run's generator states (a dict of uint8 tensors, or None); the rest
    is host data.  ``step`` is the LAST COMPLETED step index;
    ``data_cursor`` counts host batches the loop has consumed — the
    prefetcher may have pulled further ahead, which is why the loop-side
    cursor is the thing saved."""

    params: Any
    opt_state: Any = None
    step: int = -1
    data_cursor: int = 0
    prng_key: Any = None
    loss_log: list = field(default_factory=list)
    lineage: dict = field(default_factory=dict)

    def array_tree(self) -> dict:
        tree = {"params": self.params}
        if self.opt_state is not None:
            tree["opt"] = self.opt_state
        if self.prng_key is not None:
            tree["prng"] = self.prng_key
        return tree


def generator_states(seeds: dict, device=None) -> dict:
    """``{name: state}`` of a ``torch.Generator`` on ``device`` seeded
    with each of ``seeds`` (``{name: seed}``): the roots the run's draws
    come from, the port's ``prng_key``."""
    dev = torch.device("cpu" if device is None else device)
    return {n: torch.Generator(device=dev).manual_seed(int(s)).get_state()
            for n, s in seeds.items()}


def _meta_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"runstate-{step}.json")


def _write_meta(directory: str, state: RunState,
                fingerprint: dict | None) -> None:
    meta = {
        "schema": STATE_SCHEMA_VERSION,
        "step": int(state.step),
        "data_cursor": int(state.data_cursor),
        "loss_log": [float(l) for l in state.loss_log],
        "lineage": state.lineage or {},
        "has_opt": state.opt_state is not None,
        "has_prng": state.prng_key is not None,
        "fingerprint": fingerprint or {},
    }
    path = _meta_path(directory, state.step)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)   # atomic: a reader sees old-or-new, never torn


def save_run_state(mgr, state: RunState, *, wait: bool = False,
                   fingerprint: dict | None = None) -> None:
    """Save ``state`` under its step.  The snapshot is taken before this
    returns (so the next step may update the tensors in place); with
    ``wait=False`` only the file write is left running.  Rank 0 writes
    the sidecar right after the snapshot."""
    C.save_state(mgr, state.step, state.array_tree(), wait=wait)
    if mgr.rank == 0:
        _write_meta(mgr.directory, state, fingerprint)


def _read_meta(directory: str, step: int) -> dict | None:
    try:
        with open(_meta_path(directory, step)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def restore_run_state(mgr, *, like: RunState,
                      step: int | None = None) -> RunState:
    """Restore the newest (or given) step into ``like``'s structure and
    devices.  A torn or corrupted step raises
    :class:`CheckpointCorruptError` with a readable message."""
    directory = mgr.directory
    if step is None:
        step = C.latest_step(mgr)
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps in {directory}")
    meta = _read_meta(directory, step) or {}
    tree = {"params": like.params}
    if meta.get("has_opt", like.opt_state is not None) \
            and like.opt_state is not None:
        tree["opt"] = like.opt_state
    if meta.get("has_prng", like.prng_key is not None) \
            and like.prng_key is not None:
        tree["prng"] = like.prng_key
    try:
        restored = C.restore_state(mgr, like=tree, step=step)
    except (Exception, C.CheckpointException) as e:  # noqa: BLE001
        raise CheckpointCorruptError(
            f"failed to restore step {step} from {directory}: "
            f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else e}"
            f" — the checkpoint is torn or corrupted; delete "
            f"{os.path.join(directory, str(step))} to fall back to an "
            f"earlier step, or restart without --resume") from e
    return RunState(
        params=restored["params"],
        opt_state=restored.get("opt"),
        prng_key=restored.get("prng"),
        step=int(meta.get("step", step)),
        data_cursor=int(meta.get("data_cursor", step + 1)),
        loss_log=list(meta.get("loss_log", [])),
        lineage=dict(meta.get("lineage", {})),
    )


def _same_prng(a, b) -> bool:
    fa, fb = C.flatten(a), C.flatten(b)
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].cpu(), fb[k].cpu()) if isinstance(fa[k],
                                                             torch.Tensor)
        else fa[k] == fb[k] for k in fa)


class Checkpointer:
    """Policy + lifecycle around one run's checkpoint directory.

    ``maybe_save`` marks a step due every ``every`` steps but only
    writes at the next pump sync point (``synced=True``),
    asynchronously; ``save`` is the unconditional form; ``close()``
    waits for the write in flight (the supervisor calls it from a
    finally)."""

    def __init__(self, directory, *, every: int = 0, keep: int = 3,
                 fingerprint: dict | None = None,
                 refusals: dict | None = None):
        self.directory = os.path.abspath(os.fspath(directory))
        self.every = max(int(every), 0)
        self.keep = keep
        self.fingerprint = dict(fingerprint or {})
        # fingerprint key -> why a resume across its values is refused
        self.refusals = dict(refusals or {})
        self._mgr = None
        self._due = False
        self._saved_steps: set[int] = set()
        self.spans = None     # late-assigned: ``ckpt.spans = telem.spans``
        self.metrics = None   # late-assigned: ``ckpt.metrics = ...``
        self.restore_s: float | None = None

    @property
    def mgr(self) -> C.CheckpointManager:
        if self._mgr is None:
            self._mgr = C.checkpoint_manager(self.directory,
                                             max_to_keep=self.keep)
        return self._mgr

    @property
    def saves(self) -> list[dict]:
        """Each save's ``bytes``, ``blocking_s`` and ``write_s``."""
        return list(self._mgr.saves) if self._mgr is not None else []

    def full_fingerprint(self) -> dict:
        """The run's fingerprint and the world size at this moment (the
        process group may come up after the checkpointer is made)."""
        return {**self.fingerprint, "world_size": C.rank_world()[1]}

    # ---- restore --------------------------------------------------------
    def _check_fingerprint(self, meta: dict) -> None:
        saved_fp = meta.get("fingerprint") or {}
        fp = self.full_fingerprint()
        have_ws = saved_fp.get("world_size")
        want_ws = fp["world_size"]
        if have_ws is not None and want_ws is not None and have_ws != want_ws:
            raise SystemExit(
                f"cannot resume from {self.directory}: the checkpoint was "
                f"written by {have_ws} ranks and this run has {want_ws} — "
                f"restoring into another world size is elastic resharding, "
                f"not ported yet (see {A12})")
        for k, want in fp.items():
            have = saved_fp.get(k)
            if have is not None and want is not None and have != want:
                if k in self.refusals:
                    raise SystemExit(
                        f"cannot resume from {self.directory}: checkpoint "
                        f"was written with {k}={have!r}, this run has "
                        f"{k}={want!r} — {self.refusals[k]}")
                raise SystemExit(
                    f"cannot resume from {self.directory}: checkpoint "
                    f"was written with {k}={have!r}, this run has "
                    f"{k}={want!r} — resuming would silently fork the "
                    f"trajectory (rerun with the original {k}, or a "
                    f"fresh --checkpoint-dir)")

    def restore_latest(self, like: RunState) -> RunState | None:
        """Latest *intact* RunState, or None when the directory holds no
        steps.  Verifies the saved fingerprint (seed, precision, batch,
        world size) against this run's.  A torn or corrupted newest step
        is SKIPPED with a warning and the previous intact one restored;
        the ranks skip together (``checkpoint.agree``).  Only when every
        step is corrupt does the error propagate."""
        import time
        if not os.path.isdir(self.directory):
            return None
        self.mgr.wait_until_finished()
        steps = sorted(self.mgr.all_steps(), reverse=True)
        if not steps:
            return None
        last_err: CheckpointCorruptError | None = None
        for step in steps:
            self._check_fingerprint(_read_meta(self.directory, step) or {})
            t0 = time.perf_counter()
            state, err = None, None
            try:
                state = restore_run_state(self.mgr, like=like, step=step)
            except CheckpointCorruptError as e:
                err = e
            if not C.agree(err is None):
                print(f"[resilience] WARNING: checkpoint step {step} in "
                      f"{self.directory} is torn or corrupt — skipping it"
                      f" and falling back to the previous intact step")
                last_err = err or CheckpointCorruptError(
                    f"step {step} in {self.directory} is torn or corrupt "
                    f"on another rank")
                continue
            if like.prng_key is not None and state.prng_key is not None \
                    and not _same_prng(like.prng_key, state.prng_key):
                raise SystemExit(
                    f"cannot resume from {self.directory}: the "
                    f"checkpointed generator states differ from this "
                    f"run's (different --seed?) — the resumed data/"
                    f"init stream would not match the original run")
            self.restore_s = time.perf_counter() - t0
            self._saved_steps.add(step)
            return state
        raise last_err

    # ---- save policy ----------------------------------------------------
    def maybe_save(self, i: int, state_fn, *, synced: bool) -> bool:
        """Call once per completed step ``i``.  Marks a save due every
        ``every`` steps; performs it (async) at the first due step where
        the pump has synced."""
        if self.every and (i + 1) % self.every == 0:
            self._due = True
        if self._due and synced:
            self.save(state_fn(), wait=False)
            self._due = False
            return True
        return False

    def save(self, state: RunState, *, wait: bool = False) -> None:
        if state.step in self._saved_steps:
            return
        fp = self.full_fingerprint()
        state.lineage.setdefault("fingerprint", {}).update(fp)
        with maybe_span(self.spans, "checkpoint/save", cat="checkpoint",
                        step=int(state.step), wait=bool(wait)):
            save_run_state(self.mgr, state, wait=wait, fingerprint=fp)
        maybe_inc(self.metrics, "checkpoint_saves_total")
        self._saved_steps.add(state.step)
        self._prune_meta()

    def save_final(self, state: RunState) -> None:
        """The exit/preemption save: unconditional, then waits."""
        self.save(state, wait=True)

    def _prune_meta(self) -> None:
        """Drop sidecars of steps the manager already pruned."""
        if self.mgr.rank != 0:
            return
        try:
            live = set(self.mgr.all_steps())
            for name in os.listdir(self.directory):
                if name.startswith("runstate-") and name.endswith(".json"):
                    step = int(name[len("runstate-"):-len(".json")])
                    if step not in live:
                        os.unlink(os.path.join(self.directory, name))
        except (OSError, ValueError):
            pass

    # ---- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Wait for the write in flight.  Idempotent."""
        if self._mgr is not None:
            self._mgr.wait_until_finished()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
