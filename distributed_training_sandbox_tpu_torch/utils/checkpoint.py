"""Checkpoint / resume of a rank's train state over
``torch.distributed.checkpoint`` (DCP): port of the JAX package's
``utils/checkpoint.py`` (Orbax there).

Surface, as the reference's:

    mgr = checkpoint_manager(dir, max_to_keep=3)
    save_state(mgr, step, {"params": shards, "opt": opt_state})
    state = restore_state(mgr, like={"params": shards, "opt": opt_state})

A step lives in ``<dir>/<step>/r<rank>/``: each rank writes its own DCP
checkpoint of its own tree, every key qualified by the rank
(``r<rank>/params/layers/wq``).  The port's FSDP and ZeRO shards are
plain per-rank tensors, not DTensors; one DCP save over the process
group would treat same-keyed tensors of two ranks as one replicated
tensor and keep one rank's shard.  The saves also run without
collectives (``no_dist``): an asynchronous save writes from a
background thread, and DCP's collectives there would race the training
step's on the same process group.  The ranks agree on the step to
restore with one ``all_reduce`` (:func:`agree`).

The tree is a nest of dicts, lists, tuples and NamedTuples
(``AdamState``, ``Q8``); its leaves are tensors and host scalars
(``AdamState.count``), both stored by DCP.  Restore fills the leaves of
``like`` (same structure, shapes and dtypes; the result lands on
``like``'s devices) and returns a new tree; a saved tensor comes back
bit for bit.

Asynchronous saves (``wait=False``) take the snapshot before they
return: every tensor is copied to (pinned, on CUDA) host memory and the
copy waited on, so the next step may update the live tensors in place
(``optim.adam_update`` does); only the file write runs in the
background.  One write is in flight at a time: the next save waits for
the previous one first.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading
import time
import warnings
from typing import Any

import torch
# DCP's load error derives from BaseException: callers catch it by name
from torch.distributed.checkpoint.api import CheckpointException  # noqa: F401

# ---------------------------------------------------------- tree flattening


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` of a nest of dicts, lists, tuples and
    NamedTuples (field names as path keys), in traversal order."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def unflatten(like, flat: dict[str, Any], prefix: str = ""):
    """A tree shaped like ``like`` with its leaves taken from ``flat``."""
    if isinstance(like, dict):
        return {k: unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(unflatten(v, flat, f"{prefix}/{f}" if prefix
                                      else f)
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten(v, flat, f"{prefix}/{i}" if prefix
                                    else str(i))
                          for i, v in enumerate(like))
    return flat[prefix]


# ---------------------------------------------------------- process group


def rank_world() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def agree(ok: bool) -> bool:
    """True on every rank iff ``ok`` on every rank (one MIN all_reduce;
    the identity without a process group)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return ok
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


# ---------------------------------------------------------- the manager


def _dcp():
    import torch.distributed.checkpoint as dcp
    return dcp


class CheckpointManager:
    """Step-indexed checkpoints of this rank under ``directory`` (keeps
    the newest ``max_to_keep`` steps): the Orbax manager's surface.

    ``last_save`` holds the newest save's timing and size: ``bytes``
    (this rank's tensor bytes), ``blocking_s`` (the snapshot, before the
    save returned) and ``write_s`` (the DCP write; filled when it
    ends)."""

    def __init__(self, directory, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        self.rank = rank_world()[0]
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._staging: dict[str, torch.Tensor] = {}
        self.last_save: dict | None = None
        self.saves: list[dict] = []
        os.makedirs(self.directory, exist_ok=True)

    # ---- layout ---------------------------------------------------------
    def step_dir(self, step: int, rank: int | None = None) -> str:
        r = self.rank if rank is None else rank
        return os.path.join(self.directory, str(step), f"r{r}")

    def all_steps(self) -> list[int]:
        """Steps with a directory on disk, ascending (a torn one too:
        its restore fails, and the caller falls back)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- save -----------------------------------------------------------
    def _snapshot(self, flat: dict[str, Any]) -> dict[str, Any]:
        """Copies of every tensor, taken now, into host buffers kept
        across saves (pinned when the tensor is on the card); host
        scalars as they are."""
        out: dict[str, Any] = {}
        for k, v in flat.items():
            if not isinstance(v, torch.Tensor):
                out[k] = v
                continue
            v = v.detach()
            buf = self._staging.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = torch.empty(v.shape, dtype=v.dtype,
                                  pin_memory=v.is_cuda)
                self._staging[k] = buf
            buf.copy_(v, non_blocking=v.is_cuda)
            out[k] = buf
        # the copies have landed, on every card the state lives on (a
        # pipeline's stages are on several)
        for dev in {v.device for v in flat.values()
                    if isinstance(v, torch.Tensor) and v.is_cuda}:
            torch.cuda.synchronize(dev)
        return out

    def save(self, step: int, state: Any, *, wait: bool = True) -> None:
        """Snapshot ``state`` now and write it under ``step``; with
        ``wait=False`` the write runs in the background."""
        self.wait_until_finished()
        t0 = time.perf_counter()
        flat = {f"r{self.rank}/{k}": v for k, v in flatten(state).items()}
        staged = self._snapshot(flat)
        nbytes = sum(v.numel() * v.element_size() for v in staged.values()
                     if isinstance(v, torch.Tensor))
        rec = {"step": int(step), "bytes": nbytes,
               "blocking_s": time.perf_counter() - t0, "write_s": None}
        self.last_save = rec
        self.saves.append(rec)
        path = self.step_dir(step)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)

        def write():
            t1 = time.perf_counter()
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    _dcp().save(staged, checkpoint_id=path, no_dist=True)
                self._prune()
            except BaseException as e:  # noqa: BLE001 - re-raised on wait
                self._error = e
            rec["write_s"] = time.perf_counter() - t1

        if wait:
            write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=write,
                                            name="checkpoint-writer",
                                            daemon=True)
            self._thread.start()

    def _prune(self) -> None:
        """Drop this rank's copy of the steps beyond ``max_to_keep``
        (and a step's directory once every rank's copy is gone)."""
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)
            with contextlib.suppress(OSError):
                os.rmdir(os.path.join(self.directory, str(old)))

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    # ---- restore --------------------------------------------------------
    def restore(self, step: int, like: Any) -> Any:
        """Step ``step`` of this rank into ``like``'s structure, shapes,
        dtypes and devices."""
        flat_like = flatten(like)
        target: dict[str, Any] = {}
        for k, v in flat_like.items():
            key = f"r{self.rank}/{k}"
            target[key] = (torch.empty(v.shape, dtype=v.dtype)
                           if isinstance(v, torch.Tensor) else v)
        path = self.step_dir(step)
        if not os.path.isfile(os.path.join(path, ".metadata")):
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            _dcp().load(target, checkpoint_id=path, no_dist=True)
        out = {}
        for k, v in flat_like.items():
            got = target[f"r{self.rank}/{k}"]
            out[k] = got.to(v.device) if isinstance(v, torch.Tensor) else got
        return unflatten(like, out)


def checkpoint_manager(directory, *, max_to_keep: int = 3
                       ) -> CheckpointManager:
    """A step-indexed manager (keeps the newest ``max_to_keep`` steps)."""
    return CheckpointManager(directory, max_to_keep=max_to_keep)


def save_state(mgr: CheckpointManager, step: int, state: Any,
               *, wait: bool = True) -> None:
    """Save a tree of tensors under ``step``.  ``wait=False`` leaves the
    write async; call ``mgr.wait_until_finished()`` before exiting."""
    mgr.save(step, state, wait=wait)


@contextlib.contextmanager
def closing(mgr: CheckpointManager):
    """Guarantee ``wait_until_finished()`` on EVERY exit path — the
    async-save safety contract."""
    try:
        yield mgr
    finally:
        mgr.wait_until_finished()


def latest_step(mgr: CheckpointManager) -> int | None:
    return mgr.latest_step()


def restore_state(mgr: CheckpointManager, *, like: Any,
                  step: int | None = None) -> Any:
    """Restore the newest (or given) step into ``like``'s structure."""
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {mgr.directory}")
    return mgr.restore(step, like)


def restore_params(ckpt_dir, params, *, tag: str = "restore"):
    """Open ``ckpt_dir``, restore the newest step's ``{"params": ...}``
    into ``params``' structure, print "restored step N from DIR" under
    ``tag``, and return ``(restored_params, step)``.  Raises SystemExit
    when the directory holds no steps."""
    mgr = checkpoint_manager(ckpt_dir)
    step = latest_step(mgr)
    if step is None:
        raise SystemExit(f"no checkpoint steps in {ckpt_dir}")
    state = restore_state(mgr, like={"params": params})
    print(f"[{tag}] restored step {step} from {ckpt_dir}")
    return state["params"], step
