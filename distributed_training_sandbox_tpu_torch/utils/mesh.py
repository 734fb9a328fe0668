"""Process-group bring-up and the data-parallel axis.

Port of the JAX package's ``utils/mesh.py`` for the one axis the FSDP
slice needs.  The reference names mesh axes (``"dp"``) and asks
``lax.axis_size`` / ``lax.axis_index`` inside ``shard_map``; here an
axis is a name bound to a ``torch.distributed`` process group
(:class:`Axis`), and :func:`axis_size` / :func:`axis_rank` ask the group.
Without an initialised process group every axis has one rank, rank 0,
so single-process code runs the same functions.

:func:`init_process_group` reads what ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); run
alone it makes a one-rank group on a free local port.  NCCL serves CUDA
devices and gloo the CPU.  The named-mesh grammar (several axes, their
products) belongs to the composable slice (ROADMAP.md queue A item 10).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class Axis:
    """A mesh axis: its name (what error messages call it) and the
    process group that spans it (None: the default group)."""
    name: str = "dp"
    group: object = None


def resolve_axis(axis) -> Axis:
    """A name (bound to the default group) or an :class:`Axis`."""
    return axis if isinstance(axis, Axis) else Axis(str(axis))


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def axis_size(axis="dp") -> int:
    """Ranks along ``axis``; 1 when no process group is initialised."""
    if not initialized():
        return 1
    return dist.get_world_size(resolve_axis(axis).group)


def axis_rank(axis="dp") -> int:
    """This process's rank along ``axis``; 0 when no process group is
    initialised."""
    if not initialized():
        return 0
    return dist.get_rank(resolve_axis(axis).group)


def global_rank(axis, rank: int) -> int:
    """The default group's rank of ``axis``'s rank ``rank`` (what
    point-to-point calls name)."""
    group = resolve_axis(axis).group
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(device=None, *, timeout_s: float = 600.0
                       ) -> torch.device:
    """Join (or make) the default process group and return this rank's
    device.  ``device``: None or ``"cuda"`` → ``cuda:LOCAL_RANK`` over
    NCCL; ``"cpu"`` → the CPU over gloo.  Under ``torchrun`` the rank,
    world size and rendezvous come from its environment; without it a
    one-rank group is made on a free local port.  An already
    initialised group is kept."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if initialized():
        return dev
    if "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = int(os.environ["MASTER_PORT"])
    else:
        rank, world, addr, port = 0, 1, "127.0.0.1", free_port()
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world,
        timeout=timedelta(seconds=timeout_s), **kw)
    return dev


def destroy_process_group() -> None:
    if initialized():
        dist.destroy_process_group()
