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
devices and gloo the CPU.  :func:`dp_ep_axes` lays the ranks out as
the MoE step's ``dp`` × ``ep`` mesh (two axes over subgroups) and
:func:`shard_rows` takes a rank's rows of a batch sharded over several
axes at once.  The named-mesh grammar (MeshPlan: any axes, their
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


def dp_ep_axes(dp: int, ep: int) -> tuple[Axis, Axis]:
    """The ``("dp", "ep")`` axes of a ``dp`` × ``ep`` layout of the
    default group: global rank ``r = dp_index · ep + ep_index``, the
    order of the reference's ``Mesh(devices.reshape(dp, ep), ("dp",
    "ep"))``.  An ``ep`` group is ``ep`` consecutive ranks, a ``dp``
    group the ranks ``ep`` apart.  Every rank makes every subgroup (in
    one order, as ``dist.new_group`` requires) and keeps its own two.
    Without a process group both axes have one rank."""
    if not initialized():
        if dp * ep != 1:
            raise ValueError(f"dp={dp} x ep={ep} needs a process group of "
                             f"{dp * ep} ranks")
        return Axis("dp"), Axis("ep")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * ep != world:
        raise ValueError(f"dp={dp} x ep={ep} != world size {world}")
    ep_groups = [dist.new_group(list(range(d * ep, (d + 1) * ep)))
                 for d in range(dp)]
    dp_groups = [dist.new_group(list(range(e, world, ep)))
                 for e in range(ep)]
    return (Axis("dp", dp_groups[rank % ep]),
            Axis("ep", ep_groups[rank // ep]))


def shard_rows(batch, *axes):
    """This rank's contiguous rows of every tensor of ``batch``, the
    leading dim sharded over ``axes`` flattened in order (the
    reference's ``P(("dp", "ep"))``): shard index ``Σ rank_a ·
    Π size_b`` over the later axes b."""
    index, count = 0, 1
    for ax in axes:
        index = index * axis_size(ax) + axis_rank(ax)
        count *= axis_size(ax)
    B = batch[0].shape[0]
    if B % count:
        names = [resolve_axis(a).name for a in axes]
        over = (f"mesh axis {names[0]!r} size" if len(names) == 1
                else f"mesh axes {tuple(names)} of")
        raise ValueError(f"batch of {B} rows is not divisible by {over} "
                         f"{count}")
    m = B // count
    return tuple(t[index * m:(index + 1) * m] for t in batch)


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
