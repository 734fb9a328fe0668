"""Process-group bring-up and the mesh axes.

Port of the JAX package's ``utils/mesh.py`` for the axes the training
steps need.  The reference names mesh axes (``"dp"``) and asks
``lax.axis_size`` / ``lax.axis_index`` inside ``shard_map``; here an
axis is a name bound to a ``torch.distributed`` process group
(:class:`Axis`), and :func:`axis_size` / :func:`axis_rank` ask the group.
Without an initialised process group every axis has one rank, rank 0,
so single-process code runs the same functions.

:func:`init_process_group` reads what ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); run
alone it makes a one-rank group on a free local port.  NCCL serves CUDA
devices and gloo the CPU.  :func:`grid_axes` lays the ranks out as a
grid of named axes over subgroups, in the JAX mesh's device order (the
tensor- and sequence-parallel steps' ``("dp", "sp", "tp")``, the MoE
step's ``("dp", "sp", "ep")``; :func:`dp_ep_axes` is its two-axis
case), and :func:`span` finds the subgroup over several of them;
:func:`shard_rows` takes a rank's rows of a batch sharded over several
axes at once and :func:`shard_seq` its chunk of the sequence.  The
composable step's ``("dp", "fsdp", "tp")`` grid is a :func:`grid_axes`
too; the named-mesh grammar (``MeshPlan``: the axes' sizes and the
weight-update-sharding degree) is ``parallel/composable.py``'s.
"""

from __future__ import annotations

import itertools
import math
import os
import socket
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class Axis:
    """A mesh axis: its name (what error messages call it) and the
    process group that spans it (None: the default group).  ``grid``:
    the axes over every subset of its grid's axes (:func:`grid_axes`),
    keyed by the set of their names, for :func:`span`."""
    name: str = "dp"
    group: object = None
    grid: dict | None = field(default=None, compare=False, repr=False)


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


def grid_axes(names, sizes) -> dict:
    """Lay the default group out as a grid of named axes, as the
    reference's ``Mesh(devices.reshape(*sizes), names)`` orders its
    devices: global rank ``r`` is the row-major index of its
    coordinates, the last axis fastest.  Returns ``{name: Axis}``, each
    axis bound to the subgroup of the ranks that differ from this one
    in that coordinate only, in rank order (so ``axis_rank`` is the
    coordinate), and ``{"dp_sp": Axis, ...}`` for every subset of two or
    more axes (the whole grid: the default group), which :func:`span`
    finds: one collective over several axes, as ``lax.psum(x, ("dp",
    "sp"))`` is one.  Every rank makes every subgroup, in one order, as
    ``dist.new_group`` requires.  Without a process group every axis
    has one rank."""
    names, sizes = tuple(names), tuple(int(s) for s in sizes)
    n = math.prod(sizes)
    subsets = [s for k in range(1, len(names) + 1)
               for s in itertools.combinations(names, k)]
    if not initialized():
        if n != 1:
            raise ValueError(f"{_grid_str(names, sizes)} needs a process "
                             f"group of {n} ranks")
        return {"_".join(s): Axis("_".join(s)) for s in subsets}
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"{_grid_str(names, sizes)} != world size {world}")
    coords = [dict(zip(names, idx))
              for idx in itertools.product(*(range(s) for s in sizes))]
    mine = coords[dist.get_rank()]
    groups = {}
    for subset in subsets:
        others = [a for a in names if a not in subset]
        groups[subset] = None     # the whole grid: the default group
        for fixed in itertools.product(*(range(sizes[names.index(a)])
                                         for a in others)) if others else ():
            ranks = [r for r, c in enumerate(coords)
                     if all(c[a] == i for a, i in zip(others, fixed))]
            group = dist.new_group(ranks)
            if all(mine[a] == i for a, i in zip(others, fixed)):
                groups[subset] = group
    spans: dict = {}
    for subset in subsets:
        spans[frozenset(subset)] = Axis("_".join(subset), groups[subset],
                                        spans)
    return {"_".join(s): spans[frozenset(s)] for s in subsets}


def _grid_str(names, sizes) -> str:
    return " x ".join(f"{a}={s}" for a, s in zip(names, sizes))


def span(*axes) -> Axis:
    """The axis spanning ``axes`` of one grid (:func:`grid_axes`): one
    collective over it is one over all of them.  A single axis is
    itself; without a process group the span has one rank."""
    axes = tuple(resolve_axis(a) for a in axes)
    if len(axes) == 1:
        return axes[0]
    if not initialized():
        return Axis("_".join(a.name for a in axes))
    grid = axes[0].grid
    key = frozenset(a.name for a in axes)
    if grid is None or any(a.grid is not grid for a in axes) \
            or key not in grid:
        raise ValueError(f"axes {[a.name for a in axes]} are not axes of "
                         f"one grid (utils.mesh.grid_axes)")
    return grid[key]


def dp_ep_axes(dp: int, ep: int) -> tuple[Axis, Axis]:
    """The ``("dp", "ep")`` axes of a ``dp`` × ``ep`` grid
    (:func:`grid_axes`): global rank ``r = dp_index · ep + ep_index``,
    the order of the reference's ``Mesh(devices.reshape(dp, ep),
    ("dp", "ep"))``.  An ``ep`` group is ``ep`` consecutive ranks, a
    ``dp`` group the ranks ``ep`` apart."""
    g = grid_axes(("dp", "ep"), (dp, ep))
    return g["dp"], g["ep"]


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


def shard_seq(batch, axis, dim: int = 1):
    """This rank's contiguous chunk of the sequence dim ``dim`` of every
    tensor of ``batch``, sharded over ``axis`` (the reference's
    ``P(..., "sp")``): chunk ``axis_rank(axis)`` of ``axis_size(axis)``."""
    n, r = axis_size(axis), axis_rank(axis)
    S = batch[0].shape[dim]
    if S % n:
        raise ValueError(f"sequence of {S} positions is not divisible by "
                         f"mesh axis {resolve_axis(axis).name!r} size {n}")
    m = S // n
    return tuple(t.narrow(dim, r * m, m) for t in batch)


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
