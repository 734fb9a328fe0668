"""Collective bus-bandwidth microbenchmark.

Port of the JAX package's ``ops/busbench.py``: per collective and
payload, the time of one call and its algorithm and bus bandwidth, in
the nccl-tests accounting, so the numbers compare with NCCL's own:

    all_reduce      busbw = algbw · 2(n-1)/n
    all_gather      busbw = algbw · (n-1)/n     (algbw over the *full* tensor)
    reduce_scatter  busbw = algbw · (n-1)/n
    ppermute        busbw = algbw    (every link carries the payload)
    all_to_all      busbw = algbw · (n-1)/n

The collectives are ``ops/collectives.py``'s, over the process group of
``utils.mesh``: NCCL between cards, gloo on the CPU.  On a card each
collective is timed with CUDA events around ``iters`` calls after
``warmup``; on gloo with the host clock between two barriers.  At one
rank a collective moves no byte over a link: NCCL copies the buffer,
and ``ppermute_ring`` returns its input without a call, so a one-rank
sweep times copies and no bandwidth of a link.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass

import torch
import torch.distributed as dist

from ..utils import mesh
from . import collectives as C

COLLECTIVE_NAMES = ("all_reduce", "all_gather", "reduce_scatter",
                    "ppermute", "all_to_all")


@dataclass
class BusResult:
    collective: str
    payload_bytes: int
    n_devices: int
    time_ms: float
    algbw_gbps: float
    busbw_gbps: float

    def to_dict(self):
        return asdict(self)


def bus_factor(name: str, n: int) -> float:
    """nccl-tests busbw/algbw wire factor for an ``n``-rank collective."""
    if n <= 1:
        return 1.0
    if name == "all_reduce":
        return 2.0 * (n - 1) / n
    if name in ("all_gather", "reduce_scatter", "all_to_all"):
        return (n - 1) / n
    return 1.0  # ppermute / collective_permute


def payload_elems(payload_bytes: int, n: int, itemsize: int) -> int:
    """The nccl-tests sizing of the reference: ``payload // itemsize``
    elements, at least n, rounded down to a multiple of n."""
    nelems = max(payload_bytes // itemsize, n)
    return nelems - nelems % n


def make_input(name: str, nelems: int, rank: int, n: int, dtype, device):
    """Rank ``rank``'s buffer: ``nelems`` elements (all_gather: its
    ``nelems / n``), small integers that depend on the rank and the
    position, so every sum of n ≤ 8 of them is exact in bf16 and a
    chunk sent to the wrong place shows."""
    size = nelems // n if name == "all_gather" else nelems
    i = torch.arange(size, device=device)
    return ((i % 13) + 3 * rank).to(dtype)


def collective_fn(name: str, axis="dp"):
    """``x -> out``: one call of the named collective along ``axis``."""
    return {"all_reduce": lambda x: C.all_reduce(x, axis),
            "all_gather": lambda x: C.all_gather(x, axis),
            "reduce_scatter": lambda x: C.reduce_scatter(x, axis),
            "ppermute": lambda x: C.ppermute_ring(x, axis),
            "all_to_all": lambda x: C.all_to_all(x, axis)}[name]


def _barrier(axis) -> None:
    if mesh.initialized():
        dist.barrier(group=mesh.resolve_axis(axis).group)


@torch.no_grad()
def bench_collective(name: str, payload_bytes: int, axis="dp", *,
                     dtype=torch.bfloat16, iters: int = 10, warmup: int = 3,
                     device=None) -> BusResult:
    """Time one collective at ``payload_bytes`` of total payload (the full
    logical tensor, as nccl-tests sizes all_reduce): every rank holds a
    full buffer, all_gather's ranks ``1 / n`` of it each.  ``device``:
    where the buffer lives (default: the current CUDA device under NCCL,
    else the CPU)."""
    n, rank = mesh.axis_size(axis), mesh.axis_rank(axis)
    if device is None:
        cuda = mesh.initialized() and dist.get_backend() == "nccl"
        device = (torch.device("cuda", torch.cuda.current_device())
                  if cuda else torch.device("cpu"))
    device = torch.device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nelems = payload_elems(payload_bytes, n, itemsize)
    x = make_input(name, nelems, rank, n, dtype, device)
    fn = collective_fn(name, axis)
    for _ in range(warmup):
        fn(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        _barrier(axis)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        _barrier(axis)
        dt = (time.perf_counter() - t0) / iters
    algbw = nelems * itemsize / dt / 1e9
    return BusResult(collective=name, payload_bytes=nelems * itemsize,
                     n_devices=n, time_ms=dt * 1e3, algbw_gbps=algbw,
                     busbw_gbps=algbw * bus_factor(name, n))


def run_sweep(payloads=(1 << 20, 16 << 20, 128 << 20), axis="dp",
              collectives=COLLECTIVE_NAMES, **kw) -> list[BusResult]:
    return [bench_collective(c, p, axis, **kw)
            for c in collectives for p in payloads]
