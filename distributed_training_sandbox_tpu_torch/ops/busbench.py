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
collective is timed with CUDA events around its calls after
``warmup``; on gloo with the host clock between two barriers.  At one
rank a collective moves no byte over a link: NCCL copies the buffer,
and ``ppermute_ring`` returns its input without a call, so a one-rank
sweep times copies and no bandwidth of a link.

The timed calls are the bare collectives on buffers allocated before
the window (:func:`inplace_call`): ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single`` into preallocated
outputs, all_reduce in place on a buffer reset from the input between
windows of at most ``ALL_REDUCE_WINDOW`` calls, and the ring hop's
send and receive buffers made once; each call is issued asynchronously
and the window waits on them all at its end, so the calls follow one
another on NCCL's stream without a wait on the caller's between them.
A training step's collectives (``ops/collectives.py``) allocate their
outputs and move dims around the same calls; timing those
(``collective_fn``) read under the step's own busbw.  On a card the
stream first sleeps long enough for the host to queue the window, a
payload under ``BYTES_A_WINDOW`` gets enough calls (at most
``MAX_ITERS``) that the launch latency between calls does not set the
time, and the reading is the best of ``REPEATS`` timings: the window
reads the device's back-to-back rate, as the step's trace reads each
kernel's own time.
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


# calls a window at least carries this many bytes (small payloads get
# more calls), capped at MAX_ITERS calls
BYTES_A_WINDOW = 1 << 30
MAX_ITERS = 400
# all_reduce sums in place: the buffer is reset from the input after at
# most this many calls, so that the small integers of make_input stay
# finite in bf16 (n ≤ 8 ranks: 8^8 · 30 < 2^31)
ALL_REDUCE_WINDOW = 8
# host seconds a call may take to queue; the stream sleeps this long
# for every call of a window before its start event (three times as
# long, at most 200 calls a window, read lower at 2 MiB on four H100s)
_QUEUE_S_A_CALL = 20e-6
# a card's reading is the best of this many timings of all its windows
REPEATS = 3


def inplace_call(name: str, x: torch.Tensor, axis="dp"):
    """``(call, out)``: ``call()`` issues the named collective once on
    buffers allocated here, asynchronously, and returns its works (wait
    on them before reading ``out``, which then holds the values of
    ``collective_fn(name, axis)(x)``).  all_reduce sums in place into
    ``out``, so a caller resets it (``out.copy_(x)``) between calls whose
    sum it reads.  ``ppermute`` at one rank is no call, as
    ``ppermute_ring`` returns its input there."""
    if not mesh.initialized():
        return (lambda: []), x
    n, group = mesh.axis_size(axis), mesh.resolve_axis(axis).group
    kw = {"group": group, "async_op": True}
    if name == "all_reduce":
        out = x.clone()
        return (lambda: [dist.all_reduce(out, **kw)]), out
    if name == "all_gather":
        out = x.new_empty((x.shape[0] * n, *x.shape[1:]))
        return (lambda: [dist.all_gather_into_tensor(out, x, **kw)]), out
    if name == "reduce_scatter":
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        return (lambda: [dist.reduce_scatter_tensor(out, x, **kw)]), out
    if name == "all_to_all":
        out = torch.empty_like(x)
        return (lambda: [dist.all_to_all_single(out, x, **kw)]), out
    if name == "ppermute":
        if n == 1:
            return (lambda: []), x
        i = mesh.axis_rank(axis)
        dst = mesh.global_rank(axis, (i + 1) % n)
        src = mesh.global_rank(axis, (i - 1) % n)
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, dst, group),
               dist.P2POp(dist.irecv, out, src, group)]
        return (lambda: dist.batch_isend_irecv(ops)), out
    raise ValueError(f"unknown collective {name!r}")


def _run(call, k: int) -> None:
    """``k`` calls queued back to back, then waited on."""
    works = []
    for _ in range(k):
        works += call()
    for w in works:
        w.wait()


def window_iters(payload_bytes: int, iters: int) -> int:
    """Calls in the timed window: ``iters``, or more for a payload under
    ``BYTES_A_WINDOW`` (at most ``MAX_ITERS``)."""
    return max(iters, min(MAX_ITERS, -(-BYTES_A_WINDOW // max(
        payload_bytes, 1))))


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
    call, out = inplace_call(name, x, axis)
    window = ALL_REDUCE_WINDOW if name == "all_reduce" else None
    _run(call, warmup)
    if device.type == "cuda":
        iters = window_iters(nelems * itemsize, iters)

        def timed() -> float:
            total_ms, done = 0.0, 0
            while done < iters:
                k = min(iters - done, window or iters)
                if window:
                    out.copy_(x)   # reset outside the timed window
                _barrier(axis)
                torch.cuda.synchronize(device)
                # let the host queue the window ahead of the device
                torch.cuda._sleep(int(k * _QUEUE_S_A_CALL * 2e9))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _run(call, k)
                end.record()
                end.synchronize()
                total_ms += start.elapsed_time(end)
                done += k
            return total_ms / 1e3 / iters
        dt = min(timed() for _ in range(REPEATS))
    else:
        _barrier(axis)
        t0 = time.perf_counter()
        _run(call, iters)
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
