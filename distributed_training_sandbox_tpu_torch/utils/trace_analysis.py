"""Post-hoc comm-vs-compute split and per-call collective records from
``torch.profiler`` traces: port of the JAX package's
``utils/trace_analysis.py``.

The traces are the Chrome traces ``utils.profiling.Profiler`` writes,
one a profiling window, under
``<trace_dir>/plugins/profile/<stamp>/<host>.r<rank>.pt.trace.json``
(``.gz`` is read too).

Methodology (what differs from the reference's XLA traces):

  * A CUDA trace holds the host's ops (``aten::mm``, the ``c10d::``
    dispatch of a collective, ``nccl:*`` record functions) *and* the
    device's activity (kernels, memcpy, memset).  The split counts device
    activity only, or every op would count twice: comm is the NCCL
    kernels (``ncclDevKernel_*`` / ``ncclKernel_*``) and the peer copies
    (``Memcpy PtoP``, the pipeline's hops between cards, which stand in
    for the reference's ``collective-permute`` / ``send`` / ``recv``);
    compute is every other kernel; other is the remaining memcpy and
    memset.
  * A trace with no device activity (the CPU, gloo) is read on the host:
    comm is the backend's own work (``gloo:*`` / ``nccl:*`` record
    functions, peer waits included, as the reference counts its
    rendezvous), compute the outermost ``aten::`` ops of each thread
    outside it, other the ``c10d::`` dispatch of the collectives.
  * Comm hidden under compute still counts as comm: the split is "time
    attributable to", not "critical path".

The per-call records (:func:`collective_event_stats`) count the
``c10d::`` dispatcher ops, one per collective call that reached the
process group, whatever the backend: the independent side of the
ledger's join against the recording shim (``telemetry.ledger``).  A
call's time is the device activity it launched (linked through the
launch's correlation id: the runtime or driver call inside the op's
interval on its thread), or, on a trace without device activity, the
op's own duration on the calling thread.  A ring hop's send and recv
are queued by NCCL and launched together when the coalesced group
ends (the ``nccl:coalesced`` range, after both ops): that launch's
device time is the hop's, its send's.

The phase split (:func:`phase_split`, the MoE profile's) reads the
``record_function`` ranges the port names after the reference's
``jax.named_scope``s.  XLA stamps every op, the backward's too, with
its scope; here a device event belongs to the innermost named range
around its launch on the launching thread, and a launch inside a
backward op (the autograd engine's ``evaluate_function``, on its own
thread) to the range of the forward op with the backward op's
``Sequence number``.  A checkpoint's recompute runs its forward ops
inside a backward op, with numbers from that thread's counter: they
are read by their own ranges, and no backward op maps to them.
Without device activity the innermost ``cpu_op``s of each thread are
the work, read the same way.

Not ported: ``hlo_computations``, ``while_bodies`` and
``collective_placement``, which read compiled HLO text; a torch program
has none.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import re
from dataclasses import dataclass

TRACE_PATTERNS = ("*.trace.json", "*.trace.json.gz")

_NCCL_KERNEL = re.compile(r"^nccl(Dev)?Kernel", re.IGNORECASE)
_PEER_COPY = re.compile(r"PtoP", re.IGNORECASE)
_BACKEND_WORK = re.compile(r"^(gloo|nccl):")
_COALESCED = "nccl:coalesced"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# the c10d dispatcher ops of the shim's wire calls, by kind; a hop is a
# send and a recv, counted once by its send
C10D_KINDS = {
    "c10d::allreduce_": "all_reduce",
    "c10d::allreduce_coalesced_": "all_reduce",
    "c10d::_allgather_base_": "all_gather",
    "c10d::allgather_": "all_gather",
    "c10d::allgather_into_tensor_coalesced_": "all_gather",
    "c10d::_reduce_scatter_base_": "reduce_scatter",
    "c10d::reduce_scatter_": "reduce_scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "c10d::broadcast_": "broadcast",
    "c10d::alltoall_base_": "all_to_all",
    "c10d::alltoall_": "all_to_all",
    "c10d::send": "collective_permute",
}
# which entry of the op's "Input Dims" is the caller's tensor (a list
# entry of a TensorList argument is unwrapped)
_INPUT_ARG = {"all_reduce": 0, "broadcast": 0, "collective_permute": 0,
              "all_gather": 1, "reduce_scatter": 1, "all_to_all": 1}


@dataclass
class CommSplit:
    comm_us: float
    compute_us: float
    other_us: float
    trace_file: str
    top_comm: list
    top_compute: list
    # wall-clock microseconds during which a comm event and a compute
    # event were running concurrently (different streams or threads)
    overlap_us: float = 0.0
    # "device" (kernels and copies) or "host" (a trace without them)
    source: str = "device"

    @property
    def total_us(self) -> float:
        return self.comm_us + self.compute_us

    @property
    def comm_fraction(self) -> float:
        return self.comm_us / self.total_us if self.total_us else 0.0

    @property
    def overlap_fraction(self) -> float:
        """Fraction of comm time hidden under concurrent compute."""
        return self.overlap_us / self.comm_us if self.comm_us else 0.0

    def report(self, label: str = "") -> str:
        pct = 100.0 * self.comm_fraction
        return (f"[{label}] comm/compute split (profiler trace): "
                f"comm {self.comm_us / 1e3:.2f} ms, "
                f"compute {self.compute_us / 1e3:.2f} ms "
                f"-> communication overhead {pct:.1f}% of categorized "
                f"{self.source} time, {100.0 * self.overlap_fraction:.1f}% "
                f"of comm overlapped with compute")


def profile_session_dirs(trace_dir: str) -> list[str]:
    """The profiler session directories under ``trace_dir``
    (``plugins/profile/<timestamp>/``, one a window), sorted by name
    (the stamps sort chronologically)."""
    root = os.path.join(trace_dir, "plugins", "profile")
    try:
        return sorted(os.path.join(root, d) for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d)))
    except OSError:
        return []


def trace_files(root: str) -> list[str]:
    """Every Chrome trace under ``root``, plain or gzipped."""
    out = []
    for pat in TRACE_PATTERNS:
        out += glob.glob(os.path.join(root, "**", pat), recursive=True)
    return out


def latest_trace_file(trace_dir: str, session: str | None = None) \
        -> str | None:
    """Newest trace under ``trace_dir``, or, when ``session`` names a
    profiler session directory (absolute, or relative to
    ``trace_dir``), the newest inside exactly that session: a concurrent
    run or a stale entry may be newer than the trace this run wrote."""
    roots = [trace_dir]
    if session:
        sd = session if os.path.isabs(session) \
            else os.path.join(trace_dir, session)
        if os.path.isdir(sd):
            roots = [sd]
    files = []
    for r in roots:
        files += trace_files(r)
    return max(files, key=os.path.getmtime) if files else None


def load_trace_events(trace_file: str) -> list[dict]:
    """The ``traceEvents`` of one Chrome trace (plain or gzipped)."""
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        return list(json.load(f).get("traceEvents") or [])


def interval_overlap_us(comm_iv: list, compute_iv: list) -> float:
    """Total microseconds during which any ``comm`` interval and any
    ``compute`` interval (each ``(start, end)``) run concurrently.
    Compute intervals are merged first so stacked ops don't double-
    count; each comm interval then contributes its intersection with the
    merged compute timeline."""
    if not comm_iv or not compute_iv:
        return 0.0
    merged: list[list[float]] = []
    for s, e in sorted(compute_iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total = 0.0
    for cs, ce in comm_iv:
        for ms, me in merged:
            if ms >= ce:
                break
            if me <= cs:
                continue
            total += min(ce, me) - max(cs, ms)
    return total


def _complete(events):
    """The duration events (``ph`` X) with a start and a duration."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("ts") is not None]


def _span(e) -> tuple[float, float]:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def has_device_activity(events) -> bool:
    return any(e.get("cat") in _DEVICE_CATS for e in _complete(events))


def _device_class(e) -> str | None:
    cat, name = e.get("cat"), e.get("name", "")
    if cat == "kernel":
        return "comm" if _NCCL_KERNEL.search(name) else "compute"
    if cat == "gpu_memcpy":
        return "comm" if _PEER_COPY.search(name) else "other"
    if cat == "gpu_memset":
        return "other"
    return None


def _outermost(events, keep) -> list[dict]:
    """Of the events ``keep`` accepts, those not nested inside another
    accepted event on the same thread."""
    by_tid: dict = {}
    for e in events:
        if keep(e):
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        end = float("-inf")
        for e in evs:
            s, t = _span(e)
            if s >= end:
                out.append(e)
                end = t
    return out


def _host_class(e) -> str | None:
    cat, name = e.get("cat"), e.get("name", "")
    if cat == "user_annotation" and _BACKEND_WORK.match(name):
        return "comm"
    if cat == "cpu_op":
        if name.startswith("c10d::"):
            return "other"
        if name.startswith("aten::"):
            return "compute"
    return None


def split_events(events, trace_file: str = "", top_n: int = 5) \
        -> CommSplit:
    """The split of one trace's events (see the module docstring)."""
    evs = _complete(events)
    if has_device_activity(evs):
        source = "device"
        classed = [(e, _device_class(e)) for e in evs]
    else:
        source = "host"
        # the outermost of the comm and aten ops on each thread: an aten
        # op inside the backend's work, or inside another aten op, is
        # already counted
        top = _outermost(evs, lambda e: _host_class(e) in ("comm",
                                                           "compute"))
        classed = [(e, _host_class(e)) for e in top]
        classed += [(e, "other") for e in evs if _host_class(e) == "other"]
    comm: dict[str, float] = {}
    compute: dict[str, float] = {}
    comm_iv, compute_iv = [], []
    other = 0.0
    for e, cls in classed:
        if cls is None:
            continue
        dur = float(e.get("dur", 0.0))
        name = e.get("name", "")
        if cls == "comm":
            comm[name] = comm.get(name, 0.0) + dur
            comm_iv.append(_span(e))
        elif cls == "compute":
            compute[name] = compute.get(name, 0.0) + dur
            compute_iv.append(_span(e))
        else:
            other += dur

    def top(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:top_n]
    return CommSplit(
        comm_us=sum(comm.values()), compute_us=sum(compute.values()),
        other_us=other, trace_file=trace_file, top_comm=top(comm),
        top_compute=top(compute),
        overlap_us=interval_overlap_us(comm_iv, compute_iv),
        source=source)


def split_from_trace(trace_dir: str, top_n: int = 5,
                     session: str | None = None) -> CommSplit | None:
    """The split of the trace under ``trace_dir``: the one in the owned
    ``session`` directory when given (:func:`latest_trace_file`), else
    the newest.  None when no trace exists; a trace that does not parse
    raises."""
    tf = latest_trace_file(trace_dir, session=session)
    if tf is None:
        return None
    return split_events(load_trace_events(tf), tf, top_n)


# -------------------------------------------------- per-call collectives

def normalize_event_name(name: str) -> str:
    """Trace event name -> op name: strip a leading ``%`` and any
    ``scope/`` prefixes."""
    return name.rsplit("/", 1)[-1].lstrip("%")


def _numel(dims) -> int | None:
    if not isinstance(dims, list):
        return None
    if dims and isinstance(dims[0], list):   # a TensorList argument
        if len(dims) != 1:
            return None
        dims = dims[0]
    n = 1
    for d in dims:
        if not isinstance(d, int):
            return None
        n *= d
    return n


def _input_numel(e, kind: str) -> int | None:
    dims = (e.get("args") or {}).get("Input Dims")
    i = _INPUT_ARG[kind]
    if not isinstance(dims, list) or len(dims) <= i:
        return None
    return _numel(dims[i])


def collective_event_stats(trace_file: str) -> dict[str, dict]:
    """Every collective call in one trace, by kind:
    ``{kind: {"count", "total_us", "calls": [{"ts", "us", "numel"}]}}``,
    the calls in time order.  ``numel`` is the caller's tensor's element
    count where the trace recorded its shape (``record_shapes``), else
    None; ``us`` the call's device time (see the module docstring)."""
    return collective_stats_from_events(load_trace_events(trace_file))


def collective_stats_from_events(events) -> dict[str, dict]:
    evs = _complete(events)
    device = has_device_activity(evs)
    dev_us: dict = {}
    launches: dict = {}
    if device:
        for e in evs:
            corr = (e.get("args") or {}).get("correlation")
            if corr is None:
                continue
            if e.get("cat") in _DEVICE_CATS:
                dev_us[corr] = dev_us.get(corr, 0.0) \
                    + float(e.get("dur", 0.0))
            elif e.get("cat") in _LAUNCH_CATS:
                launches.setdefault((e.get("pid"), e.get("tid")),
                                    []).append((float(e["ts"]), corr))
        for lst in launches.values():
            lst.sort()

    def launched_us(thread, s, t):
        return sum(dev_us.get(c, 0.0)
                   for ts, c in launches.get(thread, []) if s <= ts <= t)

    out: dict[str, dict] = {}
    ops = sorted((e for e in evs if e.get("cat") == "cpu_op"
                  and normalize_event_name(e.get("name", "")) in C10D_KINDS),
                 key=lambda e: float(e["ts"]))
    sends: dict = {}      # thread -> its calls' records of hops, in order
    for e in ops:
        kind = C10D_KINDS[normalize_event_name(e["name"])]
        s, t = _span(e)
        thread = (e.get("pid"), e.get("tid"))
        us = launched_us(thread, s, t) if device else t - s
        rec = out.setdefault(kind, {"count": 0, "total_us": 0.0,
                                    "calls": []})
        call = {"ts": s, "us": us, "numel": _input_numel(e, kind)}
        rec["count"] += 1
        rec["calls"].append(call)
        if kind == "collective_permute":
            sends.setdefault(thread, []).append(call)
    if device:
        for a in evs:
            if a.get("name") != _COALESCED:
                continue
            thread = (a.get("pid"), a.get("tid"))
            s, t = _span(a)
            mine = [c for c in sends.get(thread, []) if c["ts"] <= s]
            if mine:
                mine[-1]["us"] += launched_us(thread, s, t)
    for rec in out.values():
        rec["total_us"] = sum(c["us"] for c in rec["calls"])
    return out


_EVALUATE = "autograd::engine::evaluate_function"


class _Intervals:
    """(start, end, value) intervals of one thread, for the innermost one
    holding a time: a bisection to the last start at or before it, then
    back while an earlier interval may still be open (the prefix maximum
    of the ends)."""

    def __init__(self, ivs):
        self.ivs = sorted(ivs, key=lambda iv: iv[:2])
        self.starts = [iv[0] for iv in self.ivs]
        self.open_until, top = [], float("-inf")
        for _, t, _ in self.ivs:
            top = max(top, t)
            self.open_until.append(top)

    def innermost(self, ts):
        j = bisect.bisect_right(self.starts, ts) - 1
        best = None
        while j >= 0 and self.open_until[j] >= ts:
            s, t, v = self.ivs[j]
            if t >= ts and (best is None or t - s < best[0]):
                best = (t - s, v)
            j -= 1
        return best[1] if best else None


def _leaves(events, keep) -> list[dict]:
    """Of the events ``keep`` accepts, those holding no other accepted
    event on their thread."""
    by_tid: dict = {}
    for e in events:
        if keep(e):
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        for a, b in zip(evs, evs[1:] + [None]):
            if b is None or float(b["ts"]) >= _span(a)[1]:
                out.append(a)
    return out


def phase_split(events, phases) -> dict[str, float]:
    """Microseconds of work by phase (``phases``: ``record_function``
    names) and ``"other"``, from one trace's events (see the module
    docstring): device events on a CUDA trace, the innermost ``cpu_op``s
    of each thread without one.  Every phase is a key, 0.0 where no work
    fell in it.

    A piece of work at (thread, time) belongs to the innermost named
    range there; outside one, the innermost op there that carries a
    ``Sequence number`` decides: a backward op (the autograd engine's
    ``evaluate_function`` and the node it runs) takes the phase of the
    forward op with its number, a forward op none.  A forward op inside
    a backward op is a checkpoint's recompute (its own ranges name its
    work), and its graph is never differentiated: no backward op maps to
    it."""
    evs = _complete(events)
    phases = tuple(phases)
    ranges: dict = {}
    seq_ops: dict = {}
    for e in evs:
        thread = (e.get("pid"), e.get("tid"))
        if e.get("cat") == "user_annotation" and e.get("name") in phases:
            ranges.setdefault(thread, []).append((*_span(e), e["name"]))
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and args.get("Sequence number") is not None:
            bwd = (e.get("name", "").startswith(_EVALUATE)
                   or bool(args.get("Fwd thread id")))
            seq_ops.setdefault(thread, []).append(
                (*_span(e), (args["Sequence number"], bwd)))
    ranges = {k: _Intervals(v) for k, v in ranges.items()}
    bwd_only = {k: _Intervals([iv for iv in v if iv[2][1]])
                for k, v in seq_ops.items()}

    def named(thread, ts):
        r = ranges.get(thread)
        return r.innermost(ts) if r else None

    # each sequence number's forward ops, in time, with their phase
    fwd_seq: dict = {}
    for thread, ivs in seq_ops.items():
        for s, _, (seq, bwd) in ivs:
            if not bwd and bwd_only[thread].innermost(s) is None:
                fwd_seq.setdefault(seq, []).append((s, named(thread, s)))
    for lst in fwd_seq.values():
        lst.sort(key=lambda v: v[0])
    seq_ops = {k: _Intervals(v) for k, v in seq_ops.items()}

    def phase_at(thread, ts):
        ph = named(thread, ts)
        if ph is not None:
            return ph
        op = seq_ops[thread].innermost(ts) if thread in seq_ops else None
        if op is None or not op[1]:
            return "other"
        before = [p for s, p in fwd_seq.get(op[0], []) if s <= ts]
        return (before[-1] if before else None) or "other"

    out = {ph: 0.0 for ph in phases}
    out["other"] = 0.0
    if has_device_activity(evs):
        launch = {}
        for e in evs:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None and e.get("cat") in _LAUNCH_CATS:
                launch[corr] = ((e.get("pid"), e.get("tid")),
                                float(e["ts"]))
        for e in evs:
            if e.get("cat") not in _DEVICE_CATS:
                continue
            where = launch.get((e.get("args") or {}).get("correlation"))
            ph = phase_at(*where) if where else "other"
            out[ph] += float(e.get("dur", 0.0))
        return out
    for e in _leaves(evs, lambda e: e.get("cat") == "cpu_op"):
        out[phase_at((e.get("pid"), e.get("tid")), float(e["ts"]))] += \
            float(e.get("dur", 0.0))
    return out
