"""Merge a run's host-phase spans with its device trace into one Chrome
trace timeline: the twin of the JAX package's
``scripts/export_timeline.py``.

A :class:`telemetry.TelemetryRun` leaves two time-domain artifacts in
its run dir: ``spans.jsonl`` (host waits — prefetch queue, pump sync
barriers, checkpoint saves, serving bursts) and, when profiling was on,
the ``torch.profiler`` sessions it *owns* (``manifest.json:
profile_sessions``).  This joins them into a single ``traceEvents`` JSON
that ``chrome://tracing`` / Perfetto loads directly: the profiler's rows
keep the pid/tid layout it wrote (the host threads' ops, and on a card
its streams' kernels and copies); host spans land on a synthetic "host
phases" process with one thread per category (pump / prefetch /
checkpoint / serve).

Clock honesty: the two sides run on different clocks — spans are
unix-epoch µs from a ``perf_counter``-anchored stream, the profiler's
events its own trace timebase.  There is no cross-clock sync point to
align them exactly, so each side is zeroed to its own earliest
timestamp, as the reference does.  Relative durations and within-side
ordering are exact; host-vs-device alignment is approximate.

    python -m distributed_training_sandbox_tpu_torch.train.export_timeline \\
        <run-dir> [--out timeline.json.gz]

``train/serve_bench.py --export-timeline`` calls it on the run dir it
wrote.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys

from ..telemetry.spans import read_spans
from ..utils.trace_analysis import (latest_trace_file, load_trace_events,
                                    trace_files)

HOST_PID = 999000   # far above any profiler pid


def _load_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def find_trace_files(run_dir: str) -> list[str]:
    """The traces this run owns: the newest of each session recorded in
    its manifest (or summary), oldest session first; else the newest
    under the summary's trace dir."""
    manifest = _load_json(os.path.join(run_dir, "manifest.json")) or {}
    summary = _load_json(os.path.join(run_dir, "summary.json")) or {}
    sessions = manifest.get("profile_sessions") or \
        summary.get("profile_sessions") or []
    out = []
    for sess in sessions:
        files = trace_files(sess)
        if files:
            out.append(max(files, key=os.path.getmtime))
    if out:
        return out
    trace_dir = summary.get("trace_dir")
    if trace_dir and os.path.isdir(trace_dir):
        tf = latest_trace_file(trace_dir)
        if tf:
            return [tf]
    return []


def span_events(spans: list[dict]) -> list[dict]:
    """Host spans as chrome-trace ph="X" events on the synthetic host
    process, one tid per category so Perfetto gives each its own row."""
    cats = sorted({s.get("cat") or "host" for s in spans})
    tid_of = {c: i + 1 for i, c in enumerate(cats)}
    out = [{"ph": "M", "pid": HOST_PID, "name": "process_name",
            "args": {"name": "host phases"}}]
    for c in cats:
        out.append({"ph": "M", "pid": HOST_PID, "tid": tid_of[c],
                    "name": "thread_name", "args": {"name": c}})
    for s in spans:
        ev = {"ph": "X", "pid": HOST_PID,
              "tid": tid_of[s.get("cat") or "host"],
              "name": s.get("name", "?"),
              "ts": float(s.get("ts_us", 0.0)),
              "dur": float(s.get("dur_us", 0.0))}
        attrs = {k: v for k, v in s.items()
                 if k not in ("schema", "name", "cat", "ts_us", "dur_us")}
        if attrs:
            ev["args"] = attrs
        out.append(ev)
    return out


def _rebase(events: list[dict]) -> None:
    """Zero a side's ``ts`` to its own earliest event (in place)."""
    ts = [float(e["ts"]) for e in events if "ts" in e]
    if not ts:
        return
    t0 = min(ts)
    for e in events:
        if "ts" in e:
            e["ts"] = float(e["ts"]) - t0


def build_timeline(run_dir: str) -> dict:
    """The merged chrome-trace document for one run dir."""
    spans = read_spans(run_dir)
    host = span_events(spans) if spans else []
    _rebase(host)
    device: list[dict] = []
    files = find_trace_files(run_dir)
    for tf in files:
        device += load_trace_events(tf)
    _rebase(device)
    # metadata (track-naming ph="M") events first, then everything in
    # timestamp order — some viewers resolve track names lazily and
    # mis-group out-of-order streams
    merged = sorted(device + host,
                    key=lambda e: (0 if e.get("ph") == "M" else 1,
                                   float(e.get("ts", 0.0))))
    return {
        "displayTimeUnit": "ms",
        "traceEvents": merged,
        "metadata": {
            "run_dir": os.path.abspath(run_dir),
            "host_spans": len(spans),
            "device_traces": files,
            "clock_note": ("host and device sides are independently "
                           "zeroed to their own first event; cross-side "
                           "alignment is approximate"),
        },
    }


def export(run_dir: str, out: str | None = None,
           doc: dict | None = None) -> tuple[str, dict]:
    """Write the timeline of ``run_dir`` (``doc``, or built now) to
    ``out`` (default ``<run-dir>/timeline.json.gz``); returns the path
    and the document."""
    doc = doc or build_timeline(run_dir)
    out = out or os.path.join(run_dir, "timeline.json.gz")
    if out.endswith(".gz"):
        with gzip.open(out, "wt") as f:
            json.dump(doc, f)
    else:
        with open(out, "w") as f:
            json.dump(doc, f, indent=1)
    return out, doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", help="telemetry run directory "
                   "(contains manifest.json / spans.jsonl)")
    p.add_argument("--out", default=None,
                   help="output path (.json or .json.gz); default "
                   "<run-dir>/timeline.json.gz")
    args = p.parse_args(argv)
    if not os.path.isdir(args.run_dir):
        print(f"error: not a directory: {args.run_dir}", file=sys.stderr)
        return 2
    doc = build_timeline(args.run_dir)
    if not doc["traceEvents"]:
        print(f"error: {args.run_dir} has neither spans.jsonl nor an "
              f"owned device trace — nothing to export", file=sys.stderr)
        return 1
    out, _ = export(args.run_dir, args.out, doc)
    n_dev = sum(1 for e in doc["traceEvents"]
                if e.get("pid") != HOST_PID and e.get("ph") == "X")
    n_host = doc["metadata"]["host_spans"]
    print(f"wrote {out}: {n_host} host spans + {n_dev} device events "
          f"(load in chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
