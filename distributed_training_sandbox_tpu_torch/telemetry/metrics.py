"""Live metrics: a tiny in-process registry with a Prometheus text
endpoint.  A copy of the JAX package's ``telemetry/metrics.py`` (which
imports no jax).

The post-hoc artifacts (steps.jsonl, summary.json) answer "what
happened"; this module answers "what is happening".  A
:class:`MetricsRegistry` holds counters, gauges and histograms fed by
the hot paths (pump syncs, prefetch waits, admission decisions,
checkpoint saves, heartbeats), and :class:`MetricsServer` exposes them
on a stdlib HTTP endpoint in Prometheus text exposition format — no
third-party client library, no background scrape agent.

Conventions:

  * metric names are static strings at the call site (enforced by the
    JAX package's ``span-name-not-static`` pitfall lint — dynamic dimensions go in
    labels, never in the name);
  * counters end in ``_total``, histograms in a unit suffix
    (``_seconds``);
  * every feed site is ``None``-tolerant via :func:`maybe_inc` /
    :func:`maybe_set` / :func:`maybe_observe`, mirroring
    ``spans.maybe_span`` — instrumentation never becomes a hard
    dependency of the thing it observes.

The registry is thread-safe (prefetch producer threads, checkpoint
writeback threads and the HTTP server all touch it concurrently) and
deliberately unbounded-cardinality-hostile: label values are
stringified and the lint keeps names static, so the series count is
bounded by code, not by data.
"""

from __future__ import annotations

import http.server
import json
import threading
import time

__all__ = [
    "MetricsRegistry", "MetricsServer",
    "maybe_inc", "maybe_set", "maybe_observe",
]

# Default histogram buckets (seconds): spans the range from a fast
# host sync (~100us) to a slow checkpoint save / prefill (~10s).
DEFAULT_BUCKETS = (0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                   1.0, 5.0, 10.0)


def _label_key(labels: dict) -> tuple:
    """Canonical hashable key for a label set (values stringified)."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    # Prometheus accepts float repr; render integral values as ints so
    # counter output is stable and diff-friendly.
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class MetricsRegistry:
    """Thread-safe counters / gauges / histograms with Prometheus text
    rendering and JSON snapshots.

    Names should be bare (``pump_host_sync_total``); a ``namespace``
    prefix (default ``dts``) is applied at render/snapshot time so feed
    sites stay short."""

    def __init__(self, namespace: str = "dts"):
        self.namespace = namespace
        self._lock = threading.Lock()
        # name -> {label_key -> value}
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        # name -> {label_key -> {"buckets": [counts], "sum": s, "count": n}}
        self._hists: dict[str, dict[tuple, dict]] = {}
        self._hist_buckets: dict[str, tuple] = {}

    # -- feeds ------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + float(value)

    def set(self, name: str, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._gauges.setdefault(name, {})[key] = float(value)

    def observe(self, name: str, value: float,
                buckets: tuple = DEFAULT_BUCKETS, **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            bks = self._hist_buckets.setdefault(name, tuple(buckets))
            series = self._hists.setdefault(name, {})
            h = series.setdefault(
                key, {"buckets": [0] * len(bks), "sum": 0.0, "count": 0})
            for i, le in enumerate(bks):
                if v <= le:
                    h["buckets"][i] += 1
            h["sum"] += v
            h["count"] += 1

    # -- reads ------------------------------------------------------

    def get(self, name: str, **labels) -> float | None:
        """Current value of a counter or gauge series (None if unseen)."""
        key = _label_key(labels)
        with self._lock:
            for table in (self._counters, self._gauges):
                if name in table and key in table[name]:
                    return table[name][key]
        return None

    def counter_total(self, name: str) -> float:
        """Sum of a counter across all label sets (0.0 if unseen)."""
        with self._lock:
            return float(sum(self._counters.get(name, {}).values()))

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._counters or self._gauges or self._hists)

    def snapshot(self) -> dict:
        """Flat JSON-ready snapshot: ``{"counters": {...}, "gauges":
        {...}, "histograms": {...}}`` with ``name{k="v"}`` keys."""
        ns = self.namespace + "_" if self.namespace else ""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for name, series in self._counters.items():
                for key, v in series.items():
                    out["counters"][ns + name + _fmt_labels(key)] = v
            for name, series in self._gauges.items():
                for key, v in series.items():
                    out["gauges"][ns + name + _fmt_labels(key)] = v
            for name, series in self._hists.items():
                for key, h in series.items():
                    out["histograms"][ns + name + _fmt_labels(key)] = {
                        "count": h["count"], "sum": h["sum"]}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        ns = self.namespace + "_" if self.namespace else ""
        lines: list[str] = []
        with self._lock:
            for name in sorted(self._counters):
                full = ns + name
                lines.append(f"# TYPE {full} counter")
                for key in sorted(self._counters[name]):
                    lines.append(f"{full}{_fmt_labels(key)} "
                                 f"{_fmt_value(self._counters[name][key])}")
            for name in sorted(self._gauges):
                full = ns + name
                lines.append(f"# TYPE {full} gauge")
                for key in sorted(self._gauges[name]):
                    lines.append(f"{full}{_fmt_labels(key)} "
                                 f"{_fmt_value(self._gauges[name][key])}")
            for name in sorted(self._hists):
                full = ns + name
                bks = self._hist_buckets[name]
                lines.append(f"# TYPE {full} histogram")
                for key in sorted(self._hists[name]):
                    h = self._hists[name][key]
                    base = dict(key)
                    cum = 0
                    for le, n in zip(bks, h["buckets"]):
                        cum = n  # buckets are already cumulative per-le
                        lk = _fmt_labels(_label_key({**base, "le": le}))
                        lines.append(f"{full}_bucket{lk} {cum}")
                    lk = _fmt_labels(_label_key({**base, "le": "+Inf"}))
                    lines.append(f"{full}_bucket{lk} {h['count']}")
                    lines.append(f"{full}_sum{_fmt_labels(key)} "
                                 f"{_fmt_value(h['sum'])}")
                    lines.append(f"{full}_count{_fmt_labels(key)} "
                                 f"{h['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_snapshot(self, path: str) -> None:
        """Append one timestamped snapshot line to a metrics.jsonl."""
        line = json.dumps({"ts": time.time(), **self.snapshot()},
                          sort_keys=True)
        with open(path, "a") as f:
            f.write(line + "\n")


class _Handler(http.server.BaseHTTPRequestHandler):
    # Set per-server via a subclass attribute in MetricsServer.
    registry: MetricsRegistry | None = None

    def do_GET(self):  # noqa: N802 (stdlib naming)
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_error(404)
            return
        body = self.registry.render_prometheus().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr spam
        pass


class MetricsServer:
    """Prometheus scrape endpoint on a daemon thread.

    ``port=0`` binds an ephemeral port; read it back from ``.port``
    (this is how tests scrape a live run without port collisions)."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        handler = type("_BoundHandler", (_Handler,), {"registry": registry})
        self._httpd = http.server.ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dts-metrics",
            daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


# -- None-tolerant feed helpers (mirror spans.maybe_span) ------------
# forwarders: the caller's literal passes through (lint checks THEM)

def maybe_inc(metrics: MetricsRegistry | None, name: str,
              value: float = 1.0, **labels) -> None:
    if metrics is not None:
        metrics.inc(name, value, **labels)   # span-ok


def maybe_set(metrics: MetricsRegistry | None, name: str,
              value: float, **labels) -> None:
    if metrics is not None:
        metrics.set(name, value, **labels)   # span-ok


def maybe_observe(metrics: MetricsRegistry | None, name: str,
                  value: float, **labels) -> None:
    if metrics is not None:
        metrics.observe(name, value, **labels)   # span-ok
