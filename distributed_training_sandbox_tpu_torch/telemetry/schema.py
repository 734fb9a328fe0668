"""The shared per-step event schema: a copy of the JAX package's
``telemetry/schema.py`` (which imports no jax), so that the port's run
directories read back through the same schema.

One JSONL line per optimizer step, identical across every strategy
script, so the JAX package's ``telemetry.report`` can compare runs without per-script
parsers (the ``*_results/`` dirs each grew a bespoke schema; this is
the one they converge on going forward).

Field semantics:
  ``schema``            int, :data:`STEP_SCHEMA_VERSION`
  ``step``              0-based optimizer-step index within the run
  ``loss``              scalar loss for this step (None while unknown)
  ``tokens``            tokens consumed by this step (global batch)
  ``step_time_s``       wall-clock of this step, host-side
  ``tokens_per_second`` cumulative post-warmup rate (tracker window)
  ``tflops_per_device`` analytic-FLOPs rate per device (None w/o model)
  ``peak_memory_gb``    allocator peak on device 0 (None on CPU sim)

Serving events (``serving.engine`` — one line per prefill completion or
decode burst) ride the same schema with the optional fields below;
``step`` counts engine events, ``tokens`` are prompt tokens (prefill)
or emitted tokens (decode burst), ``step_time_s`` the chunk / per-step
burst time:
  ``phase``            "prefill" | "decode"
  ``active``           mean active slots over the burst
  ``admitted``         requests admitted so far
  ``completed``        requests retired so far
  ``kv_pages_in_use``  pool pages currently granted
  ``pool_util``        granted / usable pages (0..1)
  ``ttft_ms``          this request's time-to-first-token (prefill)
  ``completed_requests`` per-request {rid, ttft_ms, per_token_ms,
                       tokens, trace_id} retired at this burst's sync
                       point
  ``replica``          fleet replica index that emitted the event
                       (absent on single-engine runs)
  ``request_id``       engine-local request id for per-request events
                       (prefill completions); optional, additive
  ``trace_id``         distributed trace id minted at Router.submit —
                       stable across failover replay, joins an event to
                       its request swimlane; optional, additive
  ``rank``             emitting process rank (``DTS_PROCESS_ID``);
                       optional, stamped on multi-process runs

The ``request_id`` / ``trace_id`` / ``rank`` fields are additive and
optional — the schema version is unchanged and pre-existing reports
parse events that carry them without modification.
"""

from __future__ import annotations

from typing import Any

STEP_SCHEMA_VERSION = 1

# ordered for stable JSONL key order; value = required at write time
STEP_FIELDS = {
    "schema": True,
    "step": True,
    "loss": False,
    "tokens": False,
    "step_time_s": False,
    "tokens_per_second": False,
    "tflops_per_device": False,
    "peak_memory_gb": False,
    # serving-runtime extras (absent on training events)
    "replica": False,
    "phase": False,
    "active": False,
    "admitted": False,
    "completed": False,
    "kv_pages_in_use": False,
    "pool_util": False,
    "ttft_ms": False,
    "completed_requests": False,
    # distributed-tracing extras (optional, schema version unchanged)
    "request_id": False,
    "trace_id": False,
    "rank": False,
}


def step_event(step: int, *, loss: float | None = None,
               tokens: int | None = None,
               step_time_s: float | None = None,
               tracker_metrics: dict | None = None,
               **extra: Any) -> dict:
    """Build one schema-versioned step event.  ``tracker_metrics`` is the
    dict returned by ``PerformanceTracker.step``/``.metrics`` — the rate
    and memory fields are lifted from it when present."""
    tm = tracker_metrics or {}
    ev: dict[str, Any] = {
        "schema": STEP_SCHEMA_VERSION,
        "step": int(step),
        "loss": None if loss is None else float(loss),
        "tokens": None if tokens is None else int(tokens),
        "step_time_s": (float(step_time_s) if step_time_s is not None
                        else tm.get("last_step_time_s")),
        "tokens_per_second": tm.get("tokens_per_second"),
        "tflops_per_device": tm.get("tflops_per_device"),
        "peak_memory_gb": tm.get("peak_memory_gb"),
    }
    for k, v in extra.items():
        ev.setdefault(k, v)
    return ev


# ------------------------------------------------------------- host spans
#
# One JSONL line per host-side phase span (telemetry.spans.SpanStream):
# where the host spent time *between* step events — prefetch waits, pump
# sync barriers, checkpoint saves, serving bursts.  ``ts_us`` is
# unix-epoch microseconds of span start; ``dur_us`` the span length.

SPAN_SCHEMA_VERSION = 1

SPAN_FIELDS = {
    "schema": True,
    "name": True,      # "pump/sync_every", "prefetch/wait", ...
    "cat": False,      # coarse category: "pump" | "prefetch" | ...
    "ts_us": True,
    "dur_us": True,
}


def span_event(name: str, *, ts_us: float, dur_us: float,
               cat: str | None = None, **attrs: Any) -> dict:
    ev: dict[str, Any] = {
        "schema": SPAN_SCHEMA_VERSION,
        "name": str(name),
        "cat": cat or str(name).split("/", 1)[0],
        "ts_us": float(ts_us),
        "dur_us": float(dur_us),
    }
    for k, v in attrs.items():
        if v is not None:
            ev.setdefault(k, v)
    return ev


def validate_span(ev: dict) -> list[str]:
    problems = []
    for field, required in SPAN_FIELDS.items():
        if required and field not in ev:
            problems.append(f"missing required span field {field!r}")
    for field in ("ts_us", "dur_us"):
        v = ev.get(field)
        if v is not None and not isinstance(v, (int, float)):
            problems.append(f"{field} must be numeric, got {v!r}")
    return problems


def validate_step(ev: dict) -> list[str]:
    """Schema-check one parsed event; returns a list of problems (empty
    when valid).  Used by tests and by ``report.py --strict``."""
    problems = []
    for field, required in STEP_FIELDS.items():
        if required and field not in ev:
            problems.append(f"missing required field {field!r}")
    if ev.get("schema") not in (None, STEP_SCHEMA_VERSION):
        problems.append(f"unknown schema version {ev.get('schema')!r}")
    for field in ("loss", "step_time_s", "tokens_per_second",
                  "tflops_per_device", "peak_memory_gb", "active",
                  "admitted", "completed", "kv_pages_in_use",
                  "pool_util", "ttft_ms"):
        v = ev.get(field)
        if v is not None and not isinstance(v, (int, float)):
            problems.append(f"{field} must be numeric or null, got {v!r}")
    return problems
