"""Run telemetry of the port: the JAX package's ``telemetry/`` package,
without its collective and memory ledgers and its report (ROADMAP.md
queue A items A12 and A8; the JAX package's ``telemetry.report`` reads
the port's run directories as they are).

A run directory holds ``manifest.json``, ``steps.jsonl``, ``spans.jsonl``
(with ``clock_anchor.json``) and ``summary.json``, in the reference's
layout and schema.
"""

from .manifest import RunManifest  # noqa: F401
from .metrics import (  # noqa: F401
    MetricsRegistry,
    MetricsServer,
    maybe_inc,
    maybe_observe,
    maybe_set,
)
from .run import TelemetryRun  # noqa: F401
from .schema import (  # noqa: F401
    STEP_SCHEMA_VERSION,
    span_event,
    step_event,
    validate_span,
    validate_step,
)
from .spans import (  # noqa: F401
    SpanStream,
    maybe_span,
    phase_for_span,
    read_clock_anchor,
    read_spans,
)
from .writer import MetricsWriter  # noqa: F401
