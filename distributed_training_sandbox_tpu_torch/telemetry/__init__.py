"""Run telemetry of the port: the JAX package's ``telemetry/`` package —
the run, its manifest, metrics and spans, the collective ledger
(``ledger``), the memory ledger's read-back side (``memledger``; its
writer is ROADMAP.md queue A item A12) and the cross-run report
(``report``, a copy of the reference's).

A run directory holds ``manifest.json``, ``steps.jsonl``, ``spans.jsonl``
(with ``clock_anchor.json``), ``summary.json`` and, when a profiled run
handed over its collective sites, ``collectives.json``, in the
reference's layout and schema.
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
