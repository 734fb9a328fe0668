"""Filesystem half of the telemetry layer: one run directory, the
artifacts.  A copy of the JAX package's ``telemetry/writer.py`` (which
imports no jax): the port writes the same layout.

Layout contract (read back by the JAX package's ``telemetry.report``):

    <results_dir>/<run_id>/
        manifest.json     written at startup (RunManifest); rewritten
                          once at finalize when profiling was on, to add
                          the owned profiler sessions + ledger verdict
        steps.jsonl       appended once per optimizer step (schema.step_event)
        spans.jsonl       host-side phase spans (telemetry.spans), when any
        collectives.json  the CollectiveLedger (telemetry.ledger), when
                          profiling captured a trace and the run attached
                          its compiled HLO
        summary.json      written at finalize (and overwritten on crash
                          with status="crashed" so partial runs are visible)

The writer is deliberately dumb — no rank logic, no aggregation; the
rank-0-only policy and the summary contents live in ``TelemetryRun``.

Step appends are buffered and flushed every :data:`FLUSH_EVERY` (= 32)
events, plus explicitly via ``flush()`` (the pump does this at every
sync point) and on ``close()`` — which every crash path reaches through
``TelemetryRun.finalize``.  The durability contract is therefore:
an *exception* loses nothing; a hard kill (SIGKILL/power) loses at most
the ≤ 32 in-flight events since the last flush.  The previous
line-buffered mode paid one write+flush syscall pair per step in the
hot loop for a guarantee only the hard-kill case ever used.
"""

from __future__ import annotations

import json
import os

FLUSH_EVERY = 32


class MetricsWriter:
    MANIFEST = "manifest.json"
    STEPS = "steps.jsonl"
    SUMMARY = "summary.json"

    def __init__(self, run_dir: str, flush_every: int = FLUSH_EVERY):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._steps_f = None
        self.steps_written = 0
        self.flush_every = max(int(flush_every), 1)
        self._unflushed = 0

    # ---- artifacts ------------------------------------------------------
    def write_manifest(self, manifest) -> str:
        path = os.path.join(self.run_dir, self.MANIFEST)
        d = manifest.to_dict() if hasattr(manifest, "to_dict") else manifest
        with open(path, "w") as f:
            json.dump(d, f, indent=2, default=str)
            f.write("\n")
        return path

    def append_step(self, event: dict) -> None:
        if self._steps_f is None:
            self._steps_f = open(os.path.join(self.run_dir, self.STEPS),
                                 "a")
        self._steps_f.write(json.dumps(event, default=str) + "\n")
        self.steps_written += 1
        self._unflushed += 1
        if self._unflushed >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self._steps_f is not None and self._unflushed:
            self._steps_f.flush()
        self._unflushed = 0

    def write_json(self, name: str, obj: dict) -> str:
        """One auxiliary JSON artifact in the run dir (collectives.json
        is the current client)."""
        path = os.path.join(self.run_dir, name)
        with open(path, "w") as f:
            json.dump(obj, f, indent=2, default=str)
            f.write("\n")
        return path

    def write_summary(self, summary: dict) -> str:
        path = os.path.join(self.run_dir, self.SUMMARY)
        with open(path, "w") as f:
            json.dump(summary, f, indent=2, default=str)
            f.write("\n")
        return path

    def close(self) -> None:
        if self._steps_f is not None:
            self.flush()
            self._steps_f.close()
            self._steps_f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
