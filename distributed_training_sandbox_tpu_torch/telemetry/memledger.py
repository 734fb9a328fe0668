"""Memory ledger, read-back side: port of the JAX package's
``telemetry/memledger.py`` functions that the cross-run report needs
(:func:`load_memory_dict`, :func:`memory_aggregates`,
:func:`check_memory_regressions`).  A run directory's ``memory.json``
keeps the reference's schema.

Not ported: the writer side — ``MemorySampler``, ``attribute_categories``
and ``join_prediction``, which file ``memory.json`` and the memory
verdict (ROADMAP.md queue A item A12, with ``memory_plan/``).
"""

from __future__ import annotations

import json
import os

MEMORY_FILENAME = "memory.json"


def load_memory_dict(run_dir: str) -> dict | None:
    """``memory.json`` of a run dir as a dict, or None when absent or
    unreadable (mirrors ``ledger.load_ledger_dict``)."""
    path = os.path.join(run_dir, MEMORY_FILENAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def memory_aggregates(doc: dict) -> dict[str, float]:
    """Flatten a memory.json dict into the gate's key → GB form: the
    measured peak plus one ``cat/<name>`` key per attributed category."""
    out = {"peak": float(doc.get("measured_peak_gb") or 0.0)}
    for k, v in (doc.get("categories_gb") or {}).items():
        out[f"cat/{k}"] = float(v)
    return out


def check_memory_regressions(cur: dict[str, float],
                             base: dict[str, float],
                             max_growth_pct: float = 20.0,
                             label: str = "",
                             base_label: str = "") -> list[dict]:
    """Direction-aware memory gate: GROWTH is the bad direction (the
    mirror image of the bandwidth gate, where a drop regresses).  Keys
    present on only one side are skipped, not errors."""
    recs = []
    for key in sorted(cur):
        gb, base_gb = cur[key], base.get(key)
        if not base_gb:
            continue
        delta_pct = (gb / base_gb - 1.0) * 100.0
        recs.append({
            "run_id": label, "baseline": base_label, "key": key,
            "gb": gb, "baseline_gb": base_gb,
            "delta_pct": delta_pct, "max_growth_pct": max_growth_pct,
            "regressed": delta_pct > max_growth_pct,
        })
    return recs
