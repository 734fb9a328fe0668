"""CollectiveLedger: per-collective bus-bandwidth attribution from
``torch.profiler`` traces.  Port of the JAX package's
``telemetry/ledger.py``; ``collectives.json`` keeps the reference's
schema, so either package's report reads it.

The reference joins trace events to the compiled program's collective
instructions.  A torch step has no compiled program; its counterpart of
the "compiled sites" is the recording shim (``ops.collectives``
``COLLECTIVES``), whose per-step record of calls (kind, payload, dtype,
group size; ``CollectiveCounts.sites``) every twin already holds to its
contract.  So:

  1. ``utils.trace_analysis.collective_event_stats`` lists every
     collective call the trace saw (the ``c10d::`` dispatcher ops), by
     kind and in time order, with its device time;
  2. :func:`build_ledger` joins them to the shim's calls a step by
     position: the j-th call of a kind in a traced step is site
     ``<kind>.<j>``, measured once a traced step.  The law: over the
     traced window the calls of each kind equal the shim's calls a step
     times the traced steps.  A call past that count, or whose element
     count differs from its site's, is unmatched; a site measured fewer
     times than the traced steps is unmeasured;
  3. bandwidth follows nccl-tests accounting (``ops.busbench.bus_factor``)
     per site, aggregated by (kind, pow-2 payload bucket, mesh axis);
  4. :func:`join_contract` holds the sites to the strategy's expected
     counts, as the reference does.

Sites for the cases the shim does not see: a collective the shim counts
as one call is one site, whatever the backend does inside it (the
port's DDP buckets are the shim's calls, one a bucket); collectives
that ``torch.distributed.fsdp.fully_shard`` issues itself (FSDP's auto
variant) have no sites, and that twin files no ledger.  On one NCCL
rank a collective is a copy or nothing: the call is counted all the
same, its time is the copy's (zero when NCCL does nothing).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass, field

from ..analysis.contracts import REFERENCE_KINDS, parse_expected_spec

LEDGER_FILENAME = "collectives.json"
LEDGER_SCHEMA_VERSION = 1

# the reference's contract kinds, in its order; a kind only the port's
# shim has (broadcast) joins after them when present
KINDS = REFERENCE_KINDS


def payload_bucket(nbytes: int) -> str:
    """Pow-2 payload bucket label ("≤4KiB", "≤1MiB", ...) — the nccl-tests
    message-size axis, coarse enough to survive shape jitter between
    runs being diffed."""
    if nbytes <= 0:
        return "0B"
    exp = max(math.ceil(math.log2(nbytes)), 0)
    size = 1 << exp
    for unit, scale in (("GiB", 30), ("MiB", 20), ("KiB", 10)):
        if size >= (1 << scale):
            return f"≤{size >> scale}{unit}"
    return f"≤{size}B"


def _axis_for_group(group_size: int, axis_sizes: dict) -> str:
    """Mesh-axis attribution of one replica-group size: the full mesh ->
    "all", exactly one axis of that size -> its name, ambiguous ->
    "a|b", no match -> "?"."""
    ws = int(math.prod(axis_sizes.values())) if axis_sizes else 1
    if group_size == ws and ws > 1:
        multi = [a for a, s in axis_sizes.items() if int(s) > 1]
        if len(multi) == 1:
            return multi[0]
        return "all"
    names = sorted(a for a, s in axis_sizes.items() if int(s) == group_size)
    if len(names) == 1:
        return names[0]
    if names:
        return "|".join(names)
    return "?"


@dataclass
class LedgerEntry:
    """One measured site: the trace's calls at one position of the
    step joined to the shim's record of that call."""
    name: str            # "<kind>.<position in the step>"
    kind: str            # "all_reduce", ... (CollectiveCounts.KINDS)
    occurrences: int     # traced calls (one a traced step)
    total_us: float
    mean_us: float       # per-call mean — the bandwidth basis
    payload_bytes: int   # nccl-tests-sized message (full logical tensor)
    dtype: str = ""
    group_size: int = 1
    axis: str = "?"
    algbw_gbps: float = 0.0
    busbw_gbps: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class CollectiveLedger:
    entries: list[LedgerEntry] = field(default_factory=list)
    # traced calls with no site in the step (beyond the law's count, or
    # of another element count) — any entry here fails the join
    unmatched_events: dict = field(default_factory=dict)
    # sites measured fewer times than the traced steps
    unmeasured_instances: list = field(default_factory=list)
    async_done_us: float = 0.0
    axis_sizes: dict = field(default_factory=dict)
    contract_join: dict | None = None

    # ---- derived --------------------------------------------------------
    def sites_by_kind(self, measured_only: bool = True) -> dict[str, int]:
        """Distinct site count per kind.  With ``measured_only=False``
        the unmeasured sites are included — that total is what the
        contract range is checked against."""
        out: dict[str, int] = {}
        for e in self.entries:
            out[e.kind] = out.get(e.kind, 0) + 1
        if not measured_only:
            for rec in self.unmeasured_instances:
                k = rec["kind"] if isinstance(rec, dict) else rec.kind
                out[k] = out.get(k, 0) + 1
        return out

    def aggregates(self) -> dict[str, dict]:
        """(kind, payload bucket, axis) -> pooled stats.  Bandwidth is
        time-weighted over the pooled events (total bytes over total
        time), not a mean of means."""
        out: dict[str, dict] = {}
        for e in self.entries:
            key = f"{e.kind}|{payload_bucket(e.payload_bytes)}|{e.axis}"
            a = out.setdefault(key, {
                "kind": e.kind,
                "payload_bucket": payload_bucket(e.payload_bytes),
                "axis": e.axis, "sites": 0, "events": 0,
                "total_us": 0.0, "bytes_moved": 0,
                "bus_bytes_moved": 0.0})
            a["sites"] += 1
            a["events"] += e.occurrences
            a["total_us"] += e.total_us
            a["bytes_moved"] += e.payload_bytes * e.occurrences
            factor = (e.busbw_gbps / e.algbw_gbps) if e.algbw_gbps else 1.0
            a["bus_bytes_moved"] += e.payload_bytes * e.occurrences * factor
        for a in out.values():
            t = a["total_us"]
            a["algbw_gbps"] = round(a["bytes_moved"] / t / 1e3, 4) if t \
                else 0.0
            a["busbw_gbps"] = round(a["bus_bytes_moved"] / t / 1e3, 4) \
                if t else 0.0
            a["bus_bytes_moved"] = round(a["bus_bytes_moved"], 1)
        return out

    def totals(self) -> dict:
        total_us = sum(e.total_us for e in self.entries)
        bus_bytes = sum(
            e.payload_bytes * e.occurrences
            * ((e.busbw_gbps / e.algbw_gbps) if e.algbw_gbps else 1.0)
            for e in self.entries)
        return {
            "measured_sites": len(self.entries),
            "unmeasured_sites": len(self.unmeasured_instances),
            "unmatched_events": len(self.unmatched_events),
            "events": sum(e.occurrences for e in self.entries),
            "total_us": round(total_us, 3),
            "async_done_us": round(self.async_done_us, 3),
            "busbw_gbps": round(bus_bytes / total_us / 1e3, 4)
            if total_us else 0.0,
        }

    # ---- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema": LEDGER_SCHEMA_VERSION,
            "axis_sizes": dict(self.axis_sizes),
            "totals": self.totals(),
            "entries": [e.to_dict() for e in self.entries],
            "aggregates": self.aggregates(),
            "unmatched_events": dict(self.unmatched_events),
            "unmeasured_instances": list(self.unmeasured_instances),
            "contract_join": self.contract_join,
        }

    def write(self, run_dir: str) -> str:
        path = os.path.join(run_dir, LEDGER_FILENAME)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)
            f.write("\n")
        return path


# ------------------------------------------------------------------ build

def site_payload(kind: str, nbytes: int, group: int) -> int:
    """nccl-tests message sizing of a call whose caller's tensor has
    ``nbytes``: the full logical tensor — the output for all_gather
    (input × group), the input for reduce_scatter (its output × group)
    and for every other kind."""
    return nbytes * group if kind == "all_gather" else nbytes


def _entry(name, kind, site, calls, axis_sizes) -> LedgerEntry:
    from ..ops.busbench import bus_factor
    group = int(site.get("group", 1))
    payload = site_payload(kind, int(site["bytes"]), group)
    total_us = sum(c["us"] for c in calls)
    mean_us = total_us / len(calls)
    algbw = payload / mean_us / 1e3 if mean_us else 0.0
    return LedgerEntry(
        name=name, kind=kind, occurrences=len(calls),
        total_us=round(total_us, 3), mean_us=round(mean_us, 4),
        payload_bytes=int(payload), dtype=site.get("dtype", ""),
        group_size=group, axis=_axis_for_group(group, axis_sizes),
        algbw_gbps=round(algbw, 4),
        busbw_gbps=round(algbw * bus_factor(kind, group), 4))


def build_ledger(event_stats: dict, sites: list, steps: int = 1,
                 axis_sizes: dict | None = None) -> CollectiveLedger:
    """Join the trace's calls (``collective_event_stats``) against the
    shim's calls of one step (``sites``: ``CollectiveCounts.sites()``,
    in call order) over ``steps`` traced steps, by position within each
    kind (see the module docstring)."""
    axis_sizes = {k: int(v) for k, v in (axis_sizes or {}).items()}
    led = CollectiveLedger(axis_sizes=axis_sizes)
    by_kind: dict[str, list] = {}
    for s in sites:
        by_kind.setdefault(s["kind"], []).append(s)
    for kind in sorted(set(by_kind) | set(event_stats)):
        mine = by_kind.get(kind, [])
        calls = (event_stats.get(kind) or {}).get("calls", [])
        matched: list[list] = [[] for _ in mine]
        for i, c in enumerate(calls):
            j = i % len(mine) if mine else None
            if j is None or i >= len(mine) * steps or (
                    c.get("numel") is not None
                    and c["numel"] != mine[j]["numel"]):
                led.unmatched_events[f"{kind}#{i}"] = {
                    "count": 1, "total_us": c["us"],
                    "numel": c.get("numel")}
                continue
            matched[j].append(c)
        for j, (site, got) in enumerate(zip(mine, matched)):
            name = f"{kind}.{j}"
            if len(got) < steps:
                led.unmeasured_instances.append({
                    "name": name, "kind": kind,
                    "payload_bytes": site_payload(
                        kind, int(site["bytes"]), int(site.get("group", 1))),
                    "measured": len(got)})
                continue
            led.entries.append(_entry(name, kind, site, got, axis_sizes))
    return led


def ledger_from_trace(trace_dir: str, sites: list, steps: int = 1,
                      axis_sizes: dict | None = None,
                      session: str | None = None) -> CollectiveLedger | None:
    """Locate the (owned) trace file under ``trace_dir`` and build the
    ledger.  None when no trace exists."""
    from ..utils.trace_analysis import (collective_event_stats,
                                        latest_trace_file)
    tf = latest_trace_file(trace_dir, session=session)
    if tf is None:
        return None
    return build_ledger(collective_event_stats(tf), sites, steps,
                        axis_sizes)


# ------------------------------------------------------------ contract join

def join_contract(ledger: CollectiveLedger, expected: dict,
                  strategy: str = "") -> dict:
    """Measured-side contract verdict.  ``expected`` is the contract's
    expected dict (int / ``"lo..hi"`` / ``"any"`` per kind).  ok iff

      * every site was measured once a traced step (no
        ``missing_from_trace``),
      * no traced call fell outside the step's sites (no
        ``unmatched_measured``), and
      * the site count per kind sits in the expected range.

    The verdict is stored back on the ledger (``contract_join``) and
    returned."""
    compiled_sites = ledger.sites_by_kind(measured_only=False)
    measured_sites = ledger.sites_by_kind(measured_only=True)
    violations = []
    exp_out = {}
    kinds = KINDS + tuple(sorted(
        k for k in set(expected) | set(compiled_sites) if k not in KINDS))
    for kind in kinds:
        lo, hi = parse_expected_spec(expected.get(kind, 0))
        exp_out[kind] = expected.get(kind, 0)
        got = compiled_sites.get(kind, 0)
        if not lo <= got <= hi:
            hi_s = "inf" if hi == math.inf else int(hi)
            violations.append(
                f"{kind}: {got} compiled sites, contract expects "
                f"{lo}..{hi_s}")
    missing = [r["name"] for r in ledger.unmeasured_instances]
    unmatched = sorted(ledger.unmatched_events)
    for n in missing:
        violations.append(f"expected site never measured in trace: {n}")
    for n in unmatched:
        violations.append(f"measured collective outside the program: {n}")
    verdict = {
        "strategy": strategy,
        "ok": not violations,
        "expected": exp_out,
        "compiled_sites": compiled_sites,
        "measured_sites": measured_sites,
        "missing_from_trace": missing,
        "unmatched_measured": unmatched,
        "violations": violations,
    }
    ledger.contract_join = verdict
    return verdict


# ------------------------------------------------------------- read back

def load_ledger_dict(run_dir: str) -> dict | None:
    """The raw ``collectives.json`` of one run dir, or None."""
    path = os.path.join(run_dir, LEDGER_FILENAME)
    if not os.path.isfile(path):
        return None
    try:
        return json.load(open(path))
    except (OSError, json.JSONDecodeError):
        return None


def check_bandwidth_regressions(cur_aggs: dict, base_aggs: dict,
                                max_drop_pct: float = 20.0,
                                label: str = "", base_label: str = "") \
        -> list[dict]:
    """Diff two ledgers' (kind, bucket, axis) aggregates: one record per
    key present in both, ``regressed`` when busbw dropped more than
    ``max_drop_pct`` percent — the ``--fail-on-bandwidth-regression``
    gate behind ``train/report.py``."""
    results = []
    for key, cur in sorted((cur_aggs or {}).items()):
        base = (base_aggs or {}).get(key)
        if not base:
            continue
        a, b = cur.get("busbw_gbps"), base.get("busbw_gbps")
        if not a or not b:
            continue
        delta_pct = (a / b - 1.0) * 100.0
        results.append({
            "run_id": label, "baseline": base_label, "key": key,
            "busbw_gbps": a, "baseline_busbw_gbps": b,
            "delta_pct": round(delta_pct, 2),
            "max_drop_pct": max_drop_pct,
            "regressed": delta_pct < -max_drop_pct,
        })
    return results
