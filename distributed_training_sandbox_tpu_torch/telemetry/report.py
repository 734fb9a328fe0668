"""Cross-run report: discovery, side-by-side table, regression deltas.

A copy of the JAX package's ``telemetry/report.py``, every renderer
included (tuner, serving, fleet, simulator, lineage, chaos, bandwidth,
memory): both packages render the same run directories to the same
text and JSON.  Library behind ``train/report.py``.  It reads the run
directories the telemetry layer writes (``manifest.json`` +
``steps.jsonl`` + ``summary.json``, and ``collectives.json`` /
``memory.json`` through the port's ``ledger`` and ``memledger``) and
renders the strategy × payload-shape comparison table — step time,
tokens/s, comm %, per-step collective counts — and the in-step
collective bandwidth beside the busbench roofline and the NCCL
reference (``baselines/nccl_reference.json``).

Baselines for the regression check come in two shapes:
  * another run dir / runs root / ``summary.json`` (same schema), or
  * a bench-style JSON (``bench_matrix_tpu.json``'s ``{"matrix": [...]}``
    rows, a bare row list, or a ``BENCH_*.json`` benchmark artifact whose
    ``tail`` string embeds the row list) — field aliases are normalized
    (``step_ms``/``step_time_ms``, ``tokens_per_sec``/``tokens_per_second``).

The rendered strings are the reference's, word for word, "ICI" included:
the bitwise law between the two packages depends on it.
"""

from __future__ import annotations

import json
import os
from typing import Any

# identity fields a row may carry; two rows are comparable when every
# field PRESENT IN BOTH matches and at least one name-ish field does
_IDENTITY = ("strategy", "config", "model", "sequence_length",
             "batch_size", "device_count")
_ALIASES = {
    "step_ms": "step_time_ms",
    "tokens_per_sec": "tokens_per_second",
    "seq_len": "sequence_length",
    "seq": "sequence_length",
    "batch": "batch_size",
    "devices": "device_count",
    "num_devices": "device_count",
}


# --------------------------------------------------------------- discovery

def _is_run_dir(path: str) -> bool:
    return any(os.path.isfile(os.path.join(path, f))
               for f in ("manifest.json", "summary.json"))


def discover_runs(paths: list[str]) -> list[dict]:
    """Each path may be one run dir or a root of run dirs.  Returns one
    record per run: ``{"dir", "manifest", "summary", "num_steps"}``,
    sorted by run dir name (timestamps sort chronologically)."""
    dirs: list[str] = []
    for p in paths:
        if _is_run_dir(p):
            dirs.append(p)
        elif os.path.isdir(p):
            dirs += sorted(os.path.join(p, d) for d in os.listdir(p)
                           if _is_run_dir(os.path.join(p, d)))
    runs = []
    for d in sorted(dict.fromkeys(dirs)):
        rec: dict = {"dir": d, "manifest": None, "summary": None,
                     "num_steps": 0}
        for name, key in (("manifest.json", "manifest"),
                          ("summary.json", "summary")):
            f = os.path.join(d, name)
            if os.path.isfile(f):
                try:
                    rec[key] = json.load(open(f))
                except (OSError, json.JSONDecodeError):
                    pass
        steps = os.path.join(d, "steps.jsonl")
        if os.path.isfile(steps):
            with open(steps) as f:
                rec["num_steps"] = sum(1 for line in f if line.strip())
        runs.append(rec)
    return runs


def load_steps(run_dir: str) -> list[dict]:
    out = []
    path = os.path.join(run_dir, "steps.jsonl")
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
    return out


# ----------------------------------------------------------- normalization

def _normalize(row: dict) -> dict:
    out = {}
    for k, v in row.items():
        out[_ALIASES.get(k, k)] = v
    return out


def run_row(rec: dict) -> dict:
    """Flatten one discovered run record into a normalized metrics row."""
    man = rec.get("manifest") or {}
    summ = dict(rec.get("summary") or {})
    cfg = man.get("config") or {}
    row: dict[str, Any] = {
        "run_id": man.get("run_id") or summ.get("run_id")
        or os.path.basename(rec["dir"]),
        "dir": rec["dir"],
        "strategy": summ.get("strategy") or man.get("strategy") or "?",
        "model": summ.get("model") or man.get("model"),
        "sequence_length": summ.get("sequence_length")
        or cfg.get("sequence_length"),
        "batch_size": summ.get("batch_size") or cfg.get("batch_size"),
        "device_count": man.get("device_count"),
        "platform": man.get("platform"),
        "status": summ.get("status", "?"),
        "num_steps": rec.get("num_steps", 0),
        "collective_counts": man.get("collective_counts"),
        # choreography-contract verdict (analysis.evaluate_contract),
        # recorded by the strategy scripts since manifests grew the field
        "contract_ok": (man.get("contract") or {}).get("ok"),
        # restart lineage (resilience.supervisor): present only on runs
        # that ran under an active supervisor — rendered as stitched
        # segments below the main table
        "lineage": man.get("lineage"),
    }
    # memory planner record (scripts record it in manifest extra):
    # predicted analytic waterline, the compiler-reported one when the
    # run was planned, and the budget it was judged against
    mp = (man.get("extra") or {}).get("memory_plan") or {}
    for src, dst in (("predicted_gb", "predicted_gb"),
                     ("compiled_gb", "compiled_gb"),
                     ("budget_gb", "hbm_budget_gb"),
                     ("auto_fit", "auto_fit")):
        if mp.get(src) is not None:
            row[dst] = mp[src]
    for k in ("step_time_ms", "tokens_per_second", "tflops_per_device",
              "avg_loss", "final_loss", "peak_memory_gb"):
        if summ.get(k) is not None:
            row[k] = summ[k]
    sp = summ.get("comm_split") or {}
    if sp.get("comm_fraction") is not None:
        row["comm_fraction"] = sp["comm_fraction"]
    if sp.get("overlap_fraction") is not None:
        row["overlap_fraction"] = sp["overlap_fraction"]
    if summ.get("host_sync_count") is not None:
        row["host_sync_count"] = summ["host_sync_count"]
    # tuner verdict (tuner.plan_manifest_stamp): present only on runs
    # that replayed a plan via --plan — rendered as its own section so
    # every replay is traceable back to the plan that chose its knobs
    tuner = (man.get("extra") or {}).get("tuner") \
        or cfg.get("tuner") or summ.get("tuner")
    if tuner is not None:
        row["tuner"] = tuner
    # serving SLO block (serving.ServingEngine.slo_report, filed by
    # scripts/serve_bench.py) — rendered as its own section
    if summ.get("serving") is not None:
        row["serving"] = summ["serving"]
    # fleet block (serving.Fleet.slo_report, filed by serve_bench
    # --replicas N): per-replica SLO + the failover/swap event timeline
    if summ.get("fleet") is not None:
        row["fleet"] = summ["fleet"]
    # simulator block (sim.SimFleet.slo_report, filed by
    # scripts/sim_bench.py): virtual-clock fleet run — per-tenant
    # fairness + attainment curves; substrate-tagged so it never joins
    # a wall-clock comparison silently
    if summ.get("sim") is not None:
        row["sim"] = summ["sim"]
        if summ.get("sim_variants") is not None:
            row["sim_variants"] = summ["sim_variants"]
    # collective ledger (telemetry.ledger): measured contract verdict +
    # bus bandwidth from the compact manifest/summary block, per-(kind,
    # payload, axis) aggregates from the run dir's collectives.json —
    # the ICI side of the NCCL-vs-ICI table and the bandwidth gate
    led = summ.get("ledger") or man.get("ledger") or {}
    if led:
        if "ok" in led:
            row["ledger_ok"] = led.get("ok")
        if led.get("busbw_gbps") is not None:
            row["ledger_busbw_gbps"] = led.get("busbw_gbps")
    from .ledger import load_ledger_dict
    ld = load_ledger_dict(rec["dir"])
    if ld:
        row["ledger_aggregates"] = ld.get("aggregates") or {}
        tot = ld.get("totals") or {}
        if tot.get("busbw_gbps") is not None:
            row.setdefault("ledger_busbw_gbps", tot["busbw_gbps"])
        cj = ld.get("contract_join") or {}
        if "ok" in cj:
            row.setdefault("ledger_ok", cj["ok"])
    # memory ledger (telemetry.memledger): the MemoryVerdict — measured
    # allocator peak vs compiled memory_analysis() waterline vs planner
    # prediction — plus flattened per-category aggregates from
    # memory.json, feeding the measured-vs-predicted table and the
    # --fail-on-memory-regression gate
    mv = summ.get("memory") or man.get("memory") or {}
    if mv:
        row["memory_verdict"] = mv
        if "ok" in mv:
            row["memory_ok"] = mv.get("ok")
        if mv.get("measured_gb") is not None:
            row["measured_peak_gb"] = mv["measured_gb"]
    from .memledger import load_memory_dict, memory_aggregates
    md = load_memory_dict(rec["dir"])
    if md:
        row["memory_aggregates"] = memory_aggregates(md)
    return row


def load_baseline_rows(path: str) -> list[dict]:
    """Normalize any supported baseline source into metric rows."""
    if os.path.isdir(path):
        return [run_row(rec) for rec in discover_runs([path])]
    try:
        data = json.load(open(path))
    except (OSError, json.JSONDecodeError):
        return []
    if isinstance(data, list):
        rows = data
    elif isinstance(data, dict):
        if os.path.basename(path) == "summary.json":
            return [run_row({"dir": os.path.dirname(path) or ".",
                             "manifest": None, "summary": data,
                             "num_steps": 0})]
        rows = data.get("matrix") or data.get("rows")
        if rows is None and isinstance(data.get("tail"), str):
            rows = _rows_from_tail(data["tail"])
        if rows is None:
            rows = [data]
    else:
        return []
    return [_normalize(r) for r in rows if isinstance(r, dict)]


def _rows_from_tail(tail: str) -> list[dict]:
    """Best-effort recovery of the row list a BENCH_*.json benchmark
    artifact embeds in its truncated ``tail`` log text: parse every
    balanced {...} object and keep the ones that look like metric rows."""
    rows, depth, start = [], 0, None
    for i, ch in enumerate(tail):
        if ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}" and depth:
            depth -= 1
            if depth == 0 and start is not None:
                try:
                    obj = json.loads(tail[start:i + 1])
                except json.JSONDecodeError:
                    continue
                if isinstance(obj, dict) and (
                        "tokens_per_sec" in obj or "step_ms" in obj
                        or "tokens_per_second" in obj
                        or "step_time_ms" in obj):
                    rows.append(obj)
    return rows


# ----------------------------------------------------------------- table

def _fmt(v, spec=".1f") -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return format(v, spec)
    return str(v)


def _mem_cell(r: dict) -> str:
    """Memory column: the memory ledger's measured peak when one was
    filed (measured beats modeled), else the compiler-reported waterline
    when the run was planned, else the analytic prediction (``~``
    prefix), else the tracker's sampled allocator peak; budget appended
    when one gated the run."""
    if r.get("measured_peak_gb") is not None:
        cell = _fmt(float(r["measured_peak_gb"]), ".2f")
    elif r.get("compiled_gb") is not None:
        cell = _fmt(float(r["compiled_gb"]), ".2f")
    elif r.get("predicted_gb") is not None:
        cell = "~" + _fmt(float(r["predicted_gb"]), ".2f")
    elif r.get("peak_memory_gb") is not None:
        cell = _fmt(float(r["peak_memory_gb"]), ".2f")
    else:
        return "—"
    if r.get("hbm_budget_gb") is not None:
        cell += f"/{float(r['hbm_budget_gb']):.1f}"
    return cell


def render_table(rows: list[dict]) -> str:
    """Strategy × payload-shape side-by-side markdown table."""
    if not rows:
        return "_no runs found_"
    out = ["| run | strategy | model | seq | batch | dev | steps | "
           "step ms | tok/s | TFLOPS/dev | mem GB | comm % | overlap % | "
           "host syncs | collectives/step | status |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"
           "---|"]
    for r in sorted(rows, key=lambda r: (r.get("strategy") or "",
                                         str(r.get("model")),
                                         r.get("run_id") or "")):
        cc = r.get("collective_counts") or {}
        cc_cell = str(cc.get("total")) if cc else "—"
        # annotate with the contract verdict when one was recorded
        if r.get("contract_ok") is True:
            cc_cell += " ✓"
        elif r.get("contract_ok") is False:
            cc_cell += " ✗"
        # second mark: the trace-measured ledger verdict, when one ran
        if r.get("ledger_ok") is True:
            cc_cell += "⋈✓"
        elif r.get("ledger_ok") is False:
            cc_cell += "⋈✗"
        # third mark: the memory ledger's measured-waterline verdict
        if r.get("memory_ok") is True:
            cc_cell += "▦✓"
        elif r.get("memory_ok") is False:
            cc_cell += "▦✗"
        comm = r.get("comm_fraction")
        ovl = r.get("overlap_fraction")
        out.append(
            f"| {r.get('run_id', '—')} | {r.get('strategy', '—')} "
            f"| {r.get('model') or '—'} "
            f"| {r.get('sequence_length') or '—'} "
            f"| {r.get('batch_size') or '—'} "
            f"| {r.get('device_count') or '—'} "
            f"| {r.get('num_steps') or '—'} "
            f"| {_fmt(r.get('step_time_ms'), '.2f')} "
            f"| {_fmt(r.get('tokens_per_second'), '.0f')} "
            f"| {_fmt(r.get('tflops_per_device'), '.2f')} "
            f"| {_mem_cell(r)} "
            f"| {_fmt(100 * comm if comm is not None else None, '.1f')} "
            f"| {_fmt(100 * ovl if ovl is not None else None, '.1f')} "
            f"| {_fmt(r.get('host_sync_count'), 'd')} "
            f"| {cc_cell} | {r.get('status', '—')} |")
    return "\n".join(out)


# ---------------------------------------------------------------- serving

def render_serving(rows: list[dict]) -> str:
    """Latency-SLO table for every run that filed a ``serving`` block
    (``serving.ServingEngine.slo_report`` via ``scripts/serve_bench.py``):
    TTFT / per-token percentiles, throughput per device, pool and
    scheduler health, and the recompile watch's verdict."""
    srows = [r for r in rows if r.get("serving")]
    if not srows:
        return "_no serving runs_"
    out = ["| run | reqs | done | TTFT p50/p99 ms | tok p50/p99 ms | "
           "tok/s | tok/s/dev | occ | pool peak | cache hit | "
           "spec acc | retraces | mode |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(srows, key=lambda r: r.get("run_id") or ""):
        s = r["serving"]
        ttft = s.get("ttft_ms") or {}
        ptl = s.get("per_token_ms") or {}
        sched = s.get("scheduler") or {}
        pool = s.get("pool") or {}
        rt = s.get("recompiles_after_warmup")
        mode = "disagg" if s.get("disaggregated") else "unified"
        if s.get("kv_quant"):
            mode += "+kvq"
        if s.get("flash_prefill"):
            mode += "+flash"
        pc = s.get("prefix_cache") or {}
        sp = s.get("speculative") or {}
        hit = (f"{100 * pc['hit_rate']:.0f}%"
               if pc.get("hit_rate") is not None else "—")
        acc = (f"{100 * sp['acceptance_rate']:.0f}% (k={sp.get('k')})"
               if sp.get("acceptance_rate") is not None else "—")
        out.append(
            f"| {r.get('run_id', '—')} "
            f"| {_fmt(s.get('requests'), 'd')} "
            f"| {_fmt(s.get('completed'), 'd')} "
            f"| {_fmt(ttft.get('p50'), '.1f')}/{_fmt(ttft.get('p99'), '.1f')} "
            f"| {_fmt(ptl.get('p50'), '.2f')}/{_fmt(ptl.get('p99'), '.2f')} "
            f"| {_fmt(s.get('tokens_per_s'), '.1f')} "
            f"| {_fmt(s.get('tokens_per_s_per_device'), '.2f')} "
            f"| {_fmt(sched.get('mean_occupancy'), '.2f')} "
            f"| {_fmt(pool.get('peak_util'), '.2f')} "
            f"| {hit} "
            f"| {acc} "
            f"| {'0 ✓' if rt == 0 else _fmt(rt, 'd') if rt is not None else '—'} "
            f"| {mode} |")
    return "\n".join(out)


# ----------------------------------------------------------------- tuner

def render_tuner(rows: list[dict]) -> str:
    """Tuner-verdict table for every run that replayed a plan
    (``tuner.plan_manifest_stamp`` stamped via a training script's
    ``--plan``): the chosen candidate, the plan's provenance hashes, and
    predicted vs this run's numbers — the closed loop made visible."""
    trows = [r for r in rows if r.get("tuner")]
    if not trows:
        return "_no plan-replayed runs_"
    out = ["| run | plan | objective | chosen | knob space | cost model "
           "| predicted tok/s | plan-measured tok/s | this run tok/s |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(trows, key=lambda r: r.get("run_id") or ""):
        t = r["tuner"]
        pred = t.get("predicted") or {}
        meas = t.get("measured") or {}
        out.append(
            f"| {r.get('run_id', '—')} "
            f"| {t.get('plan') or '—'} "
            f"| {t.get('objective') or '—'} "
            f"| {t.get('chosen') or '—'} "
            f"| {t.get('knob_space_hash') or '—'} "
            f"| {t.get('cost_model_hash') or '—'} "
            f"| {_fmt(pred.get('predicted_tokens_per_sec'), '.1f')} "
            f"| {_fmt(meas.get('tokens_per_sec'), '.1f')} "
            f"| {_fmt(r.get('tokens_per_second'), '.1f')} |")
    return "\n".join(out)


# ----------------------------------------------------------------- fleet

def render_fleet(rows: list[dict]) -> str:
    """Per-replica SLO table + event timeline for every run that filed
    a ``fleet`` block (``serving.Fleet.slo_report`` via ``serve_bench
    --replicas N``).  One row per replica so a dead replica's partial
    service and its survivors' absorbed load sit side by side; below
    each run, the failover/shed/swap event timeline."""
    frows = [r for r in rows if r.get("fleet")]
    if not frows:
        return "_no fleet runs_"
    out = ["| run | replica | state | reqs | done | TTFT p50/p99 ms | "
           "tok p50/p99 ms | tok/s | bursts | retraces |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    lines = []
    for r in sorted(frows, key=lambda r: r.get("run_id") or ""):
        f = r["fleet"]
        ttft = f.get("ttft_ms") or {}
        ptl = f.get("per_token_ms") or {}
        rt = f.get("recompiles_after_warmup")
        out.append(
            f"| {r.get('run_id', '—')} | **fleet** "
            f"| {f.get('live', '—')}/{f.get('replicas', '—')} live "
            f"| {_fmt(f.get('submitted'), 'd')} "
            f"| {_fmt(f.get('completed'), 'd')} "
            f"| {_fmt(ttft.get('p50'), '.1f')}/{_fmt(ttft.get('p99'), '.1f')} "
            f"| {_fmt(ptl.get('p50'), '.2f')}/{_fmt(ptl.get('p99'), '.2f')} "
            f"| — | — "
            f"| {'0 ✓' if rt == 0 else _fmt(rt, 'd') if rt is not None else '—'} |")
        for s in f.get("replica_slo") or []:
            sttft = s.get("ttft_ms") or {}
            sptl = s.get("per_token_ms") or {}
            srt = s.get("recompiles_after_warmup")
            state = s.get("state", "?")
            if s.get("death"):
                state += f" ({s['death']})"
            out.append(
                f"| {r.get('run_id', '—')} | {s.get('replica', '—')} "
                f"| {state} "
                f"| {_fmt(s.get('requests'), 'd')} "
                f"| {_fmt(s.get('completed'), 'd')} "
                f"| {_fmt(sttft.get('p50'), '.1f')}/{_fmt(sttft.get('p99'), '.1f')} "
                f"| {_fmt(sptl.get('p50'), '.2f')}/{_fmt(sptl.get('p99'), '.2f')} "
                f"| {_fmt(s.get('tokens_per_s'), '.1f')} "
                f"| {_fmt(s.get('bursts'), 'd')} "
                f"| {'0 ✓' if srt == 0 else _fmt(srt, 'd') if srt is not None else '—'} |")
        shed = f.get("shed", 0)
        drop = f.get("dropped", 0)
        ev = f.get("events") or []
        tl = "; ".join(
            f"{e.get('t_s', '?')}s {e.get('event', '?')}"
            + (f" r{e['replica']}" if "replica" in e else "")
            + (f" ({e['trigger']})" if "trigger" in e else "")
            for e in ev) or "none"
        lines.append(f"- `{r.get('run_id', '—')}`: shed {shed}, "
                     f"dropped {drop}"
                     + (" ⚠" if drop else " ✓")
                     + f"; events: {tl}")
    return "\n".join(out) + "\n\n" + "\n".join(lines)


# ------------------------------------------------------------------- sim

def render_sim(rows: list[dict]) -> str:
    """Virtual-clock fleet runs (``sim.SimFleet.slo_report`` via
    ``scripts/sim_bench.py``): the fleet-scale numbers only the
    simulator can afford — per-tenant SLO attainment and fairness over
    10^5+ offered requests — plus the policy-variant ranking when the
    run evaluated one.  All times are VIRTUAL seconds priced by the
    run's calibrated cost model (``cost_model.source`` says which
    measured run priced them)."""
    srows = [r for r in rows if r.get("sim")]
    if not srows:
        return "_no simulator runs_"
    out = ["| run | offered | done | shed | TTFT p50/p99 ms | "
           "SLO ms | attained | Jain | worst tenant | cost model |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    lines = []
    for r in sorted(srows, key=lambda r: r.get("run_id") or ""):
        s = r["sim"]
        ttft = s.get("ttft_ms") or {}
        fair = s.get("fairness") or {}
        worst = fair.get("worst_tenant") or {}
        att = s.get("attainment") or {}
        # overall attainment at the report's SLO threshold: nearest
        # grid point at or above slo_ms
        overall = None
        th = att.get("thresholds_ms") or []
        cur = att.get("overall") or []
        slo = s.get("slo_ms")
        if th and cur and slo is not None:
            idx = min((i for i, g in enumerate(th) if g >= slo),
                      default=len(th) - 1)
            overall = cur[idx]
        cm = (s.get("cost_model") or {}).get("source", "—")
        out.append(
            f"| {r.get('run_id', '—')} "
            f"| {_fmt(s.get('offered'), 'd')} "
            f"| {_fmt(s.get('completed'), 'd')} "
            f"| {_fmt(s.get('shed'), 'd')} "
            f"| {_fmt(ttft.get('p50'), '.1f')}/{_fmt(ttft.get('p99'), '.1f')} "
            f"| {_fmt(slo, '.0f')} "
            f"| {_fmt(overall, '.1%')} "
            f"| {_fmt(fair.get('jain_attainment'), '.3f')} "
            f"| t{worst.get('tenant', '—')} @ "
            f"{_fmt(worst.get('attainment'), '.1%')} "
            f"| {cm} |")
        ev = s.get("events") or []
        tl = "; ".join(
            f"{e.get('t_s', '?')}s {e.get('event', '?')}"
            + (f" r{e['replica']}" if "replica" in e else "")
            for e in ev) or "none"
        lines.append(
            f"- `{r.get('run_id', '—')}`: virtual "
            f"{_fmt(s.get('virtual_duration_s'), '.1f')}s on "
            f"{s.get('replicas', '—')} replicas, digest "
            f"`{(s.get('digest') or '—')[:16]}`; events: {tl}")
        for v in r.get("sim_variants") or []:
            vt = v.get("ttft_ms") or {}
            lines.append(
                f"  - variant `{v.get('name')}` "
                f"{v.get('overrides') or {}}: objective "
                f"{_fmt(v.get('objective'), '.1f')}, TTFT p99 "
                f"{_fmt(vt.get('p99'), '.1f')} ms, shed "
                f"{_fmt(v.get('shed'), 'd')}")
    return "\n".join(out) + "\n\n" + "\n".join(lines)


# ---------------------------------------------------------------- lineage

def _fmt_segment(seg: dict) -> str:
    span = f"{seg.get('start_step', '?')}..{seg.get('end_step', '?')}"
    scope = f"{seg['scope']}:" if seg.get("scope") else ""
    return f"[{scope}{span} {seg.get('status', '?')}]"


def _fmt_transition(tr: dict) -> str:
    lost = tr.get("lost_ranks") or []
    at = (f" at step {tr['step']}" if tr.get("step") is not None else "")
    why = tr.get("trigger", "?")
    who = f", lost ranks {lost}" if lost else ""
    return (f"{tr.get('old_world', '?')} → {tr.get('new_world', '?')} "
            f"({why}{who}{at})")


def render_lineage(rows: list[dict]) -> str:
    """Stitched-segment view of every run whose manifest carries restart
    lineage: the prior segments' spans/status chained into this run,
    plus where it resumed, whether the collective contract re-check
    passed on restore, and — for elastic runs — the mesh transitions
    (old/new world size, trigger, lost ranks)."""
    out = []
    for r in rows:
        lin = r.get("lineage") or {}
        if not lin:
            continue
        segs = [s for s in (lin.get("segments") or [])
                if isinstance(s, dict)]
        chain = " → ".join(_fmt_segment(s) for s in segs) if segs else ""
        transitions = [t for t in (lin.get("mesh_transitions") or [])
                       if isinstance(t, dict)]
        scopes = [("", lin)] + sorted((lin.get("scopes") or {}).items())
        resumed = []
        for label, sc in scopes:
            if not isinstance(sc, dict) or sc.get("resumed_from_step") \
                    is None:
                continue
            rc = sc.get("resume_contract") or {}
            mark = " contract ✓" if rc.get("ok") is True \
                else " contract ✗" if rc.get("ok") is False else ""
            resumed.append(
                f"{label + ' ' if label else ''}resumed from step "
                f"{sc['resumed_from_step']}{mark}")
        line = (f"- **{r.get('run_id', '?')}** "
                f"(attempt {lin.get('attempt', 0)}"
                f"/{lin.get('max_restarts', 0)} restarts)")
        if resumed:
            line += ": " + "; ".join(resumed)
        if chain:
            line += f"\n  - segments: {chain} → this run"
        if transitions:
            line += ("\n  - mesh transitions (elastic): "
                     + "; ".join(_fmt_transition(t) for t in transitions))
        out.append(line)
    return "\n".join(out) if out else "_no runs with restart lineage_"


def render_chaos(doc: dict) -> str:
    """Campaign table for one ``chaos_report.json`` (scripts/chaos.py):
    the (fault x strategy) matrix with per-cell verdicts and, for red
    cells, which invariant broke."""
    cells = [c for c in (doc.get("cells") or []) if isinstance(c, dict)]
    if not cells:
        return "_no chaos cells in report_"
    out = [f"| {'cell':24} | {'fault':13} | {'strategy':8} | "
           f"{'status':6} | {'dur_s':>6} | invariants |",
           f"|{'-' * 26}|{'-' * 15}|{'-' * 10}|{'-' * 8}|{'-' * 8}|"
           f"{'-' * 12}|"]
    for c in cells:
        inv = c.get("invariants") or {}
        bad = [k for k, v in inv.items() if not v]
        mark = "✓ " + f"{len(inv)}/{len(inv)}" if not bad else \
            "✗ failed: " + ", ".join(bad)
        dur = c.get("duration_s")
        out.append(
            f"| {str(c.get('cell', '?')):24} "
            f"| {str(c.get('fault', '?')):13} "
            f"| {str(c.get('strategy', '?')):8} "
            f"| {str(c.get('status', '?')):6} "
            f"| {dur if dur is not None else '-':>6} | {mark} |")
    s = doc.get("summary") or {}
    out.append(f"\n{s.get('green', '?')}/{s.get('total', '?')} cell(s) "
               f"green"
               + (f" — {s.get('red')} RED" if s.get("red") else ""))
    return "\n".join(out)


# ------------------------------------------------------------ regressions

def _match(cur: dict, base: dict) -> bool:
    name_match = False
    for k in _IDENTITY:
        a, b = cur.get(k), base.get(k)
        if a is None or b is None:
            continue
        if a != b:
            return False
        if k in ("strategy", "config", "model"):
            name_match = True
    return name_match


def check_regressions(current: list[dict], baseline: list[dict],
                      tolerance: float = 0.15) -> list[dict]:
    """Compare each current row against every comparable baseline row.
    A regression is step time above baseline × (1+tol) or tokens/s below
    baseline × (1−tol).  Returns one record per comparison; records with
    ``"regressed": True`` should fail the caller."""
    results = []
    for cur in current:
        for base in baseline:
            if cur is base or not _match(cur, base):
                continue
            for metric, worse_is in (("step_time_ms", "higher"),
                                     ("tokens_per_second", "lower")):
                a, b = cur.get(metric), base.get(metric)
                if a is None or b is None or not b:
                    continue
                delta = a / b - 1.0
                regressed = (delta > tolerance if worse_is == "higher"
                             else delta < -tolerance)
                results.append({
                    "run_id": cur.get("run_id"),
                    "baseline": base.get("run_id") or base.get("config")
                    or base.get("strategy"),
                    "metric": metric,
                    "current": a,
                    "baseline_value": b,
                    "delta": delta,
                    "tolerance": tolerance,
                    "regressed": regressed,
                })
    return results


def check_overlap_regressions(current: list[dict], baseline: list[dict],
                              max_drop_pp: float = 5.0) -> list[dict]:
    """Overlap A/B between comparable rows: for every (current, baseline)
    pair that :func:`_match` accepts and where BOTH carry
    ``overlap_fraction`` (the comm-concurrent-with-compute share from
    ``trace_analysis.CommSplit``), record the overlap delta in
    PERCENTAGE POINTS alongside the step-time delta, flagging
    ``regressed`` when overlap dropped by more than ``max_drop_pp`` pp —
    the CI gate behind ``report.py --fail-on-overlap-regression``."""
    results = []
    for cur in current:
        for base in baseline:
            if cur is base or not _match(cur, base):
                continue
            a, b = cur.get("overlap_fraction"), base.get("overlap_fraction")
            if a is None or b is None:
                continue
            delta_pp = (float(a) - float(b)) * 100.0
            st_cur, st_base = cur.get("step_time_ms"), \
                base.get("step_time_ms")
            step_delta = (st_cur / st_base - 1.0
                          if st_cur and st_base else None)
            results.append({
                "run_id": cur.get("run_id"),
                "baseline": base.get("run_id") or base.get("config")
                or base.get("strategy"),
                "overlap_pct": 100.0 * float(a),
                "baseline_overlap_pct": 100.0 * float(b),
                "overlap_delta_pp": delta_pp,
                "step_time_ms": st_cur,
                "baseline_step_time_ms": st_base,
                "step_time_delta": step_delta,
                "max_drop_pp": max_drop_pp,
                "regressed": delta_pp < -max_drop_pp,
            })
    return results


def render_overlap_deltas(results: list[dict]) -> str:
    if not results:
        return "_no comparable rows carry overlap data (profile-enabled " \
               "runs write comm_split.overlap_fraction into summary.json)_"
    out = ["| run | baseline | overlap % | base overlap % | Δ pp | "
           "step ms | base step ms | Δ step | verdict |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in results:
        sd = r.get("step_time_delta")
        out.append(
            f"| {r['run_id']} | {r['baseline']} "
            f"| {_fmt(r['overlap_pct'], '.1f')} "
            f"| {_fmt(r['baseline_overlap_pct'], '.1f')} "
            f"| {r['overlap_delta_pp']:+.1f} "
            f"| {_fmt(r.get('step_time_ms'), '.2f')} "
            f"| {_fmt(r.get('baseline_step_time_ms'), '.2f')} "
            f"| {f'{sd:+.1%}' if sd is not None else '—'} "
            f"| {'REGRESSED' if r['regressed'] else 'ok'} |")
    return "\n".join(out)


# ------------------------------------------------------- bus bandwidth

# ledger kinds use count_collectives spelling; busbench / NCCL tables
# call the permute "ppermute"
_KIND_ALIASES = {"collective_permute": "ppermute"}


def load_nccl_reference(path: str) -> list[dict]:
    """Rows of ``baselines/nccl_reference.json``: one record per
    (hardware, collective) with the reference busbw in GB/s.  Accepts the
    dict form (``{"rows": [...]}``) or a bare list."""
    try:
        data = json.load(open(path))
    except (OSError, json.JSONDecodeError):
        return []
    rows = data.get("rows") if isinstance(data, dict) else data
    return [r for r in (rows or []) if isinstance(r, dict)]


def load_roofline(path: str) -> list[dict]:
    """Rows of a ``scripts/busbench.py`` sweep JSON (the measured
    microbenchmark roofline).  Accepts the dict form (``{"platform",
    "rows": [...]}``) or the legacy bare row list; a platform tag is
    stamped onto each row when the file carries one."""
    try:
        data = json.load(open(path))
    except (OSError, json.JSONDecodeError):
        return []
    if isinstance(data, dict):
        rows = [r for r in (data.get("rows") or []) if isinstance(r, dict)]
        plat = data.get("platform")
        if plat:
            for r in rows:
                r.setdefault("platform", plat)
        return rows
    return [r for r in data if isinstance(r, dict)]


def _best_busbw(rows: list[dict], kind: str) -> float | None:
    """Peak busbw over a row set for one collective kind — the roofline
    reading (best payload size wins)."""
    name = _KIND_ALIASES.get(kind, kind)
    vals = [r.get("busbw_gbps") for r in rows
            if r.get("collective") in (name, kind)
            and r.get("busbw_gbps") is not None]
    return max(vals) if vals else None


def render_bandwidth_table(rows: list[dict],
                           nccl_rows: list[dict] | None = None,
                           roofline_rows: list[dict] | None = None) -> str:
    """The NCCL-vs-ICI side-by-side: every ledger aggregate (collective
    kind × payload bucket × mesh axis) of every run that filed a
    ``collectives.json``, beside the local busbench roofline (same
    accounting, microbenchmark conditions) and the NCCL reference
    hardware numbers."""
    lrows = [r for r in rows if r.get("ledger_aggregates")]
    if not lrows:
        return "_no runs carry a collective ledger (profile-enabled " \
               "runs with an attached HLO write collectives.json)_"
    nccl_rows = nccl_rows or []
    roofline_rows = roofline_rows or []
    out = ["| run | collective | payload | axis | sites | events | "
           "mean µs | busbw GB/s | roofline GB/s | NCCL ref GB/s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(lrows, key=lambda r: r.get("run_id") or ""):
        verdict = {True: " ⋈✓", False: " ⋈✗"}.get(r.get("ledger_ok"), "")
        first = True
        for key, a in sorted(r["ledger_aggregates"].items()):
            kind = a.get("kind", key.split("|")[0])
            roof = _best_busbw(roofline_rows, kind)
            nccl = [f"{n.get('hardware', '?')} {n['busbw_gbps']:.0f}"
                    for n in nccl_rows
                    if n.get("collective") in (
                        _KIND_ALIASES.get(kind, kind), kind)
                    and n.get("busbw_gbps") is not None]
            mean_us = (a["total_us"] / a["events"]) if a.get("events") \
                else None
            run_cell = (r.get("run_id", "—") + verdict) if first else "↳"
            first = False
            out.append(
                f"| {run_cell} | {kind} | {a.get('payload_bucket', '—')} "
                f"| {a.get('axis', '—')} | {_fmt(a.get('sites'), 'd')} "
                f"| {_fmt(a.get('events'), 'd')} "
                f"| {_fmt(mean_us, '.1f')} "
                f"| {_fmt(a.get('busbw_gbps'), '.3f')} "
                f"| {_fmt(roof, '.3f')} "
                f"| {', '.join(nccl) if nccl else '—'} |")
    return "\n".join(out)


def check_bandwidth_regressions(current: list[dict], baseline: list[dict],
                                max_drop_pct: float = 20.0) -> list[dict]:
    """Bandwidth gate between comparable rows: for every (current,
    baseline) pair :func:`_match` accepts where BOTH carry ledger
    aggregates, diff each shared (kind, payload bucket, axis) key's
    busbw via ``ledger.check_bandwidth_regressions`` — the CI gate
    behind ``report.py --fail-on-bandwidth-regression``."""
    from .ledger import check_bandwidth_regressions as _diff
    results = []
    for cur in current:
        for base in baseline:
            if cur is base or not _match(cur, base):
                continue
            ca, ba = cur.get("ledger_aggregates"), \
                base.get("ledger_aggregates")
            if not ca or not ba:
                continue
            results += _diff(ca, ba, max_drop_pct=max_drop_pct,
                             label=cur.get("run_id"),
                             base_label=base.get("run_id")
                             or base.get("strategy"))
    return results


def render_bandwidth_regressions(results: list[dict]) -> str:
    if not results:
        return "_no comparable rows carry ledger aggregates (both sides " \
               "need a collectives.json)_"
    out = ["| run | baseline | collective\\|payload\\|axis | busbw GB/s | "
           "base GB/s | Δ % | verdict |",
           "|---|---|---|---|---|---|---|"]
    for r in results:
        key = r["key"].replace("|", "\\|")
        out.append(
            f"| {r['run_id']} | {r['baseline']} "
            f"| {key} "
            f"| {_fmt(r['busbw_gbps'], '.3f')} "
            f"| {_fmt(r['baseline_busbw_gbps'], '.3f')} "
            f"| {r['delta_pct']:+.1f} "
            f"| {'REGRESSED' if r['regressed'] else 'ok'} |")
    return "\n".join(out)


# ------------------------------------------------------------- memory

def render_memory_table(rows: list[dict]) -> str:
    """The measured-vs-predicted waterline side-by-side: every run that
    filed a memory ledger (``memory.json`` + the MemoryVerdict), with the
    measured allocator peak, its source tier (``allocator`` on real HBM,
    ``accounted`` on the CPU sim where the backend exposes no stats),
    the compiled ``memory_analysis()`` waterline, the run's planner
    prediction, and the biggest attributed categories."""
    mrows = [r for r in rows if r.get("memory_verdict")]
    if not mrows:
        return "_no runs carry a memory ledger (profile-enabled runs " \
               "with an attached step HLO write memory.json)_"
    out = ["| run | measured GB | source | compiled GB | ratio | "
           "predicted GB | pred source | top categories | verdict |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(mrows, key=lambda r: r.get("run_id") or ""):
        v = r["memory_verdict"]
        cats = {k[4:]: gb for k, gb in
                (r.get("memory_aggregates") or {}).items()
                if k.startswith("cat/")}
        top = ", ".join(f"{k} {gb:.3f}" for k, gb in
                        sorted(cats.items(), key=lambda kv: -kv[1])[:3])
        out.append(
            f"| {r.get('run_id', '—')} "
            f"| {_fmt(v.get('measured_gb'), '.3f')} "
            f"| {v.get('measured_source', '—')} "
            f"| {_fmt(v.get('compiled_gb'), '.3f')} "
            f"| {_fmt(v.get('compiled_ratio'), '.2f')} "
            f"| {_fmt(v.get('predicted_gb'), '.3f')} "
            f"| {v.get('predicted_source', '—')} "
            f"| {top or '—'} "
            f"| {'ok' if v.get('ok') else 'FAIL'} |")
    return "\n".join(out)


def check_memory_regressions(current: list[dict], baseline: list[dict],
                             max_growth_pct: float = 20.0) -> list[dict]:
    """Memory gate between comparable rows: for every (current, baseline)
    pair :func:`_match` accepts where BOTH carry memory aggregates, diff
    each shared key's GB via ``memledger.check_memory_regressions`` —
    growth is the bad direction — the CI gate behind ``report.py
    --fail-on-memory-regression``."""
    from .memledger import check_memory_regressions as _diff
    results = []
    for cur in current:
        for base in baseline:
            if cur is base or not _match(cur, base):
                continue
            ca, ba = cur.get("memory_aggregates"), \
                base.get("memory_aggregates")
            if not ca or not ba:
                continue
            results += _diff(ca, ba, max_growth_pct=max_growth_pct,
                             label=cur.get("run_id"),
                             base_label=base.get("run_id")
                             or base.get("strategy"))
    return results


def render_memory_regressions(results: list[dict]) -> str:
    if not results:
        return "_no comparable rows carry memory aggregates (both sides " \
               "need a memory.json)_"
    out = ["| run | baseline | key | GB | base GB | Δ % | verdict |",
           "|---|---|---|---|---|---|---|"]
    for r in results:
        out.append(
            f"| {r['run_id']} | {r['baseline']} "
            f"| {r['key']} "
            f"| {_fmt(r['gb'], '.4f')} "
            f"| {_fmt(r['baseline_gb'], '.4f')} "
            f"| {r['delta_pct']:+.1f} "
            f"| {'REGRESSED' if r['regressed'] else 'ok'} |")
    return "\n".join(out)


def render_regressions(results: list[dict]) -> str:
    if not results:
        return "_no comparable baseline rows_"
    out = ["| run | baseline | metric | current | baseline | Δ | verdict |",
           "|---|---|---|---|---|---|---|"]
    for r in results:
        out.append(
            f"| {r['run_id']} | {r['baseline']} | {r['metric']} "
            f"| {_fmt(r['current'], '.2f')} "
            f"| {_fmt(r['baseline_value'], '.2f')} "
            f"| {r['delta']:+.1%} "
            f"| {'REGRESSED' if r['regressed'] else 'ok'} |")
    return "\n".join(out)
