"""Cross-run telemetry report: the twin of the JAX package's
``scripts/report.py``, same flags, same output, same exit codes.

Discovers the run directories the telemetry layer writes
(``<results_dir>/<run_id>/{manifest.json,steps.jsonl,summary.json}``),
renders the strategy × payload-shape comparison table (step time,
tokens/s, TFLOPS/device, memory, comm %, per-step collective counts),
the serving, fleet, lineage and chaos sections where runs carry them,
and the collective bandwidth table: every ``collectives.json``
aggregate (kind × payload bucket × mesh axis, the in-step NCCL reading)
beside the busbench sweep's busbw (``--roofline``: the JSON that
``train/busbench.py`` writes) and the NCCL reference hardware rows
(``--nccl-baseline``, default ``baselines/nccl_reference.json``).  With
``--baseline`` it computes regression deltas against a prior run dir, a
runs root, a ``summary.json`` or a bench-style JSON, and exits 1 when a
metric regresses beyond ``--tolerance`` or a ``--fail-on-*`` gate
trips.

    python -m distributed_training_sandbox_tpu_torch.train.report runs
    python -m distributed_training_sandbox_tpu_torch.train.report runs \\
        --roofline build/busbench/busbench_gpu_4dev.json
    python -m distributed_training_sandbox_tpu_torch.train.report runs \\
        --baseline old_runs --fail-on-bandwidth-regression 20
    python -m distributed_training_sandbox_tpu_torch.train.report runs \\
        --json

``--roofline`` defaults to the newest ``build/busbench/busbench_*.json``
(where ``train/busbench.py`` writes), not the JAX package's
``baselines/busbench_*.json``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..telemetry import report as R
from ..telemetry.schema import validate_step

REPO = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="side-by-side table + regression check over "
                    "telemetry run dirs")
    p.add_argument("paths", nargs="*", default=None,
                   help="run dirs or roots of run dirs (default: ./runs "
                        "or $RESULTS_DIR)")
    p.add_argument("--baseline", default=None,
                   help="prior run dir / runs root / summary.json / "
                        "bench-style JSON to diff against")
    p.add_argument("--tolerance", type=float, default=0.15,
                   help="allowed fractional slowdown before a metric "
                        "counts as regressed (default 0.15)")
    p.add_argument("--fail-on-overlap-regression", type=float,
                   default=None, metavar="PCT",
                   help="with --baseline: exit nonzero when a run's "
                        "overlap %% (comm hidden behind compute) drops "
                        "more than PCT percentage points below its "
                        "baseline row")
    p.add_argument("--fail-on-bandwidth-regression", type=float,
                   default=None, metavar="PCT",
                   help="with --baseline: exit nonzero when any ledger "
                        "(collective, payload, axis) aggregate's busbw "
                        "drops more than PCT %% below its baseline")
    p.add_argument("--fail-on-memory-regression", type=float,
                   default=None, metavar="PCT",
                   help="with --baseline: exit nonzero when a run's "
                        "measured memory peak or any attributed category "
                        "grows more than PCT %% over its baseline")
    p.add_argument("--nccl-baseline", default=None, metavar="JSON",
                   help="NCCL reference table for the side-by-side "
                        "(default: baselines/nccl_reference.json)")
    p.add_argument("--roofline", default=None, metavar="JSON",
                   help="train/busbench.py sweep JSON for the roofline "
                        "column (default: newest "
                        "build/busbench/busbench_*.json)")
    p.add_argument("--steps", action="store_true",
                   help="also print the last 5 step events per run")
    p.add_argument("--strict", action="store_true",
                   help="schema-validate every step event; exit nonzero "
                        "on violations")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="emit the normalized rows + regression records "
                        "as JSON instead of tables")
    args = p.parse_args(argv)

    if not args.paths:
        from ..utils.config import default_results_dir
        args.paths = [default_results_dir()]

    recs = R.discover_runs(args.paths)
    rows = [R.run_row(rec) for rec in recs]

    # a chaos campaign report sitting in a results root rides along
    chaos_docs = []
    for root in args.paths:
        cp = Path(root) / "chaos_report.json"
        if cp.is_file():
            try:
                with open(cp) as f:
                    chaos_docs.append((json.load(f), str(cp)))
            except (OSError, json.JSONDecodeError):
                pass

    schema_problems = []
    if args.strict:
        for rec in recs:
            for ev in R.load_steps(rec["dir"]):
                for prob in validate_step(ev):
                    schema_problems.append(
                        f"{rec['dir']} step {ev.get('step')}: {prob}")

    if args.fail_on_overlap_regression is not None and not args.baseline:
        p.error("--fail-on-overlap-regression needs --baseline (the run "
                "dir or summary to diff overlap %% against)")
    if args.fail_on_bandwidth_regression is not None and not args.baseline:
        p.error("--fail-on-bandwidth-regression needs --baseline (the "
                "run dir whose collectives.json to diff against)")
    if args.fail_on_memory_regression is not None and not args.baseline:
        p.error("--fail-on-memory-regression needs --baseline (the "
                "run dir whose memory.json to diff against)")

    nccl_path = args.nccl_baseline or str(
        REPO / "baselines" / "nccl_reference.json")
    nccl_rows = R.load_nccl_reference(nccl_path)
    if args.roofline:
        roofline_rows = R.load_roofline(args.roofline)
    else:
        cands = sorted((REPO / "build" / "busbench").glob("busbench_*.json"),
                       key=lambda q: q.stat().st_mtime)
        roofline_rows = R.load_roofline(str(cands[-1])) if cands else []

    comparisons, overlap_cmp, bw_cmp, mem_cmp = [], [], [], []
    if args.baseline:
        base_rows = R.load_baseline_rows(args.baseline)
        comparisons = R.check_regressions(rows, base_rows,
                                          tolerance=args.tolerance)
        overlap_cmp = R.check_overlap_regressions(
            rows, base_rows,
            max_drop_pp=args.fail_on_overlap_regression
            if args.fail_on_overlap_regression is not None else 5.0)
        bw_cmp = R.check_bandwidth_regressions(
            rows, base_rows,
            max_drop_pct=args.fail_on_bandwidth_regression
            if args.fail_on_bandwidth_regression is not None else 20.0)
        mem_cmp = R.check_memory_regressions(
            rows, base_rows,
            max_growth_pct=args.fail_on_memory_regression
            if args.fail_on_memory_regression is not None else 20.0)
    regressed = [c for c in comparisons if c["regressed"]]
    overlap_regressed = ([c for c in overlap_cmp if c["regressed"]]
                         if args.fail_on_overlap_regression is not None
                         else [])
    bw_regressed = ([c for c in bw_cmp if c["regressed"]]
                    if args.fail_on_bandwidth_regression is not None
                    else [])
    mem_regressed = ([c for c in mem_cmp if c["regressed"]]
                     if args.fail_on_memory_regression is not None
                     else [])

    if args.as_json:
        print(json.dumps({"runs": rows, "comparisons": comparisons,
                          "overlap_comparisons": overlap_cmp,
                          "bandwidth_comparisons": bw_cmp,
                          "memory_comparisons": mem_cmp,
                          "chaos": [doc for doc, _ in chaos_docs],
                          "schema_problems": schema_problems}, indent=2,
                         default=str))
    else:
        print(f"# Telemetry report — {len(rows)} run(s) from "
              f"{', '.join(args.paths)}\n")
        print(R.render_table(rows))
        if any(r.get("tuner") for r in rows):
            print("\n## Tuner verdicts (plan-replayed runs)\n")
            print(R.render_tuner(rows))
        if any(r.get("serving") for r in rows):
            print("\n## Serving SLO (TTFT / per-token latency)\n")
            print(R.render_serving(rows))
        if any(r.get("fleet") for r in rows):
            print("\n## Serving fleet (per-replica SLO + event "
                  "timeline)\n")
            print(R.render_fleet(rows))
        if any(r.get("sim") for r in rows):
            print("\n## Fleet simulator (virtual-clock, per-tenant "
                  "fairness)\n")
            print(R.render_sim(rows))
        if any(r.get("lineage") for r in rows):
            print("\n## Restart lineage (stitched segments)\n")
            print(R.render_lineage(rows))
        for doc, src in chaos_docs:
            print(f"\n## Chaos campaign — {src}\n")
            print(R.render_chaos(doc))
        if any(r.get("ledger_aggregates") for r in rows):
            print("\n## Collective bus bandwidth (ledger vs roofline vs "
                  "NCCL reference)\n")
            print(R.render_bandwidth_table(rows, nccl_rows,
                                           roofline_rows))
        if any(r.get("memory_verdict") for r in rows):
            print("\n## Memory ledger (measured vs predicted "
                  "waterline)\n")
            print(R.render_memory_table(rows))
        if args.steps:
            for rec in recs:
                tail = R.load_steps(rec["dir"])[-5:]
                if tail:
                    print(f"\n## last steps — {rec['dir']}")
                    for ev in tail:
                        print(json.dumps(ev, default=str))
        if args.baseline:
            print(f"\n## Regression check vs {args.baseline} "
                  f"(tolerance ±{args.tolerance:.0%})\n")
            print(R.render_regressions(comparisons))
            if regressed:
                print(f"\nREGRESSIONS: {len(regressed)} metric(s) beyond "
                      f"tolerance")
            elif comparisons:
                print("\nno regressions beyond tolerance")
            print(f"\n## Overlap & step-time deltas vs {args.baseline}\n")
            print(R.render_overlap_deltas(overlap_cmp))
            if overlap_regressed:
                print(f"\nOVERLAP REGRESSIONS: {len(overlap_regressed)} "
                      f"run(s) lost more than "
                      f"{args.fail_on_overlap_regression:g} pp of overlap")
            if bw_cmp:
                print(f"\n## Collective busbw deltas vs {args.baseline}\n")
                print(R.render_bandwidth_regressions(bw_cmp))
            if bw_regressed:
                print(f"\nBANDWIDTH REGRESSIONS: {len(bw_regressed)} "
                      f"ledger aggregate(s) dropped more than "
                      f"{args.fail_on_bandwidth_regression:g} %")
            if mem_cmp:
                print(f"\n## Memory deltas vs {args.baseline}\n")
                print(R.render_memory_regressions(mem_cmp))
            if mem_regressed:
                print(f"\nMEMORY REGRESSIONS: {len(mem_regressed)} "
                      f"memory aggregate(s) grew more than "
                      f"{args.fail_on_memory_regression:g} %")
        if schema_problems:
            print("\n## Schema violations\n")
            for prob in schema_problems:
                print(f"* {prob}")

    if regressed or schema_problems or overlap_regressed \
            or bw_regressed or mem_regressed:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
