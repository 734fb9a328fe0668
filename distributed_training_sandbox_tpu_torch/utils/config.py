"""The training flag surface: port of the JAX package's
``utils/config.py`` (``TrainConfig``, its ``from_args``, ``build_run_id``,
``default_results_dir``).  Field names, defaults, flags and their choices
are the reference's, so one argv gives one config in either package.  The
port's twins parse their own extra flags first (``--device``,
``--overlap`` with its ``ring_fused_pallas`` mode, the precision knobs)
and hand the rest to :meth:`TrainConfig.from_args`.  Fields the port
reads no further yet keep their place (``offload``, ``auto_fit``,
``hbm_budget_gb``, the elastic ones: ROADMAP.md queue A item A12).
"""

from __future__ import annotations

import argparse
import datetime
import re
from dataclasses import dataclass, field, fields

from .profiling import default_trace_dir


def default_results_dir() -> str:
    """RESULTS_DIR env contract for telemetry run directories, sibling of
    the TRACE_DIR one (``profiling.default_trace_dir``)."""
    import os
    return os.environ.get("RESULTS_DIR", "./runs")


def build_run_id(label: str | None = None) -> str:
    """``YYYYMMDD-HHMMSS[-label]`` run ids, UTC, sanitized label — twin of
    ``modal_utils.build_run_id`` (``modal_utils.py:98-104``)."""
    ts = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%d-%H%M%S")
    if label:
        label = re.sub(r"[^A-Za-z0-9_.-]+", "-", label).strip("-")
        return f"{ts}-{label}" if label else ts
    return ts


@dataclass
class TrainConfig:
    num_steps: int = 20
    num_epochs: int = 1
    batch_size: int = 32
    sequence_length: int = 8192
    precision: str = "bf16"
    seed: int = 42
    run_name: str | None = None
    trace_dir: str = field(default_factory=default_trace_dir)
    profile: bool = True
    results_dir: str = field(default_factory=default_results_dir)
    telemetry: bool = True
    # live Prometheus scrape endpoint (telemetry.metrics): None = off,
    # 0 = ephemeral port (tests), >0 = fixed port
    metrics_port: int | None = None
    # --- async step pump (runtime/) --------------------------------------
    # dispatch: "async" = bounded in-flight dispatch, losses retired as
    # device arrays, host blocks only at the sync policy points;
    # "sync" = the classic block-every-step loop (the A/B baseline).
    dispatch: str = "async"
    prefetch_depth: int = 2      # DevicePrefetcher staging depth
    sync_every: int = 10         # barrier every N steps (0 = exit only)
    max_in_flight: int = 16      # bounded dispatch window (backpressure)
    bucket_mb: float | None = None  # ddp: all-reduce grads in ~N MB buckets
    # --- overlap engine (ops/collectives.py ring decomposition) ----------
    # overlap: "ring" decomposes the strategy's hot-path collectives into
    # ppermute ring hops the scheduler can hide behind compute — bitwise-
    # identical losses to "none" (fsdp gathers / tp rejoin psums);
    # "ring_fused" (fsdp only) additionally fuses the gather into the
    # projection matmuls (all_gather_matmul — numerically equivalent,
    # not bitwise).
    overlap: str = "none"
    # accum_steps: microbatched gradient accumulation — lax.scan over k
    # splits of the batch with a donated grad carry; per-microbatch
    # collectives pipeline against the next microbatch's compute.
    accum_steps: int = 1
    # quantize_grads: ddp int8 bucketed grad sync (ddp_q8 choreography);
    # error_feedback threads the EF residual so quantization error is
    # re-applied next step instead of compounding.
    quantize_grads: bool = False
    error_feedback: bool = False
    # --- memory planner (memory_plan/) -----------------------------------
    # offload: park optimizer state ("opt") — plus the named remat-saved
    # activations ("opt_act") — in pinned host memory, streamed around
    # the step under a declared transfer contract; hbm_budget_gb is the
    # per-device budget the pre-flight waterline predictor judges
    # against (default: the device's own bytes_limit when exposed);
    # auto_fit lets the planner pick remat × accum × quant × offload to
    # fit the target batch under that budget.
    offload: str = "none"
    auto_fit: bool = False
    hbm_budget_gb: float | None = None
    # --- resilience runtime (resilience/) --------------------------------
    # checkpoint_dir: RunState checkpoints (params + opt + PRNG root +
    # data cursor + loss log) land here; checkpoint_every=N saves async
    # at the pump's next sync point every N steps (0 = final state only).
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    resume: bool = False         # restore the latest step before the loop
    max_restarts: int = 0        # in-process restart budget after a fault
    inject_fault: str | None = None  # debug: "crash@N" / "preempt@N[:leg]"
    # --- elastic mesh runtime (resilience/elastic.py) ---------------------
    # elastic: worker loss (kill_worker fault / heartbeat death / hung
    # step) shrinks the mesh to the survivors and resumes from the
    # latest checkpoint instead of being fatal; world_size builds the
    # mesh over the first N devices (0 = all — the survivor slice after
    # a shrink, or a deliberate small-mesh run); watchdog_timeout wraps
    # the pump's sync points so a hung collective raises a diagnosable
    # StepTimeoutError within the budget; heartbeat_dir is where this
    # worker's liveness file lands (the launcher coordinator's probe —
    # defaults to $DTS_HEARTBEAT_DIR when spawned by dts-launch).
    elastic: bool = False
    world_size: int = 0
    watchdog_timeout: float = 0.0
    heartbeat_dir: str | None = None

    @classmethod
    def from_args(cls, argv=None, **overrides) -> "TrainConfig":
        """CLI args win; ``overrides`` are script-specific *defaults* that
        apply only where the user passed nothing.

        This is the LAST parser in every script's chain, so leftover
        ``--flags`` are typos or abbreviations (abbrev is disabled) —
        silently dropping them would mean training with a different
        config than the user asked for; error instead."""
        ns, rest = build_argparser().parse_known_args(argv)
        unknown = [a for a in rest if a.startswith("--")]
        if unknown:
            raise SystemExit(
                f"unrecognized training flags: {' '.join(unknown)} "
                f"(abbreviations are not accepted; see --help)")
        kwargs = {f.name: getattr(ns, f.name) for f in fields(cls)
                  if hasattr(ns, f.name) and getattr(ns, f.name) is not None}
        for k, v in overrides.items():
            kwargs.setdefault(k, v)
        return cls(**kwargs)


def build_argparser(parser: argparse.ArgumentParser | None = None):
    # allow_abbrev=False: scripts detect explicitly-passed flags by
    # literal string match (e.g. the batch-size divisibility guards);
    # prefix abbreviations would silently bypass those checks.
    p = parser or argparse.ArgumentParser(conflict_handler="resolve",
                                          allow_abbrev=False)
    p.add_argument("--num-steps", dest="num_steps", type=int, default=None)
    p.add_argument("--num-epochs", dest="num_epochs", type=int, default=None)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=None)
    p.add_argument("--sequence-length", dest="sequence_length", type=int,
                   default=None)
    # the reference's choices (no fp8 name: its script has none); the
    # flagship twin parses its own --precision with the fp8 names
    p.add_argument("--precision", dest="precision",
                   choices=["bf16", "fp32", "int8", "int8_pallas",
                            "int8_bwd", "int8_pallas_bwd"],
                   default=None)
    p.add_argument("--seed", dest="seed", type=int, default=None)
    p.add_argument("--run-name", dest="run_name", type=str, default=None)
    p.add_argument("--trace-dir", dest="trace_dir", type=str, default=None)
    p.add_argument("--no-profile", dest="profile", action="store_false",
                   default=None)
    p.add_argument("--results-dir", dest="results_dir", type=str,
                   default=None,
                   help="telemetry run-dir root (default $RESULTS_DIR "
                        "or ./runs)")
    p.add_argument("--no-telemetry", dest="telemetry",
                   action="store_false", default=None,
                   help="disable the manifest/steps.jsonl/summary.json "
                        "run artifacts")
    p.add_argument("--metrics-port", dest="metrics_port", type=int,
                   default=None,
                   help="serve live Prometheus metrics on this port "
                        "while the run is going (0 = ephemeral port; "
                        "also writes periodic metrics.jsonl snapshots)")
    p.add_argument("--dispatch", dest="dispatch",
                   choices=["async", "sync"], default=None,
                   help="step pump mode: bounded async dispatch (default) "
                        "or the classic block-every-step loop")
    p.add_argument("--prefetch-depth", dest="prefetch_depth", type=int,
                   default=None,
                   help="batches staged ahead by the DevicePrefetcher "
                        "(default 2 = double buffering)")
    p.add_argument("--sync-every", dest="sync_every", type=int,
                   default=None,
                   help="async mode: host barrier every N steps "
                        "(0 = only at profile boundaries and loop exit)")
    p.add_argument("--max-in-flight", dest="max_in_flight", type=int,
                   default=None,
                   help="async mode: bound on dispatched steps with "
                        "unretired losses")
    p.add_argument("--bucket-mb", dest="bucket_mb", type=float,
                   default=None,
                   help="ddp: flatten per-dtype gradient leaves into "
                        "~N MB flat buckets before the all-reduce "
                        "(torch-DDP style; default: per-leaf)")
    p.add_argument("--overlap", dest="overlap",
                   choices=["none", "ring", "ring_fused"], default=None,
                   help="overlap engine: ring-decompose the strategy's "
                        "hot collectives (fsdp gathers / tp rejoins) "
                        "into schedulable ppermute hops; 'ring' is "
                        "bitwise-identical to 'none', 'ring_fused' "
                        "(fsdp) fuses the gather into the matmuls")
    p.add_argument("--accum-steps", dest="accum_steps", type=int,
                   default=None,
                   help="microbatched gradient accumulation: scan over "
                        "N microbatches per optimizer step (must divide "
                        "the per-device batch)")
    p.add_argument("--quantize-grads", dest="quantize_grads",
                   action="store_true", default=None,
                   help="ddp: int8 quantized bucketed gradient "
                        "all-reduce (per-bucket scales; ~8x less bus "
                        "traffic, within one half-quantum of exact)")
    p.add_argument("--error-feedback", dest="error_feedback",
                   action="store_true", default=None,
                   help="with --quantize-grads: carry the quantization "
                        "error as a per-rank residual applied to the "
                        "next step's buckets (EF-SGD)")
    p.add_argument("--offload", dest="offload",
                   choices=["none", "opt", "opt_act"], default=None,
                   help="host offload: park optimizer state (opt) — and "
                        "the named remat-saved activations (opt_act) — "
                        "in pinned host memory, streamed around the step "
                        "under a declared transfer contract")
    p.add_argument("--auto-fit", dest="auto_fit", action="store_true",
                   default=None,
                   help="memory planner: search remat × accum × quant × "
                        "offload and run the best predicted-fitting "
                        "config under --hbm-budget-gb")
    p.add_argument("--hbm-budget-gb", dest="hbm_budget_gb", type=float,
                   default=None,
                   help="per-device HBM budget the pre-flight waterline "
                        "prediction is judged against (default: the "
                        "device's reported capacity when exposed)")
    p.add_argument("--checkpoint-dir", dest="checkpoint_dir", type=str,
                   default=None,
                   help="save full RunState (params+opt+PRNG+data cursor) "
                        "checkpoints here; enables --resume")
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=None,
                   help="async RunState save every N steps, written at "
                        "the pump's next sync point (0 = final only)")
    p.add_argument("--resume", dest="resume", action="store_true",
                   default=None,
                   help="resume from the latest step in --checkpoint-dir "
                        "(bitwise-exact: data cursor + PRNG included)")
    p.add_argument("--max-restarts", dest="max_restarts", type=int,
                   default=None,
                   help="in-process restart budget: resume from the "
                        "latest checkpoint after a crash/preemption")
    p.add_argument("--inject-fault", dest="inject_fault", type=str,
                   default=None,
                   help="debug fault injection: crash@N, preempt@N[:leg], "
                        "kill_worker@N:rank, hang@N, or slow@N:ms "
                        "(deterministic, fires once)")
    p.add_argument("--elastic", dest="elastic", action="store_true",
                   default=None,
                   help="elastic mesh: on worker loss / hung step, shrink "
                        "to the survivors (8→4→2), reshard-restore the "
                        "latest checkpoint, and continue (needs "
                        "--checkpoint-dir and --max-restarts)")
    p.add_argument("--world-size", dest="world_size", type=int,
                   default=None,
                   help="build the mesh over the first N visible devices "
                        "(0 = all; the survivor slice of an elastic "
                        "shrink, or a deliberate small-mesh run)")
    p.add_argument("--watchdog-timeout", dest="watchdog_timeout",
                   type=float, default=None,
                   help="collective watchdog: a pump sync point that "
                        "does not retire within N seconds raises "
                        "StepTimeoutError (step index + last contract "
                        "verdict attached) instead of hanging (0 = off)")
    p.add_argument("--heartbeat-dir", dest="heartbeat_dir", type=str,
                   default=None,
                   help="write this worker's per-step liveness file "
                        "here (the launcher coordinator's failure "
                        "detector; default $DTS_HEARTBEAT_DIR)")
    return p
