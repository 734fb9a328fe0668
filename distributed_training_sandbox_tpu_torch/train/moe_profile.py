"""Phase breakdown of the MoE transformer's train step from a profiler
trace: the twin of the JAX package's ``scripts/moe_profile.py``.

    python -m distributed_training_sandbox_tpu_torch.train.moe_profile
    python -m distributed_training_sandbox_tpu_torch.train.moe_profile \\
        --device cpu --model tiny --seq 64 --batch 2 --steps 1

Builds the MoE geometry (8 experts × ``moe_ffn`` 2752 over
SmolLM3-3B-L8's width, ``--capacity-factor``, ``--dispatch``; ``--dense``
profiles the dense model for the comparison step time), runs the FSDP
step at one rank twice to warm it, then ``--steps`` steps under
``utils.profiling.Profiler``.  ``utils.trace_analysis.phase_split``
reads the trace: device µs by the reference's phases (``PHASES``, the
``record_function`` ranges ``parallel.expert.moe_mlp`` opens; a backward
op by its forward op's range) and ``"other"`` (attention, the dense
projections, the loss, the optimizer).  Without a card the trace holds
no device activity and the host's op times are read instead.  Appends
the reference's row to ``moe_results/moe_phase_breakdown_<platform>.json``
(``gpu`` or ``cpu``) and prints its table.  ``--model tiny`` scales the
experts to TINY_LM (8 of width 40).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..parallel import fsdp
from ..utils import mesh
from ..utils.profiling import Profiler, ProfileSchedule
from ..utils.trace_analysis import load_trace_events, phase_split
from .bench_row import registry_name
from .busbench import card_line

PHASES = ["moe_route", "moe_dispatch", "moe_expert_mlp", "moe_a2a_out",
          "moe_a2a_back", "moe_combine", "moe_aux_loss"]
WARMUP = 2


def run(model: str = "SMOLLM3_3B_L8", *, seq: int = 8192, batch: int = 4,
        steps: int = 4, capacity_factor: float = 2.0,
        dispatch: str = "grouped", dense: bool = False,
        layers: int | None = None, device=None, trace_dir=None) -> dict:
    """Profile ``steps`` steps; returns the reference's row plus the
    trace's path, the card line and each phase's µs.  ``layers`` cuts
    the depth."""
    dev = mesh.init_process_group(device)
    name = registry_name(model)
    cfg = getattr(T, MODEL_REGISTRY[name])
    ffn = 40 if name == "tiny" else T.SMOLLM3_3B_L8_MOE.moe_ffn
    over = {} if dense else {"n_experts": 8, "moe_ffn": ffn,
                             "moe_capacity_factor": capacity_factor,
                             "moe_dispatch": dispatch}
    if layers:
        over["num_hidden_layers"] = layers
    cfg = dataclasses.replace(cfg, **over)
    gen = torch.Generator(device=dev).manual_seed(0)
    shards = fsdp.shard_params_fsdp(T.init_params(cfg, gen, dev))
    opt = fsdp.init_fsdp_opt_state(shards)
    step = fsdp.make_fsdp_train_step(shards, cfg, reshard_after_forward=True)
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       size=(batch, seq)), device=dev)
    batch_t = (ids, ids)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="moe_prof_")
    # the window: the steps after the warm-up ones
    prof = Profiler(trace_dir, ProfileSchedule(skip_first=WARMUP, wait=0,
                                               warmup=0, active=steps),
                    enabled=True)
    for _ in range(WARMUP):
        shards, opt, loss = step(shards, opt, batch_t)
        float(loss)
        prof.step()
    t0 = time.perf_counter()
    for _ in range(steps):
        shards, opt, loss = step(shards, opt, batch_t)
        prof.step()
    float(loss)
    dt = (time.perf_counter() - t0) / steps
    prof.stop()
    trace = prof.trace_files[-1]
    agg = phase_split(load_trace_events(trace), PHASES)
    del shards, opt, step
    per_step = {k: v / steps / 1e3 for k, v in agg.items()}   # ms
    platform = "gpu" if dev.type == "cuda" else dev.type
    return {"model": model, "seq_len": seq, "batch": batch,
            "platform": platform, "capacity_factor": capacity_factor,
            "dispatch": "dense" if dense else dispatch,
            "step_ms": round(dt * 1e3, 1),
            "tokens_per_sec": round(batch * seq / dt, 1),
            "phase_ms_per_step": {k: round(v, 2)
                                  for k, v in per_step.items()},
            "phase_us": agg, "steps": steps, "trace_file": trace,
            "card": card_line() if dev.type == "cuda" else None}


def report(row: dict) -> str:
    agg = row["phase_us"]
    total = sum(agg.values()) or 1.0
    per = row["phase_ms_per_step"]
    lines = [f"step time: {row['step_ms']:.1f} ms   tok/s "
             f"{row['tokens_per_sec']:,.0f}"]
    for k in PHASES + ["other"]:
        if k in per:
            lines.append(f"  {k:16s} {per[k]:8.2f} ms/step  "
                         f"{100 * agg[k] / total:5.1f}%")
    moe_ms = sum(v for k, v in per.items() if k != "other")
    lines.append(f"  {'moe total':16s} {moe_ms:8.2f} ms/step")
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="SMOLLM3_3B_L8")
    p.add_argument("--seq", type=int, default=8192)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--capacity-factor", type=float, default=2.0)
    p.add_argument("--dispatch", default="grouped",
                   help="grouped (the default) | sort | einsum")
    p.add_argument("--dense", action="store_true",
                   help="profile the dense model instead (its phases are "
                        "all 'other'; gives the comparison step time)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth (default the model's)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain path)")
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--out-dir", default="moe_results")
    args = p.parse_args(argv)
    resolve_device(args.device)
    joined = mesh.initialized()
    try:
        row = run(args.model, seq=args.seq, batch=args.batch,
                  steps=args.steps, capacity_factor=args.capacity_factor,
                  dispatch=args.dispatch, dense=args.dense,
                  layers=args.layers, device=args.device,
                  trace_dir=args.trace_dir)
    finally:
        if not joined:   # a group the caller made stays up
            mesh.destroy_process_group()
    print(report(row), flush=True)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"moe_phase_breakdown_{row['platform']}.json"
    rows = json.loads(path.read_text()) if path.exists() else []
    rows.append({k: v for k, v in row.items() if k != "phase_us"})
    path.write_text(json.dumps(rows, indent=1))
    print(f"wrote {path}", flush=True)
    return row


if __name__ == "__main__":
    main()
