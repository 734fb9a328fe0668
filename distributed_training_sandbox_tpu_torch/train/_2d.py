"""The driver the two-axis training twins share (``train_tp``,
``train_sp``): the port of the JAX package's ``scripts/_2d_driver.py``.

``train_tp``: data parallel over ``dp`` × Megatron tensor parallelism
over ``tp`` (``parallel.tensor.make_tp_train_step``); ``train_sp``: FSDP
over ``dp`` × ring-attention sequence parallelism over ``sp``
(``parallel.sequence.make_sp_train_step``).  ``--tp`` / ``--sp`` sets
the second axis, dp gets the rest of the ranks (``utils.mesh.grid_axes``
in the reference mesh's order).  Each rank initialises the model from
the seed, keeps its shards and trains them with Adam at the reference
step's defaults, on packed windows of the synthetic stream (global batch
``--batch-size``, default one row a dp rank, rounded to a multiple of dp
as the reference rounds it).  NCCL and the card by default, gloo and the
plain path with ``--device cpu``.  The run harness
(``train.harness``) wraps the leg as it wraps ``train_fsdp``.

It prints the collectives each step issued (the shim), the first step's
verdict of the ``tp`` / ``tp_ring`` / ``tp_q8`` or ``sp`` contract
(``analysis.contracts``: the reference's contract read as calls,
``parallel.contracts.tp_step_collectives``, ``sp_step_collectives``)
and the rules verdict, both in the manifest, and tokens/s and MFU
(``utils.flops``); a profiled run joins its trace to the verdict's
expected calls (``collectives.json``).  ``--overlap`` takes the tp step's rejoins (``none``,
``ring``, ``q8``), or for ``sp`` the FSDP gathers' modes: the
reference's driver takes only its ``TrainConfig``'s ``none``, ``ring``
and ``ring_fused`` and refuses ``--overlap`` for sp, while its steps
take every mode, and the twin follows the steps.  ``--plan`` (a tuner
plan) belongs to the memory planner and is refused by name (ROADMAP.md
A12).
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..analysis.rules import rules_manifest_verdict
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..ops import collectives as C
from ..parallel import fsdp, sequence, tensor
from ..resilience import RunState, generator_states
from ..runtime import DevicePrefetcher
from ..utils import mesh
from ..utils.config import TrainConfig
from ..utils.flops import PEAK_BF16_FLOPS
from ..utils.profiling import ProfileSchedule
from ..utils.tracker import PerformanceTracker
from . import harness as H
from .train_fsdp import fsdp_batches, model_config

MODES = ("tp", "sp")


def _check(mode: str, cfg, second: int, ws: int, seq: int, overlap: str):
    if second < 1 or ws % second:
        raise ValueError(f"--{mode} {second} must be >= 1 and divide the "
                         f"{ws} ranks")
    if mode == "sp" and seq % second:
        raise ValueError(f"--sequence-length {seq} must be divisible by "
                         f"sp={second}")
    if mode == "tp":
        tensor.check_tp_divisibility(cfg, second)
        if overlap not in T.TP_OVERLAPS:
            raise ValueError(f"--overlap {overlap} is not a tp mode "
                             f"{T.TP_OVERLAPS} (ring_fused is an fsdp "
                             f"mode; tp uses --overlap ring)")
    elif overlap not in fsdp.OVERLAP_MODES:
        raise ValueError(f"--overlap {overlap}: choose from "
                         f"{fsdp.OVERLAP_MODES}")


def run(mode: str, model: str = "tiny", *, second: int = 2,
        overlap: str = "none", accum_steps: int = 1,
        batch_size: int | None = None, seq: int | None = None,
        num_steps: int = 20, precision: str = "bf16",
        attention: str | None = None, device=None, seed: int = 42,
        config: TrainConfig | None = None, profile_schedule=None,
        on_step=None, log=print) -> dict:
    """Train ``num_steps`` steps of the ``mode`` twin (``"tp"`` or
    ``"sp"``, ``second`` ranks on that axis) on this rank under the
    supervisor.  Joins (or makes) the process group and leaves it up.
    ``config``: the harness's options (``train.harness.quiet_config``
    when None).  ``attention`` sets the tp step's attention (``"xla"``
    or ``"flash"``); the sp step's is the ring.  Returns the losses, this
    segment's collectives and the contract's, host-clock times a step,
    tokens/s, MFU, the tracker's metrics and peak device memory (None on
    the CPU)."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}; choose from {MODES}")
    dev = mesh.init_process_group(device)
    ws = mesh.axis_size()
    seq = seq or (256 if model == "tiny" else 8192)
    cfg = model_config(model, precision, attention)
    _check(mode, cfg, second, ws, seq, overlap)
    dp = ws // second
    if batch_size is not None and batch_size % dp:
        raise ValueError(f"--batch-size {batch_size} must be divisible by "
                         f"dp={dp}")
    bs = batch_size or dp
    if (bs // dp) % accum_steps:
        raise ValueError(f"--accum-steps {accum_steps} must divide the "
                         f"per-dp-rank batch {bs}/{dp}={bs // dp}")
    rc = H.run_config(config, num_steps=num_steps, seed=seed, batch_size=bs,
                      sequence_length=seq, precision=precision,
                      accum_steps=accum_steps, overlap=overlap)
    return H.supervise(rc, f"train_{mode}", lambda ctx, holder: _leg(
        ctx, holder, rc, mode, model, cfg, second=second, device=dev,
        profile_schedule=profile_schedule, on_step=on_step, log=log),
        extra_fingerprint={"model": model, mode: second})


def _leg(ctx, holder, rc, mode, model, cfg, *, second, device,
         profile_schedule, on_step, log) -> dict:
    name = f"train_{mode}"
    num_steps, seed, overlap = rc.num_steps, rc.seed, rc.overlap
    bs, seq, accum = rc.batch_size, rc.sequence_length, rc.accum_steps
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    dp = ws // second
    axes = mesh.grid_axes(("dp", mode), (dp, second))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen, dev)
    if mode == "sp":
        shards = fsdp.shard_params_fsdp(params, axes["dp"])
        step = sequence.make_sp_train_step(
            shards, cfg, dp_axis=axes["dp"], sp_axis=axes["sp"],
            overlap=overlap, accum_steps=accum)
        cname = "sp"
    else:
        shards = tensor.shard_params_tp(params, axes["tp"])
        step = tensor.make_tp_train_step(
            shards, cfg, dp_axis=axes["dp"], tp_axis=axes["tp"],
            overlap=overlap, accum_steps=accum)
        cname = f"tp_{overlap}" if overlap != "none" else "tp"
    sizes = {"dp": dp, mode: second}
    rules = rules_manifest_verdict(cname, params=shards, full=params,
                                   axis_sizes=sizes)
    del params
    verdict = H.Verdict(cname, params=shards, axes=sizes,
                        n_layers=cfg.num_hidden_layers, label=name,
                        rank=rank, log=log, remat=cfg.remat,
                        accum_steps=accum, overlap=overlap)
    opt = fsdp.init_fsdp_opt_state(shards)
    key = generator_states({"params": seed}, dev)
    H.track(holder, ctx)
    rs = ctx.restore(RunState(params=shards, opt_state=opt, prng_key=key))
    if rs is not None:
        shards, opt = rs.params, rs.opt_state
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if rank == 0:
        log(f"[{name}] model={model} ({cfg.param_count() / 1e9:.3f}B) "
            f"mesh={{'dp': {dp}, '{mode}': {second}}} batch={bs} seq={seq} "
            f"overlap={overlap} accum_steps={accum} "
            f"precision={cfg.matmul_precision} "
            f"attention={'ring' if mode == 'sp' else cfg.attention_impl} "
            f"dispatch={rc.dispatch} device={dev}")
        log(f"[{name}] rules[{cname}]: "
            f"{'ok' if rules['ok'] else 'MISMATCH'} ({rules['checked']} "
            f"leaves checked)")
    flops_tok = T.model_flops_per_token(cfg, seq)
    tracker = PerformanceTracker(
        warmup_steps=min(3, max(num_steps - 1, 0)),
        flops_per_token=flops_tok, num_devices=ws, device=dev)
    prof = H.profiler(rc, profile_schedule, ProfileSchedule(
        skip_first=0, wait=1, warmup=2, active=5))
    batches = fsdp_batches(cfg.vocab_size, seq, bs, num_steps, seed)
    if ctx.data_cursor:
        batches = itertools.islice(batches, ctx.data_cursor, None)
    counts, times = [], []

    def logger(i):
        def cb(lf):
            if rank == 0 and (i % 5 == 0 or i == num_steps - 1):
                log(f"[{name}] step {i:3d} loss {lf:.4f} collectives "
                    f"{json.dumps(C.COLLECTIVES.nonzero(counts[i - ctx.start_step]))}")
            if on_step is not None:
                on_step(i, lf)
        return cb

    pref = DevicePrefetcher(batches, device=dev, depth=rc.prefetch_depth)
    t0 = time.perf_counter()
    with pref, H.telemetry(name, rc, ctx, dev, model=model, profiler=prof,
                           rules=rules, extra={mode: second, "overlap": overlap}
                           ) as telem:
        H.wire(telem, ctx, pref)
        with H.pump(rc, telem, tracker, ctx) as pump:
            for i, batch in zip(range(ctx.start_step, num_steps), pref):
                if ctx.should_stop(i):
                    break
                verdict.begin()
                shards, opt, loss = step(shards, opt, batch)
                counts.append(verdict.end(telem, ctx))
                synced = pump.emit(loss, tokens=bs * seq, log=logger(i))
                times.append(time.perf_counter() - t0)
                ctx.after_step(i, synced, lambda i=i: RunState(
                    params=shards, opt_state=opt, step=i, data_cursor=i + 1,
                    prng_key=key, loss_log=ctx.full_losses(pump.losses)))
        wall = time.perf_counter() - t0
        holder["losses"] = losses = ctx.full_losses(pump.losses)
        ctx.finalize(telem)
    # tokens/s over the steps after the first two, as run_leg counts
    n_timed, dt = ((len(times) - 2, times[-1] - times[1]) if len(times) > 2
                   else (len(times), times[-1] if times else 0.0))
    tok_s = n_timed * bs * seq / dt if dt > 0 else 0.0
    mfu = flops_tok * tok_s / (ws * PEAK_BF16_FLOPS)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if rank == 0:
        log(f"[{name}] collectives a step "
            f"{json.dumps(C.COLLECTIVES.nonzero(counts[-1] if counts else {}))}"
            f", the contract holds {verdict.holds}")
        log(f"[{name}] tokens/s {tok_s:.1f} (global, host clock), MFU "
            f"{mfu:.4f} ({flops_tok:.4e} model FLOP/token over {ws} x 989 "
            f"TFLOP/s bf16), peak memory "
            + (f"{peak / 2 ** 30:.2f} GiB a rank" if peak is not None
               else "not measured (CPU)")
            + f"; host syncs {pump.host_sync_count} {pump.sync_breakdown}")
        if telem.run_dir:
            log(f"[{name}] telemetry in {telem.run_dir}")
    return {"mode": mode, "model": model, "world_size": ws, "dp": dp,
            mode: second, "overlap": overlap, "accum_steps": accum,
            "batch_size": bs, "sequence_length": seq,
            "precision": rc.precision, "attention": cfg.attention_impl,
            "status": "completed", "start_step": ctx.start_step,
            "device": str(dev), "losses": losses, "collectives": counts,
            **verdict.result(), "rules": rules, "step_times_s": times, "wall_s": wall,
            "tokens_per_second": tok_s, "mfu": mfu,
            "tracker": pump.metrics, "host_syncs": dict(pump.sync_breakdown),
            "peak_memory_bytes": peak, "run_dir": telem.run_dir,
            "profiler": prof, **H.ckpt_report(holder),
            "model_flops_per_token": flops_tok}


def main(mode: str, argv=None) -> None:
    p = argparse.ArgumentParser(
        description=f"train_{mode}: the two-axis twin", allow_abbrev=False)
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY), default="tiny")
    p.add_argument(f"--{mode}", type=int, default=2, dest="second",
                   help=f"size of the {mode} mesh axis (dp gets the rest)")
    # the reference's TrainConfig takes none / ring / ring_fused; the tp
    # step's q8 rejoin and the fsdp step's ring_fused_pallas have no
    # other flag, so the twin takes the step's own modes
    p.add_argument("--overlap", default="none",
                   choices=T.TP_OVERLAPS if mode == "tp"
                   else fsdp.OVERLAP_MODES,
                   help="tp: the rejoins; sp: the FSDP gathers")
    p.add_argument("--attention", choices=["xla", "flash"], default=None,
                   help="the tp step's attention (sp runs the ring)")
    p.add_argument("--plan", default=None, metavar="PLAN_JSON",
                   help="a tuner plan: refused, the memory planner is not "
                        "ported (ROADMAP.md A12)")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo and "
                        "the plain path")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args, rest = p.parse_known_args(argv)
    if args.plan:
        raise SystemExit("--plan replays a tuner plan: the tuner and the "
                         "memory planner are not ported yet — see "
                         "ROADMAP.md queue A item A12")
    batch_given = "--batch-size" in rest
    seq_given = "--sequence-length" in rest
    cfg = TrainConfig.from_args(rest)
    try:
        res = run(mode, args.model, second=args.second,
                  overlap=args.overlap, accum_steps=cfg.accum_steps,
                  batch_size=cfg.batch_size if batch_given else None,
                  seq=cfg.sequence_length if seq_given else None,
                  num_steps=cfg.num_steps, precision=cfg.precision,
                  attention=args.attention, device=args.device,
                  seed=cfg.seed, config=cfg)
        if args.out and mesh.axis_rank() == 0:
            Path(args.out).write_text(json.dumps(res, default=str))
        if mesh.axis_rank() == 0 and not all(np.isfinite(res["losses"])):
            raise SystemExit(f"non-finite loss in {res['losses']}")
    finally:
        mesh.destroy_process_group()
