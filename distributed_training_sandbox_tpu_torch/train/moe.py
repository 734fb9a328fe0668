"""MoE-transformer training over dp × ep: the twin of the JAX package's
``scripts/train_moe.py``.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.moe \\
        --model smollm3-3b-l8 --ep 4 --experts 8 --precision bf16
    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.moe \\
        --device cpu --model tiny --ep 2 --num-steps 4

Every layer's MLP is a switch MoE of ``--experts`` experts of width
``--moe-ffn`` (default: the model's intermediate size / 4, the
flagship's geometry), ``--top-k`` of them a token, at capacity factor
``--capacity-factor``; ``--z-weight`` is the router z-loss weight and
``--router-lr-mult`` the router's learning-rate multiplier.  The ranks
form a dp × ep mesh (``utils.mesh.dp_ep_axes``, ``--ep`` of them an
expert group, dp the rest); each rank initialises the model from the
seed, keeps its ``E / ep`` slice of every expert bank and trains with
``parallel.expert.make_moe_lm_train_step`` (Adam at the reference
step's defaults) on packed windows of the synthetic stream, global
batch ``--batch-size`` (default: one row a rank), each rank routing its
rows of it.  ``--precision``: an int8 name sets the projections' and
the experts' products (K5 and K4 on the card), ``fp32`` the dtype;
others train at bf16, as the reference script reads the flag.  NCCL and
the card by default, gloo with ``--device cpu``.

It runs under the run harness (``train.harness``) as ``train_fsdp``
does: the supervisor (``--checkpoint-dir``, ``--checkpoint-every``,
``--resume``, ``--max-restarts``, ``--inject-fault``), RunState
checkpoints of this rank's params (its expert slice) and Adam state,
the telemetry run, the profiler, the device prefetcher and the step
pump.  It prints the losses, the collectives each step issued (the shim)
beside ``parallel.contracts.moe_step_collectives``, tokens/s and
peak memory.

Not ported (ROADMAP.md): the collective-contract and sharding-rules
verdicts over compiled text (A12).  The reference's script has no flag
for the dp × sp × ep step; it runs through the library
(``parallel.expert.make_moe_lm_train_step(sp_axis=...)``,
``train.layouts --layout dp_sp_ep``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..ops import collectives as C
from ..parallel import expert, optim
from ..parallel.contracts import moe_step_collectives
from ..resilience import RunState, generator_states
from ..runtime import DevicePrefetcher
from ..utils import mesh
from ..utils.config import TrainConfig
from ..utils.profiling import ProfileSchedule
from ..utils.tracker import PerformanceTracker
from . import harness as H
from .train_fsdp import fsdp_batches


def model_config(model: str, *, experts: int = 8, moe_ffn: int = 0,
                 top_k: int = 1, capacity_factor: float = 2.0,
                 z_weight: float = 0.0, router_lr_mult: float = 1.0,
                 precision: str = "bf16") -> T.TransformerConfig:
    """The run's MoE config: ``model``'s geometry with its MLP split into
    ``experts`` experts, as the reference script builds it."""
    base = getattr(T, MODEL_REGISTRY[model])
    cfg = dataclasses.replace(
        base, n_experts=experts,
        moe_ffn=moe_ffn or max(base.intermediate_size // 4, 8),
        moe_top_k=top_k, moe_capacity_factor=capacity_factor,
        moe_router_z_weight=z_weight, moe_router_lr_mult=router_lr_mult)
    if precision.startswith("int8"):
        cfg = dataclasses.replace(cfg, matmul_precision=precision)
    elif precision == "fp32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return cfg


def run(model: str = "tiny", *, ep: int | None = None, experts: int = 8,
        moe_ffn: int = 0, top_k: int = 1, capacity_factor: float = 2.0,
        z_weight: float = 0.0, router_lr_mult: float = 1.0,
        batch_size: int | None = None, seq: int | None = None,
        num_steps: int = 20, precision: str = "bf16", device=None,
        seed: int = 42,
        config: TrainConfig | None = None, profile_schedule=None,
        on_step=None, log=print) -> dict:
    """Train ``num_steps`` dp × ep MoE steps on this rank under the
    supervisor.  Joins (or makes) the process group and leaves it up;
    ``ep`` (default: every rank) ranks form an expert group.
    ``config``: the harness's options (``train.harness.quiet_config``
    when None).  ``on_step(i, loss)`` is called once each step's loss
    has reached the host.  Returns the losses (stitched across
    restarts), ``status``, this segment's collective counts and the
    contract's, host-clock times a step, tokens/s, the tracker's
    metrics, peak device memory (None on the CPU), the checkpoint saves
    and the restore's seconds."""
    dev = mesh.init_process_group(device)
    ws = mesh.axis_size()
    ep = ep or ws
    if ep < 1 or ws % ep:
        raise ValueError(f"--ep {ep} must be >= 1 and divide the {ws} "
                         f"ranks")
    if experts % ep:
        raise ValueError(f"--experts {experts} must be divisible by "
                         f"ep={ep}")
    seq = seq or (256 if model == "tiny" else 8192)
    bs = batch_size or ws
    if bs % ws:
        raise ValueError(f"batch size {bs} must be divisible by the "
                         f"{ws} ranks")
    cfg = model_config(model, experts=experts, moe_ffn=moe_ffn, top_k=top_k,
                       capacity_factor=capacity_factor, z_weight=z_weight,
                       router_lr_mult=router_lr_mult, precision=precision)
    cfg_run = H.run_config(config, num_steps=num_steps, seed=seed,
                           batch_size=bs, sequence_length=seq,
                           precision=precision)
    fp = {"model": model, "ep": ep, "experts": experts}
    return H.supervise(cfg_run, "moe", lambda ctx, holder: _run(
        ctx, holder, cfg_run, model, cfg, ep=ep, device=dev,
        profile_schedule=profile_schedule, on_step=on_step, log=log),
        extra_fingerprint=fp)


def _run(ctx, holder, rc, model, cfg, *, ep, device, profile_schedule,
         on_step, log) -> dict:
    num_steps, seed = rc.num_steps, rc.seed
    bs, seq = rc.batch_size, rc.sequence_length
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    dp_ax, ep_ax = mesh.dp_ep_axes(ws // ep, ep)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen, dev)
    shards = expert.shard_moe_lm_params(params, ep_ax)
    del params
    opt = optim.adam_init(shards)
    key = generator_states({"params": seed}, dev)
    H.track(holder, ctx)
    rs = ctx.restore(RunState(params=shards, opt_state=opt, prng_key=key))
    if rs is not None:
        shards, opt = rs.params, rs.opt_state
    step = expert.make_moe_lm_train_step(shards, cfg, dp_axis=dp_ax,
                                         ep_axis=ep_ax)
    contract = moe_step_collectives(shards, remat=cfg.remat,
                                    z_loss=bool(cfg.moe_router_z_weight))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if rank == 0:
        log(f"[moe] model={model} experts={cfg.n_experts} "
            f"moe_ffn={cfg.moe_ffn} top_k={cfg.moe_top_k} "
            f"({cfg.param_count() / 1e9:.3f}B total) dp={ws // ep} ep={ep} "
            f"batch={bs} seq={seq} precision={cfg.matmul_precision} "
            f"attention={cfg.attention_impl} dispatch={rc.dispatch} "
            f"device={dev}")
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
            if rank == 0:
                log(f"[moe] step {i:3d} loss {lf:.4f} collectives "
                    f"{json.dumps(C.COLLECTIVES.nonzero(counts[i - ctx.start_step]))}")
            if on_step is not None:
                on_step(i, lf)
        return cb

    pref = DevicePrefetcher(batches, device=dev, depth=rc.prefetch_depth)
    t0 = time.perf_counter()
    with pref, H.telemetry("moe", rc, ctx, dev, model=model, profiler=prof,
                           extra={"experts": cfg.n_experts, "ep": ep,
                                  "top_k": cfg.moe_top_k}) as telem:
        H.wire(telem, ctx, pref)
        with H.pump(rc, telem, tracker, ctx) as pump:
            for i, batch in zip(range(ctx.start_step, num_steps), pref):
                if ctx.should_stop(i):
                    break
                C.COLLECTIVES.reset()
                shards, opt, loss = step(shards, opt, batch)
                counts.append(C.COLLECTIVES.read())
                synced = pump.emit(loss, tokens=bs * seq, log=logger(i))
                times.append(time.perf_counter() - t0)
                ctx.after_step(i, synced, lambda i=i: RunState(
                    params=shards, opt_state=opt, step=i, data_cursor=i + 1,
                    prng_key=key, loss_log=ctx.full_losses(pump.losses)))
        wall = time.perf_counter() - t0
        holder["losses"] = losses = ctx.full_losses(pump.losses)
        ctx.finalize(telem)
    n_timed, dt = ((len(times) - 2, times[-1] - times[1]) if len(times) > 2
                   else (len(times), times[-1] if times else 0.0))
    tok_s = n_timed * bs * seq / dt if dt > 0 else 0.0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if rank == 0:
        log(f"[moe] collectives a step {json.dumps(C.COLLECTIVES.nonzero(counts[-1] if counts else {}))}"
            f", the moe contract's {json.dumps(C.COLLECTIVES.nonzero(contract))}"
            f" (equal {all(c == contract for c in counts)})")
        log(f"[moe] tokens/s {tok_s:.1f} (global, host clock) peak memory "
            + (f"{peak / 2 ** 30:.2f} GiB a rank" if peak is not None
               else "not measured (CPU)")
            + f"; host syncs {pump.host_sync_count} {pump.sync_breakdown}")
        if telem.run_dir:
            log(f"[moe] telemetry in {telem.run_dir}")
    return {"model": model, "world_size": ws, "ep": ep, "dp": ws // ep,
            "experts": cfg.n_experts, "moe_ffn": cfg.moe_ffn,
            "top_k": cfg.moe_top_k, "batch_size": bs,
            "sequence_length": seq, "precision": rc.precision,
            "status": "completed", "start_step": ctx.start_step,
            "device": str(dev), "losses": losses, "collectives": counts,
            "contract": contract,
            "step_times_s": times, "wall_s": wall,
            "tokens_per_second": tok_s, "tracker": pump.metrics,
            "host_syncs": dict(pump.sync_breakdown),
            "peak_memory_bytes": peak, "run_dir": telem.run_dir,
            "profiler": prof, **H.ckpt_report(holder),
            "model_flops_per_token": flops_tok}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY), default="tiny")
    p.add_argument("--ep", type=int, default=2,
                   help="ranks of an expert group (dp gets the rest)")
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--moe-ffn", type=int, default=0,
                   help="per-expert ffn width (default intermediate/4)")
    p.add_argument("--top-k", type=int, default=1,
                   help="experts per token (1 = Switch, 2 = GShard top-2 "
                        "with normalised gates)")
    p.add_argument("--capacity-factor", type=float, default=2.0)
    p.add_argument("--z-weight", type=float, default=0.0,
                   help="router z-loss weight (ST-MoE)")
    p.add_argument("--router-lr-mult", type=float, default=1.0,
                   help="LR multiplier on w_router leaves")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo and "
                        "the plain path")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args, rest = p.parse_known_args(argv)
    batch_given = "--batch-size" in rest
    seq_given = "--sequence-length" in rest
    cfg = TrainConfig.from_args(rest)
    try:
        res = run(args.model, ep=args.ep, experts=args.experts,
                  moe_ffn=args.moe_ffn, top_k=args.top_k,
                  capacity_factor=args.capacity_factor,
                  z_weight=args.z_weight,
                  router_lr_mult=args.router_lr_mult,
                  batch_size=cfg.batch_size if batch_given else None,
                  seq=cfg.sequence_length if seq_given else None,
                  num_steps=cfg.num_steps, precision=cfg.precision,
                  device=args.device, seed=cfg.seed, config=cfg)
        if args.out and mesh.axis_rank() == 0:
            Path(args.out).write_text(json.dumps(res, default=str))
        if mesh.axis_rank() == 0 and not all(np.isfinite(res["losses"])):
            raise SystemExit(f"non-finite loss in {res['losses']}")
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
