"""The composable N-D mesh twin: one script for every ``MeshPlan``; the
twin of the JAX package's ``scripts/train_composable.py``.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.train_composable \\
        --device cpu --mesh fsdp2xtp2 --model tiny --num-steps 4
    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.train_composable \\
        --device cpu --mesh dp2xw1 --scale 200
    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.train_composable \\
        --mesh fsdp2xtp2 --model smollm3-3b-l8 --attention flash

``--mesh`` names the run: ``dp8`` (DDP), ``dp8xw1`` (ZeRO-1),
``dp8xw3`` (ZeRO-3), ``dp8xw3named`` / ``fsdp8`` (FSDP), ``dp4xtp2``
(Megatron TP), ``dp4xsp2`` (ring-attention SP), ``dp2xfsdp2xtp2`` (the
3-axis step); ``parallel.composable.make_composable_train_step``
resolves it, so a replayed legacy plan is its hand step.  Two model
families, as in the reference: the W plans (ddp, zero1, zero2, zero3)
train the ZeRO toy MLP at width 10 000 / ``--scale`` on one fixed randn
batch, as ``train.zero``'s sharded leg does (Adam at its defaults,
``--rebuild`` for zero1 / zero2); the transformer plans train the
packed-LM loop of ``train/_2d.py`` (global batch one row a data rank by
default, rounded to the plan's data ways).  NCCL and the card by
default, gloo and the plain path with ``--device cpu``.

The run harness (``train.harness``) wraps it: supervisor, checkpoints,
telemetry, profiler, pump.  The manifest carries the generated contract
(``analysis.contract_gen``: the calls a step) and the rules verdict
(``analysis.rules.rules_manifest_verdict``: rule hygiene and each live
shard's tiles against its rule spec); every step's shim counts are
held to the contract, and the run fails if one differs or the verdict
is not ok.  A resume under the same plan continues bit for bit; under
another plan (or world size) it is resharding, and ``--plan`` replays a
tuner plan: both are refused, naming ROADMAP.md queue A item A12.
``--overlap``: the fsdp plans' gathers (``parallel.fsdp``'s modes) or
the tp and 3-axis plans' rejoins (``none``, ``ring``; tp also ``q8``).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from ..analysis import rules as R
from ..analysis.contract_gen import Ctx, generate_counts
from ..models import MODEL_REGISTRY
from ..models import mlp
from ..models import transformer as T
from ..ops import collectives as C
from ..parallel import fsdp, optim
from ..parallel.composable import (MeshPlan, grid_names, make_composable_train_step,
                                   plan_grid)
from ..resilience import RunState, generator_states
from ..runtime import DevicePrefetcher
from ..utils import mesh
from ..utils.config import TrainConfig
from ..utils.flops import PEAK_BF16_FLOPS
from ..utils.profiling import ProfileSchedule
from ..utils.tracker import PerformanceTracker
from . import harness as H
from .train_fsdp import fsdp_batches, model_config
from .zero import toy_problem

MLP_STRATEGIES = ("ddp", "composable_zero1", "zero2", "zero3")
A12 = "ROADMAP.md queue A item A12"


def contract_name(strategy: str, overlap: str) -> str:
    """The RuleSet / contract a strategy runs as under ``overlap``
    (``fsdp_ring``, ``tp_q8``, ...); the 3-axis step's rules and
    contract take the rejoin as a knob."""
    name = f"{strategy}_{overlap}"
    return name if overlap != "none" and name in R.RULESETS else strategy


def _check_overlap(strategy: str, overlap: str) -> None:
    allowed = {"fsdp": fsdp.OVERLAP_MODES, "tp": T.TP_OVERLAPS,
               "composable_dp_fsdp_tp": ("none", "ring")}.get(strategy,
                                                            ("none",))
    if overlap not in allowed:
        raise ValueError(f"--overlap {overlap}: the {strategy} plan takes "
                         f"{allowed}")


def run(mesh_plan: str, model: str = "tiny", *, scale: int = 20,
        rebuild: str = "broadcast", overlap: str = "none",
        accum_steps: int = 1, batch_size: int | None = None,
        seq: int | None = None, num_steps: int = 20,
        precision: str = "bf16", attention: str | None = None,
        device=None, seed: int = 42, keep_params: bool = False,
        config: TrainConfig | None = None, profile_schedule=None,
        on_step=None, log=print) -> dict:
    """Train ``num_steps`` steps of ``mesh_plan`` on this rank under the
    supervisor.  Joins (or makes) the process group and leaves it up.
    Returns the losses, each step's collectives, the contract and the
    rules verdict, host-clock times, tokens/s, MFU and peak memory (the
    transformer plans), optimizer MB (the MLP plans); with
    ``keep_params`` this rank's final params (or shards) too."""
    dev = mesh.init_process_group(device)
    ws = mesh.axis_size()
    plan = MeshPlan.parse(mesh_plan).normalized()
    strategy = plan.strategy_name()
    _check_overlap(strategy, overlap)
    is_mlp = strategy in MLP_STRATEGIES
    if is_mlp:
        plan.validate(n_devices=ws)
        bs = batch_size or 16
    else:
        seq = seq or (256 if model == "tiny" else 8192)
        plan.validate(n_devices=ws, model_cfg=model_config(model, precision,
                                                           attention),
                      seq_len=seq)
        bs = batch_size or plan.data_ways
    if bs % plan.data_ways:
        raise ValueError(f"--batch-size {bs} must be divisible by the "
                         f"plan's data ways (dp×fsdp={plan.data_ways})")
    if (bs // plan.data_ways) % accum_steps:
        raise ValueError(f"--accum-steps {accum_steps} must divide the "
                         f"per-data-rank batch {bs // plan.data_ways}")
    fields = dict(num_steps=num_steps, seed=seed, batch_size=bs,
                  precision=precision, accum_steps=accum_steps)
    if not is_mlp:
        fields["sequence_length"] = seq
    rc = H.run_config(config, **fields)
    fp = ({"scale": scale, "rebuild": rebuild} if is_mlp
          else {"model": model, "overlap": overlap})
    fp["mesh_plan"] = plan.describe()
    leg = _mlp_leg if is_mlp else _lm_leg
    res = H.supervise(rc, "composable", lambda ctx, holder: leg(
        ctx, holder, rc, plan, strategy, model=model, scale=scale,
        rebuild=rebuild, overlap=overlap, attention=attention, device=dev,
        profile_schedule=profile_schedule, on_step=on_step, log=log),
        extra_fingerprint=fp,
        refusals={"mesh_plan": f"restoring under another plan is "
                               f"resharding, not ported yet (see {A12})"})
    state = res.pop("params", None)
    if keep_params:
        res["params"] = state
    return res


def _verdicts(strategy, overlap, state, full, axes, remat, kw):
    cname = contract_name(strategy, overlap)
    sizes = {a: mesh.axis_size(axes[a]) for a in axes if "_" not in a}
    contract = generate_counts(cname, state, Ctx(sizes, remat=remat, **kw))
    rules = R.rules_manifest_verdict(cname, params=state, full=full,
                                     axis_sizes=sizes)
    return cname, contract, rules


def _loop(ctx, rc, telem_args, step, state, opt, batches, *, name, tokens,
          contract, rank, on_step, log, key=None, tracker=None):
    """The steps under the pump; each step's shim counts."""
    counts, times = [], []
    t0 = time.perf_counter()
    pref = DevicePrefetcher(batches, device=telem_args["dev"],
                            depth=rc.prefetch_depth) \
        if telem_args["prefetch"] else None
    with pref or contextlib.nullcontext(), H.telemetry(
            "composable", rc, ctx, telem_args["dev"],
            model=telem_args["model"], profiler=telem_args["profiler"],
            extra=telem_args["extra"], contract=telem_args["contract"],
            rules=telem_args["rules"]) as telem:
        H.wire(telem, ctx, pref)
        with H.pump(rc, telem, tracker, ctx) as pump:
            for i, batch in zip(range(ctx.start_step, rc.num_steps),
                                pref or batches):
                if ctx.should_stop(i):
                    break
                C.COLLECTIVES.reset()
                state, opt, loss = step(state, opt, batch)
                counts.append(C.COLLECTIVES.read())

                def cb(lf, i=i):
                    if rank == 0 and (i % 5 == 0 or i == rc.num_steps - 1):
                        log(f"[{name}] step {i:3d} loss {lf:.4f}")
                    if on_step is not None:
                        on_step(i, lf)
                synced = pump.emit(loss, tokens=tokens, log=cb)
                times.append(time.perf_counter() - t0)
                ctx.after_step(i, synced, lambda i=i: RunState(
                    params=state, opt_state=opt, step=i,
                    data_cursor=i + 1, prng_key=key,
                    loss_log=ctx.full_losses(pump.losses)))
        wall = time.perf_counter() - t0
        losses = ctx.full_losses(pump.losses)
        ctx.finalize(telem)
    ok = all(c == contract for c in counts)
    if rank == 0:
        log(f"[{name}] collectives a step "
            f"{json.dumps(C.COLLECTIVES.nonzero(counts[-1] if counts else {}))}"
            f", the generated contract's "
            f"{json.dumps(C.COLLECTIVES.nonzero(contract))} (equal {ok})")
    return state, opt, losses, counts, times, wall, pump, telem, ok


def _mlp_leg(ctx, holder, rc, plan, strategy, *, scale, rebuild, overlap,
             device, profile_schedule, on_step, log, **_) -> dict:
    """The toy MLP, as ``train.zero``'s sharded leg: the same seeded
    params and batch, Adam at the hand step's defaults."""
    name = "composable"
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    init_params, batch = toy_problem(scale, rc.batch_size, rc.seed, dev)
    params = init_params()
    axes = plan_grid(plan)
    build = make_composable_train_step(
        params, plan, axes=axes,
        loss_fn=None if strategy == "zero3" else mlp.mse_loss,
        rebuild=rebuild)
    state, opt = build.params, build.opt_state
    H.track(holder, ctx)
    rs = ctx.restore(RunState(params=state, opt_state=opt))
    if rs is not None:
        state, opt = rs.params, rs.opt_state
    cname, contract, rules = _verdicts(strategy, overlap, state, params,
                                       axes, True, build.contract_kwargs)
    del params
    if rank == 0:
        log(f"[{name}] plan={plan.describe()} -> strategy={strategy} "
            f"grid={ {a: mesh.axis_size(axes[a]) for a in grid_names(plan)} } "
            f"ws={ws} scale={scale} batch={rc.batch_size} device={dev}")
        log(f"[{name}] rules[{cname}]: "
            f"{'ok' if rules['ok'] else 'MISMATCH'} ({rules['checked']} "
            f"leaves checked)")
    prof = H.profiler(rc, profile_schedule, ProfileSchedule())
    telem_args = {"dev": dev, "model": "toy-mlp", "profiler": prof,
                  "prefetch": False, "contract": {"strategy": cname,
                                                  "calls": contract},
                  "rules": rules,
                  "extra": {"mesh_plan": plan.describe(),
                            "strategy": strategy, "scale": scale,
                            "rebuild": rebuild}}
    state, opt, losses, counts, times, wall, pump, telem, ok = _loop(
        ctx, rc, telem_args, build.step, state, opt,
        itertools.repeat(batch), name=name, tokens=rc.batch_size,
        contract=contract, rank=rank, on_step=on_step, log=log)
    holder["losses"] = losses
    opt_mb = sum(t.numel() * t.element_size() for part in (opt.mu, opt.nu)
                 for _, t in optim.tree_leaves(part)) / 2 ** 20
    step_ms = (statistics.median(np.diff([0.0] + times)[1:]) * 1e3
               if len(times) > 1 else None)
    _check(ok, rules, name)
    return {"plan": plan.describe(), "strategy": strategy, "world_size": ws,
            "status": "completed", "start_step": ctx.start_step,
            "device": str(dev), "losses": losses, "collectives": counts,
            "contract": contract, "contract_ok": ok, "rules": rules,
            "opt_mb": opt_mb, "step_times_s": times, "step_ms": step_ms,
            "params": state,
            "wall_s": wall, "run_dir": telem.run_dir,
            **H.ckpt_report(holder)}


def _check(ok: bool, rules: dict, name: str) -> None:
    if not ok:
        raise SystemExit(f"[{name}] a step's collectives differ from the "
                         f"generated contract")
    if not rules["ok"]:
        raise SystemExit(f"[{name}] the live shards break their rules: "
                         f"{rules.get('mismatches') or rules['hygiene']}")


def _lm_leg(ctx, holder, rc, plan, strategy, *, model, overlap, attention,
            device, profile_schedule, on_step, log, **_) -> dict:
    """The packed-LM loop of ``train/_2d.py`` over the plan's grid."""
    name = "composable"
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    bs, seq, accum = rc.batch_size, rc.sequence_length, rc.accum_steps
    cfg = model_config(model, rc.precision, attention)
    axes = plan_grid(plan)
    gen = torch.Generator(device=dev).manual_seed(rc.seed)
    params = T.init_params(cfg, gen, dev)
    build = make_composable_train_step(params, plan, axes=axes,
                                       model_cfg=cfg, overlap=overlap,
                                       accum_steps=accum)
    shards, opt = build.params, build.opt_state
    key = generator_states({"params": rc.seed}, dev)
    H.track(holder, ctx)
    rs = ctx.restore(RunState(params=shards, opt_state=opt, prng_key=key))
    if rs is not None:
        shards, opt = rs.params, rs.opt_state
    kw = {k: v for k, v in build.contract_kwargs.items() if k != "overlap"}
    cname, contract, rules = _verdicts(strategy, overlap, shards, params,
                                       axes, cfg.remat,
                                       {**kw, "overlap": overlap})
    del params
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    grid = {a: mesh.axis_size(axes[a]) for a in grid_names(plan)}
    if rank == 0:
        log(f"[{name}] plan={plan.describe()} -> strategy={strategy} "
            f"model={model} ({cfg.param_count() / 1e9:.3f}B) grid={grid} "
            f"batch={bs} seq={seq} overlap={overlap} accum_steps={accum} "
            f"precision={cfg.matmul_precision} "
            f"attention={cfg.attention_impl} device={dev}")
        log(f"[{name}] rules[{cname}]: "
            f"{'ok' if rules['ok'] else 'MISMATCH'} ({rules['checked']} "
            f"leaves checked); contract[{cname}] (generated) "
            f"{json.dumps(C.COLLECTIVES.nonzero(contract))}")
    flops_tok = T.model_flops_per_token(cfg, seq)
    tracker = PerformanceTracker(
        warmup_steps=min(3, max(rc.num_steps - 1, 0)),
        flops_per_token=flops_tok, num_devices=ws, device=dev)
    prof = H.profiler(rc, profile_schedule, ProfileSchedule(
        skip_first=0, wait=1, warmup=2, active=5))
    batches = fsdp_batches(cfg.vocab_size, seq, bs, rc.num_steps, rc.seed)
    if ctx.data_cursor:
        batches = itertools.islice(batches, ctx.data_cursor, None)
    telem_args = {"dev": dev, "model": model, "profiler": prof,
                  "prefetch": True, "contract": {"strategy": cname,
                                                 "calls": contract},
                  "rules": rules,
                  "extra": {"mesh_plan": plan.describe(),
                            "strategy": strategy, "grid": grid,
                            "overlap": overlap}}
    shards, opt, losses, counts, times, wall, pump, telem, ok = _loop(
        ctx, rc, telem_args, build.step, shards, opt, batches, name=name,
        tokens=bs * seq, contract=contract, rank=rank, on_step=on_step,
        log=log, key=key, tracker=tracker)
    holder["losses"] = losses
    n_timed, dt = ((len(times) - 2, times[-1] - times[1]) if len(times) > 2
                   else (len(times), times[-1] if times else 0.0))
    tok_s = n_timed * bs * seq / dt if dt > 0 else 0.0
    mfu = flops_tok * tok_s / (ws * PEAK_BF16_FLOPS)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    step_ms = (statistics.median(np.diff(times)) * 1e3 if len(times) > 1
               else None)
    if rank == 0:
        log(f"[{name}] step ms {step_ms} (median after the first, host "
            f"clock), tokens/s {tok_s:.1f} (global), MFU "
            f"{mfu:.4f}, peak memory "
            + (f"{peak / 2 ** 30:.2f} GiB a rank" if peak is not None
               else "not measured (CPU)")
            + f"; host syncs {pump.host_sync_count}")
    _check(ok, rules, name)
    return {"plan": plan.describe(), "strategy": strategy, "model": model,
            "world_size": ws, "grid": grid, "overlap": overlap,
            "batch_size": bs, "sequence_length": seq, "accum_steps": accum,
            "precision": rc.precision, "attention": cfg.attention_impl,
            "status": "completed", "start_step": ctx.start_step,
            "device": str(dev), "losses": losses, "collectives": counts,
            "contract": contract, "contract_ok": ok, "rules": rules,
            "step_times_s": times, "step_ms": step_ms, "wall_s": wall,
            "tokens_per_second": tok_s, "mfu": mfu,
            "tracker": pump.metrics, "peak_memory_bytes": peak,
            "run_dir": telem.run_dir, "profiler": prof, "params": shards,
            "model_flops_per_token": flops_tok, **H.ckpt_report(holder)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--mesh", required=True, metavar="PLAN",
                   help="MeshPlan grammar: x-separated <axis><size> / "
                        "w<0-3>[flat|named] tokens, e.g. dp2xfsdp2xtp2, "
                        "dp8xw1, dp8xw3named")
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY), default="tiny",
                   help="transformer plans only")
    p.add_argument("--scale", type=int, default=20,
                   help="MLP plans only: divide the 10k toy width by this")
    p.add_argument("--rebuild", choices=["broadcast", "all_gather"],
                   default="broadcast",
                   help="zero1 / zero2 plans: the params' rebuild")
    p.add_argument("--overlap", default="none",
                   choices=sorted(set(fsdp.OVERLAP_MODES) | set(T.TP_OVERLAPS)),
                   help="fsdp plans: the gathers; tp and 3-axis plans: the "
                        "rejoins")
    p.add_argument("--attention", choices=["xla", "flash"], default=None)
    p.add_argument("--plan", default=None, metavar="PLAN_JSON",
                   help="a tuner plan: refused, the tuner is not ported "
                        "(ROADMAP.md A12)")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo and "
                        "the plain path")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args, rest = p.parse_known_args(argv)
    if args.plan:
        raise SystemExit("--plan replays a tuner plan: the tuner and the "
                         f"memory planner are not ported yet — see {A12}")
    batch_given = "--batch-size" in rest
    seq_given = "--sequence-length" in rest
    cfg = TrainConfig.from_args(rest)
    try:
        res = run(args.mesh, args.model, scale=args.scale,
                  rebuild=args.rebuild, overlap=args.overlap,
                  accum_steps=cfg.accum_steps,
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


if __name__ == "__main__":
    main()
