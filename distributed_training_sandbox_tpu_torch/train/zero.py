"""ZeRO-1/2/3 A/B runs on the ZeRO toy MLP: the twin of the JAX
package's ``scripts/zero1.py``, ``zero2.py`` and ``zero3.py`` (their
shared ``scripts/_zero_driver.py``).

    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.zero --stage 3 \\
        --device cpu --scale 200
    python -m distributed_training_sandbox_tpu_torch.train.zero --stage 1 \\
        --scale 1 --rebuild all_gather

One process per rank runs two legs on identically seeded params (width
10 000 / ``--scale``) and one fixed randn batch (``--batch-size`` rows,
each rank taking its contiguous rows): leg A, the baseline, is Adam
through ``make_ddp_train_step`` (replicated optimizer state); leg B the
ZeRO step of ``--stage`` (1 and 2 rebuild the params by ``--rebuild``).
It prints the A/B report: per-device optimizer MB of both legs (and
param MB for stage 3), step ms of both (host clock, the median of the
steps after the first), the collectives a step (the shim
``ops.collectives.COLLECTIVES``), the loss drift between the legs and
the largest difference of their final params (stage 3's gathered from
its chunks), and the device memory allocated at each leg's start and
at its peak.  MB are 2^20 bytes, as the reference counts them.  NCCL
and the card by default, gloo with ``--device cpu``; run alone, it is
one rank.

Both legs run under the supervisor of the run harness
(``train.harness``) with per-leg checkpoint scopes
(``<checkpoint-dir>/baseline``, ``<checkpoint-dir>/sharded``): a
preemption or injected crash mid-leg (``--inject-fault
preempt@3:sharded``) resumes THAT leg from its latest step, and a leg
that already completed replays nothing and reports its checkpointed
losses, as ``scripts/_zero_driver.py`` does.  Each leg has its own
telemetry run, profiler (under ``<trace-dir>/zero<stage>/<leg>``) and
step pump; a profiled leg's summary carries the comm/compute split of
its trace (``comm_split``).

Each leg's first step is held to its contract (``analysis.contracts``:
``ddp`` for the baseline, ``zero<stage>`` with its ``--rebuild`` for the
sharded leg): the verdict is printed, lands in the leg's manifest
(``contract``) beside its rules verdict (``rules``), and a profiled leg
joins its trace to the verdict's expected calls (``collectives.json``).
Not ported: ``--plan`` (ROADMAP.md queue A item A12).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from ..analysis.rules import rules_manifest_verdict
from ..models import mlp
from ..ops import collectives as C
from ..parallel import ddp, optim, zero
from ..resilience import RunState
from ..utils import mesh
from ..utils.config import TrainConfig
from ..utils.profiling import ProfileSchedule
from . import harness as H

MB = 2 ** 20


def tree_mb(tree) -> float:
    """The bytes this rank holds of a tensor tree, in MB."""
    return sum(t.numel() * t.element_size()
               for _, t in optim.tree_leaves(tree)) / MB


def _leg(step, state, opt, batch, num_steps, dev, *, ctx, cfg, name, leg,
         stage, scale, holder, verdict, rules, profile_schedule=None,
         on_step=None, log=print):
    """``num_steps`` steps of one leg under its resilience scope ``ctx``:
    restored steps are skipped, and a leg that already completed runs
    nothing.  ``verdict`` (``harness.Verdict``) judges its first step,
    ``rules`` goes in its manifest.  Returns ``(state, opt, losses,
    step_s, counts, memory)``:
    ``losses`` stitched across restarts, ``step_s`` each step's
    host-clock seconds (the step's call until the pump returns),
    ``counts`` each step's collectives, ``memory`` the bytes allocated
    at the leg's start (its params or chunks and optimizer state, and
    whatever the run still holds) and at its peak (None on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    step_s, counts = [], []
    prof = H.profiler(cfg, profile_schedule, ProfileSchedule(),
                      trace_dir=f"{cfg.trace_dir}/{name}/{leg}")
    strategy = name if leg == "sharded" else f"{name}-{leg}"
    with H.telemetry(strategy, cfg, ctx, dev, model="toy-mlp",
                     profiler=prof, rules=rules,
                     extra={"leg": leg, "stage": stage,
                            "scale": scale}) as telem:
        H.wire(telem, ctx)
        with H.pump(cfg, telem, None, ctx) as pump:
            for i in range(ctx.start_step, num_steps):
                if ctx.should_stop(i):
                    break
                verdict.begin()
                t = time.perf_counter()
                state, opt, loss = step(state, opt, batch)
                counts.append(verdict.end(telem, ctx))
                synced = pump.emit(loss, tokens=batch[0].shape[0],
                                   log=on_step and (lambda lf, i=i:
                                                    on_step(i, lf)))
                step_s.append(time.perf_counter() - t)
                ctx.after_step(i, synced, lambda i=i: RunState(
                    params=state, opt_state=opt, step=i, data_cursor=i + 1,
                    loss_log=ctx.full_losses(pump.losses)))
        losses = ctx.full_losses(pump.losses)
        holder.setdefault("legs", {})[leg] = losses
        holder["losses"] = sum(holder["legs"].values(), [])
        if ctx.start_step >= num_steps:
            log(f"[{name}] resume: the {leg} leg's {num_steps} steps were "
                f"all done ({len(losses)} checkpointed losses)")
        ctx.finalize(telem)   # final save; raises Preempted on SIGTERM
    memory = ({"start": start, "peak": torch.cuda.max_memory_allocated(dev)}
              if dev.type == "cuda" else None)
    return state, opt, losses, step_s, counts, memory


def toy_problem(scale: int, batch_size: int, seed: int, dev):
    """``(init_params, batch)``: ``init_params()`` draws the MLP at width
    10 000 / ``scale`` from ``seed`` (each leg calls it, so the legs
    start identical); ``batch`` the fixed global randn batch, drawn from
    ``seed + 1``."""
    def init_params():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return mlp.zero_toy_mlp(gen, scale=scale, device=dev)

    width = mlp.ZERO_TOY_SIZES[0] // scale
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch = (torch.randn(batch_size, width, generator=gen, device=dev),
             torch.randn(batch_size, width, generator=gen, device=dev))
    return init_params, batch


def _median_ms(step_s: list) -> float:
    """The median of the steps after the first, in ms."""
    return statistics.median(step_s[1:] or step_s) * 1e3


def run(stage: int = 1, *, rebuild: str = "broadcast", scale: int = 20,
        num_steps: int = 20, batch_size: int = 16, seed: int = 42,
        device=None, keep_params: bool = False,
        config: TrainConfig | None = None, profile_schedule=None,
        on_step=None, log=print) -> dict:
    """The A/B run on this rank under the supervisor.  Joins (or makes)
    the process group and leaves it up.  ``config`` holds the harness's
    options (``train.harness.quiet_config`` when None).  Returns both
    legs' losses (stitched across restarts), ``status``, step times and
    collectives a step of this segment, optimizer (and stage 3's param)
    MB, memory allocated at each leg's start and peak, the loss drift
    and the final params' largest difference (``param_max_abs_diff``,
    ``params_bit_equal``); with ``keep_params`` also both legs' final
    full params (``base_params``, ``shard_params``).  ``on_step(leg, i,
    loss)`` (leg ``"baseline"`` or ``"sharded"``) is called once each
    step's loss has reached the host."""
    if stage not in (1, 2, 3):
        raise ValueError(f"stage={stage!r}; choose 1, 2 or 3")
    if rebuild not in zero.REBUILD_MODES:
        raise ValueError(f"unknown rebuild mode {rebuild!r}")
    cfg = H.run_config(config, num_steps=num_steps, batch_size=batch_size,
                       seed=seed)
    return H.supervise(
        cfg, f"zero{stage}", lambda ctx, holder: _run(
            ctx, holder, cfg, stage, rebuild=rebuild, scale=scale,
            device=device, keep_params=keep_params,
            profile_schedule=profile_schedule, on_step=on_step, log=log),
        extra_fingerprint={"scale": scale, "rebuild": rebuild})


def _run(root_ctx, holder, cfg, stage, *, rebuild, scale, device,
         keep_params, profile_schedule, on_step, log) -> dict:
    num_steps, batch_size, seed = cfg.num_steps, cfg.batch_size, cfg.seed
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    name = f"zero{stage}"
    width = mlp.ZERO_TOY_SIZES[0] // scale
    init_params, batch = toy_problem(scale, batch_size, seed, dev)
    params = init_params()
    shapes = [{k: tuple(v.shape) for k, v in layer.items()}
              for layer in params]
    n_leaves = len(list(optim.tree_leaves(params)))
    global_mb = tree_mb(params)
    if rank == 0:
        log(f"[{name}] world={ws} width={width} scale={scale} "
            f"batch={batch_size} rebuild={rebuild if stage < 3 else '-'} "
            f"dispatch={cfg.dispatch} device={dev}")
    # per-leg resilience scopes: own checkpoint subdir and resume
    # position, shared SIGTERM flag, fault injector and lineage
    ctx_a, ctx_b = root_ctx.scope("baseline"), root_ctx.scope("sharded")
    H.track(holder, ctx_a, ctx_b)
    leg_kw = dict(cfg=cfg, name=name, stage=stage, scale=scale,
                  holder=holder, profile_schedule=profile_schedule, log=log)

    # ---- leg A: baseline Adam (replicated state, DDP-style)
    axes = {"dp": "dp"}
    base_verdict = H.Verdict("ddp", params=params, axes=axes,
                             label=f"{name}/baseline", rank=rank, log=log)
    base_rules = rules_manifest_verdict("ddp", params=params)
    base_step = ddp.make_ddp_train_step(
        mlp.mse_loss, lambda g, s, p: optim.adam_update(g, s, p))
    base_opt = optim.adam_init(params)
    rs = ctx_a.restore(RunState(params=params, opt_state=base_opt))
    if rs is not None:
        params, base_opt = rs.params, rs.opt_state
    base_params, base_opt, base_losses, base_s, base_counts, base_mem = \
        _leg(base_step, params, base_opt, batch, num_steps, dev,
             ctx=ctx_a, leg="baseline", verdict=base_verdict,
             rules=base_rules, on_step=on_step and (
                 lambda i, l: on_step("baseline", i, l)), **leg_kw)
    base_opt_mb = tree_mb(base_opt.mu) + tree_mb(base_opt.nu)
    del params, base_opt

    # ---- leg B: the sharded optimizer, on identically seeded params
    params = init_params()
    # zero3's rebuild is its gathers; 1 and 2 take --rebuild
    shard_verdict = H.Verdict(
        name, params=params, axes=axes, label=name, rank=rank, log=log,
        **({"rebuild": rebuild} if stage < 3 else {}))
    opt = zero.init_zero_opt_state(params)
    if stage < 3:
        step = zero.make_zero_train_step(mlp.mse_loss, stage=stage,
                                         rebuild=rebuild)
        state = params
    else:
        step = zero.make_zero3_train_step(zero.make_zero3_mlp_loss(shapes))
        state = zero.shard_params_zero3(params)
    # the placement of the leg's own tree (zero3's flat chunks)
    shard_rules = rules_manifest_verdict(name, params=state, full=params,
                                         axis_sizes={"dp": ws})
    del params
    rs = ctx_b.restore(RunState(params=state, opt_state=opt))
    if rs is not None:
        state, opt = rs.params, rs.opt_state
    state, opt, shard_losses, shard_s, shard_counts, shard_mem = _leg(
        step, state, opt, batch, num_steps, dev, ctx=ctx_b, leg="sharded",
        verdict=shard_verdict, rules=shard_rules, on_step=on_step and (lambda i, l: on_step("sharded", i, l)),
        **leg_kw)
    shard_opt_mb = tree_mb(opt.mu) + tree_mb(opt.nu)
    chunk_mb = tree_mb(state) if stage == 3 else None
    del opt
    shard_params = (zero.unshard_params_zero3(state, shapes) if stage == 3
                    else state)
    del state
    pairs = [(a, optim.tree_get(shard_params, path))
             for path, a in optim.tree_leaves(base_params)]
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    drift = float(np.max(np.abs(np.array(base_losses)
                                - np.array(shard_losses))))
    base_ms, shard_ms = (_median_ms(base_s) if base_s else None,
                         _median_ms(shard_s) if shard_s else None)

    if rank == 0:
        log(f"[{name}] baseline losses {base_losses}")
        log(f"[{name}] sharded losses  {shard_losses}")
        log(f"\n[{name}] === A/B report ===")
        log(f"[{name}] params: {n_leaves} tensors, {global_mb:.1f} MB "
            f"global")
        log(f"[{name}] per-device optimizer state: baseline "
            f"{base_opt_mb:.2f} MB -> sharded {shard_opt_mb:.2f} MB "
            f"({base_opt_mb / max(shard_opt_mb, 1e-9):.1f}x smaller, "
            f"ws={ws})")
        if stage == 3:
            log(f"[{name}] per-device params: full {global_mb:.2f} MB -> "
                f"chunks {chunk_mb:.2f} MB")
        log(f"[{name}] step time: baseline {base_ms} ms, sharded "
            f"{shard_ms} ms (host clock, median of this segment's steps "
            f"after its first)")
        log(f"[{name}] rules[ddp/baseline]: "
            f"{'ok' if base_rules['ok'] else 'MISMATCH'}; rules[{name}]: "
            f"{'ok' if shard_rules['ok'] else 'MISMATCH'}")
        for leg, cs in (("baseline", base_counts), ("sharded ", shard_counts)):
            log(f"[{name}] per-step collectives {leg}: " + (json.dumps(
                C.COLLECTIVES.nonzero(cs[-1])) if cs else "no step run "
                "in this segment"))
        log(f"[{name}] loss drift baseline-vs-sharded: {drift:.2e} "
            f"({'OK' if drift < 1e-3 else 'DIVERGED'})")
        log(f"[{name}] final params: max |baseline - sharded| {diff:.3e}, "
            f"bit-equal {bit_equal}")
        if dev.type == "cuda":
            log(f"[{name}] memory allocated at the start and the peak of "
                f"each leg: baseline {base_mem['start'] / 2 ** 30:.3f} and "
                f"{base_mem['peak'] / 2 ** 30:.3f} GiB, sharded "
                f"{shard_mem['start'] / 2 ** 30:.3f} and "
                f"{shard_mem['peak'] / 2 ** 30:.3f} GiB (the sharded leg's "
                f"start holds the baseline's final params)")
    res = {"stage": stage, "rebuild": rebuild, "world_size": ws,
           "scale": scale, "width": width, "batch_size": batch_size,
           "device": str(dev), "n_leaves": n_leaves, "param_mb": global_mb,
           "base_opt_mb": base_opt_mb, "shard_opt_mb": shard_opt_mb,
           "shard_param_mb": chunk_mb, "base_ms": base_ms,
           "shard_ms": shard_ms, "base_step_s": base_s,
           "shard_step_s": shard_s, "base_counts": base_counts,
           "shard_counts": shard_counts,
           "base_contract": base_verdict.result(),
           "shard_contract": shard_verdict.result(),
           "rules": {"baseline": base_rules, "sharded": shard_rules},
           "base_losses": base_losses,
           "shard_losses": shard_losses, "loss_drift": drift,
           "param_max_abs_diff": diff, "params_bit_equal": bit_equal,
           "base_memory_bytes": base_mem, "shard_memory_bytes": shard_mem,
           "status": "completed", "losses": base_losses + shard_losses,
           **H.ckpt_report(holder)}
    if keep_params:
        res.update(base_params=base_params, shard_params=shard_params)
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--stage", type=int, choices=(1, 2, 3), default=1)
    p.add_argument("--rebuild", choices=zero.REBUILD_MODES,
                   default="broadcast")
    p.add_argument("--scale", type=int, default=20,
                   help="divide the 10k toy width by this")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args, rest = p.parse_known_args(argv)
    cfg = TrainConfig.from_args(rest, batch_size=16)
    try:
        res = run(args.stage, rebuild=args.rebuild, scale=args.scale,
                  num_steps=cfg.num_steps, batch_size=cfg.batch_size,
                  seed=cfg.seed, device=args.device, config=cfg)
        if args.out and mesh.axis_rank() == 0:
            Path(args.out).write_text(json.dumps(res, default=str))
        if mesh.axis_rank() == 0 and not all(
                np.isfinite(res["losses"])):
            raise SystemExit("non-finite loss")
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
