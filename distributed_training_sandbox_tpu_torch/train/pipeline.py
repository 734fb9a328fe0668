"""Pipeline-parallel training: the twin of the JAX package's
``scripts/_pp_driver.py`` and of the ``gpipe.py``, ``1f1b.py`` and
``interleaved_1f1b.py`` scripts that share it.  A module name cannot
start with a digit, so the three scripts are one flag, ``--schedule``.

    python -m distributed_training_sandbox_tpu_torch.train.pipeline \\
        --schedule 1f1b --n-stages 4
    python -m distributed_training_sandbox_tpu_torch.train.pipeline \\
        --schedule interleaved --n-stages 8 --virtual-per-device 2
    python -m distributed_training_sandbox_tpu_torch.train.pipeline \\
        --model smollm3-3b --n-stages 4 --schedule gpipe --num-epochs 3
    python -m distributed_training_sandbox_tpu_torch.train.pipeline \\
        --device cpu --schedule 1f1b --num-epochs 2

One process drives every stage.  Stages go on ``cuda:0 … cuda:D−1``,
cycling over the cards (the interleaved schedule on ``--n-stages /
--virtual-per-device`` of them); with ``--device cpu`` every stage is on
the CPU, the interleaved clock counting that many logical devices.  The
model is the reference's PP toy (``--model mlp``: 50 → 4 × 500 → 50,
mean squared error) or a transformer staged by
``build_transformer_pipeline``, seeded from ``--seed``.  Each epoch
draws a fresh batch from one generator seeded with ``--seed`` + 1:
randn inputs and targets for the toy, and for the transformer packed
windows of ``--seq`` + 1 random tokens, inputs ``w[:-1]`` and labels
``w[1:]``, as ``_pp_driver.py``'s.  ``--opt8`` keeps each stage's Adam
moments int8 at rest (``parallel.optim8``).  The JSON printed (and
written to ``--results-file``) is ``PipeResult.as_dict()`` plus the
first epoch's verdict of the ``gpipe`` / ``1f1b`` contract (zero calls
of every kind; ``analysis.contracts``) and the rules verdict, each
epoch's collectives and step time and the memory of each card.

The run harness (``train.harness``), as the other twins run under it:
the supervisor (``--checkpoint-dir``, ``--checkpoint-every``,
``--resume``, ``--max-restarts``, ``--inject-fault``), a RunState
checkpoint at the epochs' sync points holding every stage's params and
Adam state (int8 moments under ``--opt8``), each restored onto its own
stage's device, a resume re-entering the epoch loop at the epoch after
the checkpoint's and skipping the batches already drawn, the host
prefetcher (``--prefetch-depth``) staging the batches, a run directory
(``--results-dir``) and the profiler (``--trace-dir``; its sessions give
the run's comm/compute split: the hops between cards, zero on one
card, where the stages hand over without a copy, and a collective
ledger joined to the zero-collective contract).

    python -m distributed_training_sandbox_tpu_torch.train.pipeline \
        --device cpu --checkpoint-dir /tmp/pp --inject-fault preempt@3 \
        --max-restarts 1 --num-epochs 6
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

from ..analysis.rules import rules_manifest_verdict
from ..device import resolve_device
from ..models import MODEL_REGISTRY, mlp
from ..models import transformer as T
from ..ops import collectives as C
from ..parallel import pipeline as PP
from ..resilience import RunState, generator_states
from ..runtime import DevicePrefetcher
from ..utils.config import TrainConfig
from ..utils.memory import MB, device_memory_stats
from ..utils.profiling import ProfileSchedule
from . import harness as H

SCHEDULES = ("gpipe", "1f1b", "interleaved")
MODELS = ("mlp",) + tuple(sorted(MODEL_REGISTRY))
def stage_devices(schedule: str, n_stages: int, virtual_per_device: int,
                  device=None) -> list[torch.device]:
    """The devices ``build_pipeline`` cycles over: every card; for the
    interleaved schedule ``n_stages / virtual_per_device`` logical
    devices, placed on the cards in turn (two on one card share it), or
    on the CPU."""
    dev = resolve_device(device)
    n_dev = None
    if schedule == "interleaved":
        if n_stages % virtual_per_device:
            raise ValueError(f"--n-stages {n_stages} not divisible by "
                             f"--virtual-per-device {virtual_per_device}")
        n_dev = n_stages // virtual_per_device
    if dev.type == "cpu":
        return [dev] * (n_dev or 1)
    cards = PP.default_devices()
    return cards if n_dev is None else [cards[i % len(cards)]
                                        for i in range(n_dev)]


def epoch_batches(cfg, batch_size: int, seq: int, seed: int, device):
    """A fresh (inputs, targets) batch an epoch, on ``device``, from one
    generator seeded with ``seed + 1``: randn pairs of the toy's widths
    (``cfg`` None), or packed token windows of ``cfg``'s vocabulary."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    while True:
        if cfg is None:
            yield (torch.randn(batch_size, mlp.PP_TOY_SIZES[0],
                               generator=gen, device=device),
                   torch.randn(batch_size, mlp.PP_TOY_SIZES[-1],
                               generator=gen, device=device))
        else:
            w = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1),
                              generator=gen, device=device)
            yield w[:, :-1], w[:, 1:]


def build_stages(model: str, schedule: str, n_stages: int,
                 virtual_per_device: int, seed: int, device=None,
                 opt8: bool = False):
    """``(stages, cfg)``: the seeded model split over ``stage_devices``
    (``cfg`` None for the toy); ``opt8``: int8 Adam moments."""
    devs = stage_devices(schedule, n_stages, virtual_per_device, device)
    gen = torch.Generator(device=devs[0]).manual_seed(seed)
    if model == "mlp":
        return PP.build_pipeline(mlp.pp_toy_mlp(gen, device=devs[0]),
                                 n_stages, devices=devs, opt8=opt8), None
    cfg = getattr(T, MODEL_REGISTRY[model])
    params = T.init_params(cfg, gen, devs[0])
    return PP.build_transformer_pipeline(params, cfg, n_stages,
                                         devices=devs, opt8=opt8), cfg


def run(schedule: str = "1f1b", *, model: str = "mlp", n_stages: int = 2,
        virtual_per_device: int = 2, n_micro: int = 4, lr: float = 1e-3,
        warmup_epochs: int = 0, num_epochs: int = 16, batch_size: int = 64,
        seq: int = 256, seed: int = 42, device=None, opt8: bool = False,
        config: TrainConfig | None = None, profile_schedule=None,
        keep_stages: bool = False, on_step=None, log=print) -> dict:
    """Train ``num_epochs`` pipeline steps of ``schedule`` under the
    supervisor; ``config`` holds the harness's options
    (``train.harness.quiet_config`` when None: nothing written, no
    checkpoints).  ``on_step(epoch, loss)`` is called once each epoch's
    loss has reached the host.  Returns ``PipeResult.as_dict()`` (its
    ``losses`` stitched across restarts) plus ``"status"``,
    ``"lineage"``, ``"start_epoch"``, the checkpoint saves and restores,
    ``"run_dir"``, ``"contract"`` (the shim's collectives of each epoch
    of this segment against ``parallel.contracts``), ``"step_ms"`` (each
    epoch on the host clock, until its loss reaches the host),
    ``"final_loss_batch0"`` (the first batch's loss under the final
    params: fresh batches move the epoch losses by their draw more than
    a few steps move the model), ``"devices"``, ``"start_memory_mb"``
    (each card's allocated MB when training starts; ``"peak_memory_mb"``
    holds its peak since then), ``"pump"`` and, with ``keep_stages``,
    ``"stages"`` (the stages themselves, their params and Adam state);
    for a transformer also ``"tokens_per_s"`` (over the median epoch
    after the first) and ``"model_flops_per_token"``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}; choose from {SCHEDULES}")
    cfg_run = H.run_config(config, num_epochs=num_epochs,
                           batch_size=batch_size, sequence_length=seq,
                           seed=seed)
    fp = {"model": model, "schedule": schedule, "n_stages": n_stages,
          "n_micro": n_micro, "virtual_per_device": virtual_per_device,
          "opt8": opt8}
    return H.supervise(cfg_run, schedule, lambda ctx, holder: _run(
        ctx, holder, cfg_run, schedule, model=model, n_stages=n_stages,
        virtual_per_device=virtual_per_device, n_micro=n_micro, lr=lr,
        warmup_epochs=warmup_epochs, device=device, opt8=opt8,
        profile_schedule=profile_schedule, keep_stages=keep_stages,
        on_step=on_step, log=log),
        extra_fingerprint=fp)


def _run(ctx, holder, rc, schedule, *, model, n_stages, virtual_per_device,
         n_micro, lr, warmup_epochs, device, opt8, profile_schedule,
         keep_stages, on_step, log) -> dict:
    num_epochs, batch_size = rc.num_epochs, rc.batch_size
    seq, seed = rc.sequence_length, rc.seed
    stages, cfg = build_stages(model, schedule, n_stages, virtual_per_device,
                               seed, device, opt8)
    dev0 = stages[0].device
    key = generator_states({"params": seed, "data": seed + 1}, dev0)
    H.track(holder, ctx)
    # resume: every stage's params and Adam state, each back on its own
    # stage's device (the restore fills ``like``'s devices)
    rs = ctx.restore(RunState(params=[s.params for s in stages],
                              opt_state=[s.opt_state for s in stages],
                              prng_key=key))
    if rs is not None:
        for s, sp, so in zip(stages, rs.params, rs.opt_state):
            s.load_state(sp, so)
    cards = list(dict.fromkeys(s.device for s in stages
                               if s.device.type == "cuda"))
    start = {}
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        start[str(d)] = device_memory_stats(d)["bytes_in_use"] / MB
    first = next(epoch_batches(cfg, batch_size, seq, seed, dev0))
    stream = epoch_batches(cfg, batch_size, seq, seed, dev0)
    if ctx.data_cursor:
        # resume: the seeded stream, past the batches already drawn
        stream = itertools.islice(stream, ctx.data_cursor, None)
    log(f"[{schedule}] model={model} stages={len(stages)} micro={n_micro} "
        f"batch={batch_size}" + (f" seq={seq}" if cfg else "")
        + f" devices={[str(s.device) for s in stages]}"
        + (f" start_epoch={ctx.start_step}" if ctx.start_step else ""))
    # interleaved rides on 1f1b's contract, as in the reference
    cname = schedule if schedule in ("gpipe", "1f1b") else "1f1b"
    stage_params = [s.params for s in stages]
    verdict = H.Verdict(cname, params=stage_params, label=schedule,
                        log=log)
    rules = rules_manifest_verdict(cname, params=stage_params)
    tokens = batch_size * seq if cfg is not None else batch_size
    prof = H.profiler(rc, profile_schedule, ProfileSchedule(
        skip_first=2, wait=1, warmup=1, active=4))
    counts, step_ms, ep_losses, marks = [], [], [], {}
    if warmup_epochs:
        def lr_fn(e):
            return lr * min(1.0, (e + 1) / warmup_epochs)
    else:
        lr_fn = lr
    pref = DevicePrefetcher(stream, device=dev0, depth=rc.prefetch_depth)
    with pref, H.telemetry(schedule, rc, ctx, dev0, model=model,
                           profiler=prof, rules=rules,
                           extra={"n_stages": n_stages, "n_micro": n_micro,
                                  "opt8": opt8}) as telem:
        H.wire(telem, ctx, pref)

        def on_epoch(epoch, loss):
            now = time.perf_counter()
            step_ms.append((now - marks["t"]) * 1e3)
            marks["t"] = now
            # zero sites: the ledger joins empty
            counts.append(verdict.end(telem, ctx))
            verdict.begin()
            ep_losses.append(float(loss))
            if epoch % 4 == 0 or epoch == num_epochs - 1:
                log(f"[{schedule}] epoch {epoch:3d} loss {loss:.6f}")
            telem.step(loss=loss, tokens=tokens)
            # the epoch's loss reached the host: every epoch is a sync
            # point for the checkpointer
            ctx.after_step(epoch, True, lambda epoch=epoch: RunState(
                params=[s.params for s in stages],
                opt_state=[s.opt_state for s in stages], step=epoch,
                data_cursor=epoch + 1, prng_key=key,
                loss_log=ctx.full_losses(ep_losses)))
            if on_step is not None:
                on_step(epoch, loss)

        verdict.begin()
        marks["t"] = time.perf_counter()
        result = PP.train_pipeline(stages, schedule, lambda e: next(pref),
                                   num_epochs=num_epochs, n_micro=n_micro,
                                   lr=lr_fn, log=on_epoch,
                                   start_epoch=ctx.start_step,
                                   should_stop=ctx.should_stop)
        holder["losses"] = ctx.full_losses(ep_losses)
        ctx.finalize(telem)
    out = result.as_dict()
    out["losses"] = ctx.full_losses(ep_losses)
    out.update(status="completed", start_epoch=ctx.start_step,
               run_dir=telem.run_dir, **H.ckpt_report(holder))
    out.update(verdict.result(), collectives=counts, rules=rules)
    out["pump"] = {"prefetch_depth": rc.prefetch_depth,
                   "dispatch": "host-prefetch"}
    out["step_ms"] = step_ms
    out["final_loss_batch0"] = PP.pipeline_loss(stages, *first)
    if cfg is not None and len(step_ms) > 1:
        out["tokens_per_s"] = (batch_size * seq * 1e3
                               / float(np.median(step_ms[1:])))
        out["model_flops_per_token"] = T.model_flops_per_token(cfg, seq)
    out["devices"] = [str(s.device) for s in stages]
    out["start_memory_mb"] = start
    if keep_stages:
        out["stages"] = stages
    log(f"[{schedule}] collectives an epoch "
        f"{json.dumps(C.COLLECTIVES.nonzero(counts[-1]) if counts else {})}"
        f", the contract holds {out['contract_ok']}")
    if telem.run_dir:
        log(f"[{schedule}] telemetry in {telem.run_dir}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--schedule", choices=SCHEDULES, default="1f1b")
    p.add_argument("--n-stages", type=int, default=2,
                   help="stage count; for the interleaved schedule the "
                        "virtual-stage count D·V")
    p.add_argument("--virtual-per-device", type=int, default=2,
                   help="interleaved only: V chunks a device")
    p.add_argument("--n-micro", type=int, default=4)
    p.add_argument("--model", choices=MODELS, default="mlp")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup-epochs", type=int, default=0)
    p.add_argument("--results-file", default=None)
    p.add_argument("--seq", type=int, default=None,
                   help="the transformer's sequence length (default 256; "
                        "also --sequence-length)")
    p.add_argument("--device", default=None,
                   help="default: the CUDA cards; 'cpu' for the CPU")
    p.add_argument("--opt8", action="store_true",
                   help="int8 Adam moments at rest (parallel.optim8)")
    args, rest = p.parse_known_args(argv)
    cfg = TrainConfig.from_args(rest, batch_size=64, num_epochs=16,
                                sequence_length=256)
    if args.seq is not None:
        cfg = dataclasses.replace(cfg, sequence_length=args.seq)
    out = run(args.schedule, model=args.model, n_stages=args.n_stages,
              virtual_per_device=args.virtual_per_device,
              n_micro=args.n_micro, lr=args.lr,
              warmup_epochs=args.warmup_epochs, num_epochs=cfg.num_epochs,
              batch_size=cfg.batch_size, seq=cfg.sequence_length,
              seed=cfg.seed, device=args.device, opt8=args.opt8, config=cfg)
    print(f"[{args.schedule}] {json.dumps(out)}", flush=True)
    if args.results_file:
        Path(args.results_file).write_text(json.dumps(out, indent=2))
        print(f"[{args.schedule}] results -> {args.results_file}")
    if out["status"] != "completed":
        return
    if not (np.all(np.isfinite(out["losses"])) and out["contract_ok"]):
        raise SystemExit(f"non-finite loss in {out['losses']} or "
                         f"collectives off the contract")


if __name__ == "__main__":
    main()
