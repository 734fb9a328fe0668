"""Fully-sharded training of the transformer LM: the twin of the JAX
package's ``scripts/train_fsdp.py``, explicit and auto variants.

    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.train_fsdp \\
        --device cpu --model tiny
    python -m distributed_training_sandbox_tpu_torch.train.train_fsdp \\
        --model smollm3-3b-l8 --overlap ring_fused_pallas --num-steps 8
    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.train_fsdp \\
        --model smollm3-3b-l8 --precision int8_pallas_bwd --attention flash \\
        --quantized-gather --quantized-grads --state-precision int8

Each rank initialises the model from the seed, keeps its shards
(``parallel.fsdp.shard_params_fsdp``) and trains them with AdamW at the
reference step's default lr, on packed windows of the synthetic stream
(the numpy engine), global batch ``--batch-size`` (default: one row a
rank), each rank taking its contiguous rows.  Under ``torchrun`` the
ranks come from its environment; run alone, it is one rank.  NCCL and
the card by default, gloo with ``--device cpu``; the ring_fused_pallas
products go through K7 on the card.  It prints the losses, the
collectives each step issued (the shim ``ops.collectives.COLLECTIVES``),
tokens/s, peak device memory and the Adam state's bytes at rest.

``--remat-policy`` is the reference's flag (``models.transformer``'s
four policies).  ``--quantized-gather``, ``--quantized-grads`` and
``--state-precision {full,int8}`` plumb the options of the reference's
``make_fsdp_train_step`` (int8 gathers, int8 grad reduce-scatters,
int8 Adam moments at rest), which its script reaches only through
``--auto-fit``; they add nothing the JAX package lacks.

The run harness (``train.harness``) as the reference script wires it:
the supervisor (``--checkpoint-dir``, ``--checkpoint-every``,
``--resume``, ``--max-restarts``, ``--inject-fault``), RunState
checkpoints of this rank's shards and Adam state (int8 moments too) and
the seed's generator state, a run directory (``--results-dir``) with the
manifest, ``steps.jsonl``, ``spans.jsonl`` and ``summary.json``, the
profiler (``--trace-dir``; the reference's schedule wait 5, warmup 5,
active 10), the tracker's tokens/s and TFLOP/s a device, the device
prefetcher (``--prefetch-depth``) over the packed batches, fast-forwarded
past the batches a resumed run already consumed, and the step pump
(``--dispatch async|sync``, ``--sync-every``, ``--max-in-flight``):

    python -m distributed_training_sandbox_tpu_torch.train.train_fsdp \\
        --model smollm3-3b-l8 --overlap ring_fused_pallas \\
        --attention flash --checkpoint-dir D --checkpoint-every 2 \\
        --inject-fault preempt@3 --max-restarts 1

The explicit step's first step is held to its contract
(``analysis.contracts``: ``fsdp``, ``fsdp_ring``,
``fsdp_ring_fused_pallas``, ``fsdp_fp8`` at an fp8 precision,
``fsdp_q8`` with ``--quantized-gather``): the verdict is printed and
lands in the manifest's ``contract``, the rules verdict in its
``rules``, and a profiled run joins its trace to the verdict's expected
calls (``collectives.json``).  ``--overlap ring_fused`` files no verdict,
as the reference's script files none (its ledger still joins the fused
calls).

``--variant auto`` runs ``parallel.fsdp.make_fsdp_auto_train_step``:
``torch.distributed.fsdp.fully_shard`` owns the gathers and the grads'
reduce_scatters (the reference leaves them to XLA), each rank holding
the same rows as the explicit step's; the shim sees the loss mean only,
so it files no verdict and no ledger.  It takes none of the explicit
step's wire or memory knobs.

Not ported (ROADMAP.md): the memory planner (``--hbm-budget-gb``,
``--auto-fit``, the predicted waterline) and ``--offload`` (A12).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..analysis.contracts import meta_tree
from ..analysis.rules import rules_manifest_verdict
from ..data import make_packed_dataset, packed_batches
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..ops import collectives as C
from ..parallel import fsdp, optim, optim8
from ..resilience import RunState, generator_states
from ..runtime import DevicePrefetcher
from ..utils import mesh
from ..utils.config import TrainConfig
from ..utils.profiling import ProfileSchedule
from ..utils.tracker import PerformanceTracker
from . import harness as H

PRECISIONS = ("bf16", "fp32", "int8", "int8_pallas", "int8_bwd",
              "int8_pallas_bwd")
VARIANTS = ("explicit", "auto")


def model_config(model: str, precision: str = "bf16",
                 attention: str | None = None,
                 remat_policy: str | None = None,
                 cfg_overrides: dict | None = None) -> T.TransformerConfig:
    """The run's config: int8 names set the projections' precision,
    ``fp32`` the dtype, as the reference script reads ``--precision``;
    ``cfg_overrides`` (config fields, the reference bench's
    ``cfg_overrides``) are applied last."""
    cfg = _model_config(model, precision, attention, remat_policy)
    return (dataclasses.replace(cfg, **cfg_overrides) if cfg_overrides
            else cfg)


def _model_config(model, precision, attention, remat_policy):
    cfg = getattr(T, MODEL_REGISTRY[model])
    if attention:
        cfg = dataclasses.replace(cfg, attention_impl=attention)
    if remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    if precision.startswith("int8"):
        cfg = dataclasses.replace(cfg, matmul_precision=precision)
    elif precision == "fp32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    elif precision != "bf16":
        raise ValueError(f"precision={precision!r}; choose from {PRECISIONS}")
    return cfg


def _contract_name(cfg, overlap: str, quantized_gather: bool) -> str:
    """The contract the explicit step runs as."""
    if quantized_gather:
        return "fsdp_q8"
    if overlap in ("ring", "ring_fused_pallas"):
        return f"fsdp_{overlap}"
    if overlap == "ring_fused":
        return "fsdp_ring_fused_pallas"
    return ("fsdp_fp8" if cfg.matmul_precision.startswith("fp8")
            else "fsdp")


def fsdp_batches(vocab_size: int, seq: int, bs: int, num_steps: int,
                 seed: int):
    """The global (input, label) batches of :func:`run`, in order."""
    ii, ll = make_packed_dataset(
        seq, vocab_size, num_tokens=max(bs * num_steps, 8) * (seq + 1),
        seed=seed, source="synthetic")
    return packed_batches(ii, ll, bs, epochs=num_steps)


def run(model: str = "tiny", *, overlap: str = "none",
        reshard_after_forward: bool = True, accum_steps: int = 1,
        batch_size: int | None = None, seq: int | None = None,
        num_steps: int = 20, attention: str | None = None,
        precision: str = "bf16", device=None, seed: int = 42,
        remat_policy: str | None = None, cfg_overrides: dict | None = None,
        quantized_gather: bool = False,
        quantized_grads: bool = False, state_precision: str = "full",
        variant: str = "explicit",
        config: TrainConfig | None = None, profile_schedule=None,
        on_step=None, log=print) -> dict:
    """Train ``num_steps`` FSDP steps on this rank under the supervisor.
    Joins (or makes) the process group (``utils.mesh.init_process_group``)
    and leaves it up.  ``config`` holds the harness's options
    (``train.harness.quiet_config`` when None: nothing written, a host
    sync every step).  ``on_step(i, loss)`` is called once each step's
    loss has reached the host.  ``quantized_gather``,
    ``quantized_grads`` and ``state_precision`` are the reference step's
    options; ``variant="auto"`` trains through ``fully_shard`` and
    refuses them.  Returns the losses (stitched across restarts), ``status``,
    this segment's collective counts and host-clock times a step (since
    the segment's start, when the pump returned), tokens/s (host clock)
    and the tracker's metrics, peak device memory (None on the CPU), the
    Adam moments' bytes at rest on this rank, the pump's host syncs, the
    checkpoint saves and the restore's seconds.  ``cfg_overrides``:
    config fields set over the model's (``model_config``), the twins'
    one way to train another geometry (``train.moe_bench``,
    ``train.long_context``)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}; choose from {VARIANTS}")
    if variant == "auto" and (overlap != "none" or not reshard_after_forward
                              or quantized_gather or quantized_grads
                              or state_precision != "full"):
        raise ValueError("the auto variant's gathers and memory belong to "
                         "fully_shard: --overlap, "
                         "--no-reshard-after-forward, --quantized-gather, "
                         "--quantized-grads and --state-precision are the "
                         "explicit step's (drop --variant auto)")
    dev = mesh.init_process_group(device)
    ws = mesh.axis_size()
    seq = seq or (256 if model == "tiny" else 8192)
    bs = batch_size or ws
    if bs % ws:
        raise ValueError(f"batch size {bs} must be divisible by the "
                         f"{ws} ranks")
    if (bs // ws) % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide the "
                         f"per-rank batch {bs // ws}")
    cfg_run = H.run_config(config, num_steps=num_steps, seed=seed,
                           batch_size=bs, sequence_length=seq,
                           precision=precision, accum_steps=accum_steps)
    fp = {"model": model, "overlap": overlap,
          "state_precision": state_precision, "variant": variant}
    if cfg_overrides:
        fp["cfg_overrides"] = {k: str(v) for k, v in
                               sorted(cfg_overrides.items())}
    out = H.supervise(cfg_run, "fsdp", lambda ctx, holder: _run(
        ctx, holder, cfg_run, model, overlap=overlap, variant=variant,
        reshard_after_forward=reshard_after_forward, device=dev,
        attention=attention, remat_policy=remat_policy,
        cfg_overrides=cfg_overrides, quantized_gather=quantized_gather,
        quantized_grads=quantized_grads, state_precision=state_precision,
        profile_schedule=profile_schedule, on_step=on_step, log=log),
        extra_fingerprint=fp)
    if variant == "auto":
        # fully_shard's module, its FSDP state and its parameters refer to
        # one another (PyTorch's FSDP2): collected as the run ends, not at
        # the collector's next full pass, which may be runs away
        gc.collect()
    return out


def _run(ctx, holder, rc, model, *, overlap, variant, reshard_after_forward,
         device, attention, remat_policy, cfg_overrides, quantized_gather,
         quantized_grads, state_precision, profile_schedule, on_step,
         log) -> dict:
    num_steps, seed, precision = rc.num_steps, rc.seed, rc.precision
    bs, seq, accum_steps = rc.batch_size, rc.sequence_length, rc.accum_steps
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    cfg = model_config(model, precision, attention, remat_policy,
                       cfg_overrides)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if variant == "auto":
        module = fsdp.fully_shard_params(T.init_params(cfg, gen, dev), cfg)
        shards = fsdp.auto_shards(module)
    else:
        params = T.init_params(cfg, gen, dev)
        full = meta_tree(params)
        shards = fsdp.shard_params_fsdp(params)
        del params
    opt = (fsdp.init_fsdp_opt_state8(shards) if state_precision == "int8"
           else fsdp.init_fsdp_opt_state(shards))
    key = generator_states({"params": seed}, dev)
    H.track(holder, ctx)
    rs = ctx.restore(RunState(params=shards, opt_state=opt, prng_key=key))
    if rs is not None:
        if variant == "auto":   # into the library's storage
            with torch.no_grad():
                for path, x in optim.tree_leaves(shards):
                    x.copy_(optim.tree_get(rs.params, path))
            opt = rs.opt_state
        else:
            shards, opt = rs.params, rs.opt_state
    if variant == "auto":
        step = fsdp.make_fsdp_auto_train_step(module)
    else:
        step = fsdp.make_fsdp_train_step(
            shards, cfg, reshard_after_forward=reshard_after_forward,
            overlap=overlap, accum_steps=accum_steps,
            quantized_gather=quantized_gather,
            quantized_grads=quantized_grads,
            state_precision=state_precision)
    state_bytes = optim8.state_bytes(opt)
    verdict = rules = None   # auto: fully_shard's calls, no shim sites
    if variant != "auto":
        cname = _contract_name(cfg, overlap, quantized_gather)
        # the reference's script files no verdict for ring_fused; the
        # ledger joins its calls, ring_fused_pallas's
        verdict = H.Verdict(
            cname, params=shards, axes={"dp": "dp"},
            n_layers=cfg.num_hidden_layers, label="fsdp", rank=rank,
            log=log, filed=overlap != "ring_fused", overlap=overlap,
            reshard_after_forward=reshard_after_forward, remat=cfg.remat,
            accum_steps=accum_steps, quantized_grads=quantized_grads)
        # fsdp_fp8's ruleset is A12b's; its placement is fsdp's
        rules = rules_manifest_verdict(
            "fsdp" if cname == "fsdp_fp8" else cname, params=shards,
            full=full, axis_sizes={"dp": ws})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if rank == 0:
        log(f"[fsdp] model={model} world={ws} variant={variant} "
            f"overlap={overlap} "
            f"reshard_after_forward={reshard_after_forward} "
            f"accum_steps={accum_steps} batch={bs} seq={seq} "
            f"precision={precision} attention={cfg.attention_impl} "
            f"remat_policy={cfg.remat_policy} "
            f"quantized_gather={quantized_gather} "
            f"quantized_grads={quantized_grads} "
            f"state_precision={state_precision} dispatch={rc.dispatch} "
            f"device={dev}")
        if rules is not None:
            log(f"[fsdp] rules[{rules['strategy']}]: "
                f"{'ok' if rules['ok'] else 'MISMATCH'} "
                f"({rules['checked']} leaves checked)")
    flops_tok = T.model_flops_per_token(cfg, seq)
    tracker = PerformanceTracker(
        warmup_steps=min(5, max(num_steps - 1, 0)),
        flops_per_token=flops_tok, num_devices=ws, device=dev)
    prof = H.profiler(rc, profile_schedule, ProfileSchedule(
        skip_first=0, wait=5, warmup=5, active=10),
        record_shapes=verdict is not None)
    batches = fsdp_batches(cfg.vocab_size, seq, bs, num_steps, seed)
    if ctx.data_cursor:
        # resume: the seeded dataset, past the batches already consumed
        batches = itertools.islice(batches, ctx.data_cursor, None)
    counts, times = [], []

    def logger(i):
        def cb(lf):
            if rank == 0:
                log(f"[fsdp] step {i:3d} loss {lf:.4f} collectives "
                    f"{json.dumps(C.COLLECTIVES.nonzero(counts[i - ctx.start_step]))}")
            if on_step is not None:
                on_step(i, lf)
        return cb

    pref = DevicePrefetcher(batches, device=dev, depth=rc.prefetch_depth)
    t0 = time.perf_counter()
    with pref, H.telemetry("fsdp", rc, ctx, dev, model=model, profiler=prof,
                           rules=rules, extra={"variant": variant,
                                  "reshard_after_forward":
                                  reshard_after_forward,
                                  "overlap": overlap,
                                  "state_precision": state_precision}
                           ) as telem:
        H.wire(telem, ctx, pref)
        with H.pump(rc, telem, tracker, ctx) as pump:
            for i, batch in zip(range(ctx.start_step, num_steps), pref):
                if ctx.should_stop(i):
                    break
                if verdict is None:
                    C.COLLECTIVES.reset()
                else:
                    verdict.begin()
                shards, opt, loss = step(shards, opt, batch)
                counts.append(C.COLLECTIVES.read() if verdict is None
                              else verdict.end(telem, ctx))
                synced = pump.emit(loss, tokens=bs * seq, log=logger(i))
                times.append(time.perf_counter() - t0)
                ctx.after_step(i, synced, lambda i=i: RunState(
                    params=shards, opt_state=opt, step=i, data_cursor=i + 1,
                    prng_key=key, loss_log=ctx.full_losses(pump.losses)))
        wall = time.perf_counter() - t0   # the pump drained: work done
        holder["losses"] = losses = ctx.full_losses(pump.losses)
        ctx.finalize(telem)
    # tokens/s over the steps after the first two, as run_leg counts
    n_timed, dt = ((len(times) - 2, times[-1] - times[1]) if len(times) > 2
                   else (len(times), times[-1] if times else 0.0))
    tok_s = n_timed * bs * seq / dt if dt > 0 else 0.0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if rank == 0:
        log(f"[fsdp] tokens/s {tok_s:.1f} (global, host clock) peak "
            f"memory " + (f"{peak / 2 ** 30:.2f} GiB a rank" if peak is not
                          None else "not measured (CPU)")
            + f"; Adam moments at rest {state_bytes} bytes a rank; host "
            f"syncs {pump.host_sync_count} {pump.sync_breakdown}")
        if telem.run_dir:
            log(f"[fsdp] telemetry in {telem.run_dir}")
    return {"model": model, "world_size": ws, "variant": variant,
            "overlap": overlap,
            "reshard_after_forward": reshard_after_forward,
            "accum_steps": accum_steps, "batch_size": bs,
            "sequence_length": seq, "precision": precision,
            "remat_policy": cfg.remat_policy,
            "quantized_gather": quantized_gather,
            "quantized_grads": quantized_grads,
            "state_precision": state_precision,
            "opt_state_bytes": state_bytes, "status": "completed",
            "start_step": ctx.start_step,
            "device": str(dev), "losses": losses, "collectives": counts,
            **(verdict.result() if verdict is not None else
               {"contract": None, "contract_ok": None}), "rules": rules,
            "step_times_s": times, "wall_s": wall,
            "tokens_per_second": tok_s,
            "tracker": pump.metrics, "host_syncs": dict(pump.sync_breakdown),
            "peak_memory_bytes": peak, "run_dir": telem.run_dir,
            "profiler": prof,
            **H.ckpt_report(holder),
            "model_flops_per_token": flops_tok}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY), default="tiny")
    p.add_argument("--variant", choices=VARIANTS, default="explicit",
                   help="auto: the gathers and grad reduce_scatters of "
                        "torch.distributed.fsdp.fully_shard")
    p.add_argument("--overlap", choices=fsdp.OVERLAP_MODES, default="none")
    p.add_argument("--no-reshard-after-forward", dest="reshard",
                   action="store_false", default=True)
    p.add_argument("--sequence-length", type=int, default=None,
                   help="default 256 for tiny, else 8192")
    p.add_argument("--attention", choices=["xla", "flash"], default=None)
    p.add_argument("--remat-policy", choices=T.REMAT_POLICIES, default=None)
    p.add_argument("--quantized-gather", action="store_true",
                   help="int8 codes and scales on the gathers' wire")
    p.add_argument("--quantized-grads", action="store_true",
                   help="the gathers' backward reduce-scatter in int8 too "
                        "(needs --quantized-gather)")
    p.add_argument("--state-precision", choices=fsdp.STATE_PRECISIONS,
                   default="full", help="int8: Adam moments int8 at rest")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo and "
                        "the plain path")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args, rest = p.parse_known_args(argv)
    batch_given = "--batch-size" in rest
    cfg = TrainConfig.from_args(rest)
    if cfg.offload != "none" or cfg.auto_fit or cfg.hbm_budget_gb:
        raise SystemExit("--offload, --auto-fit and --hbm-budget-gb: the "
                         "memory planner is not ported yet — see "
                         "ROADMAP.md queue A item A12")
    try:
        res = run(args.model, overlap=args.overlap,
                  reshard_after_forward=args.reshard,
                  accum_steps=cfg.accum_steps,
                  batch_size=cfg.batch_size if batch_given else None,
                  seq=args.sequence_length, num_steps=cfg.num_steps,
                  attention=args.attention, precision=cfg.precision,
                  device=args.device, seed=cfg.seed,
                  remat_policy=args.remat_policy,
                  quantized_gather=args.quantized_gather,
                  quantized_grads=args.quantized_grads,
                  state_precision=args.state_precision,
                  variant=args.variant, config=cfg)
        if args.out and mesh.axis_rank() == 0:
            Path(args.out).write_text(json.dumps(res, default=str))
        if mesh.axis_rank() == 0 and not all(np.isfinite(res["losses"])):
            raise SystemExit(f"non-finite loss in {res['losses']}")
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
