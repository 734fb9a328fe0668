"""Data-parallel training: the twin of the JAX package's
``scripts/ddp.py``, its two legs (``--model``): the ZeRO toy MLP
(``mlp``, the default) and sentence-pair classification on a
transformer trunk (``smollm3-350m`` or ``tiny``).

    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.ddp --device cpu
    python -m distributed_training_sandbox_tpu_torch.train.ddp --scale 1

Each rank initialises the MLP from the seed at width 10 000 / ``--scale``,
broadcasts every param from rank 0 and checks that the ranks agree
(``params_sync_error`` must read exactly 0.0), then trains it with SGD at
lr 1e-3 on synthetic randn regression batches drawn from the seed (a new
global batch of ``--batch-size`` rows a step, each rank taking its
contiguous rows), syncing the grads one all_reduce a leaf, in flat
buckets (``--bucket-mb``) or as int8 buckets (``--quantize-grads``, with
``--error-feedback``).  Under ``torchrun`` the ranks come from its
environment; run alone, it is one rank.  NCCL and the card by default,
gloo with ``--device cpu``.  It prints the losses, the collectives a
step (the shim ``ops.collectives.COLLECTIVES``) and peak device memory.

The run harness (``train.harness``): the supervisor (``--checkpoint-dir``,
``--checkpoint-every``, ``--resume``, ``--max-restarts``,
``--inject-fault``), RunState checkpoints of the params, the SGD state,
the EF residual and the generators' seeds, a run directory
(``--results-dir``, default ``./runs``) with the manifest,
``steps.jsonl``, ``spans.jsonl`` and ``summary.json``, the profiler
(``--trace-dir``), the device prefetcher, and the step pump
(``--dispatch``, ``--sync-every``).  A resumed run rebuilds the seeded
batch stream and skips the batches it already consumed.

    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.ddp --device cpu \\
        --checkpoint-dir /tmp/ck --checkpoint-every 2 \\
        --inject-fault preempt@5 --max-restarts 1

The classification leg (``--model smollm3-350m|tiny``, ``--source
auto|synthetic``; ``mrpc`` needs a download and is refused): the
trunk and head of ``models.classifier`` from the seed, broadcast and
checked as above, trained with SGD at lr 1e-3 on the pairs of
``data.classification`` (2048 synthetic examples, each rank drawing its
rows from its contiguous shard, the global batch rank-major and padded
to one width, a multiple of 8), with the same grad syncs.  It prints
each step's padded width and collectives (one all_reduce a leaf, the
loss mean and the barrier) and the accuracy on the first batch under
the final params.  A resume skips the batches already consumed.

    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.ddp --device cpu \\
        --model tiny --source synthetic --num-steps 6

Not ported: the contract and rules verdicts (A12).
"""

from __future__ import annotations

import argparse
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..data import classification_batches, make_classification_examples
from ..models import MODEL_REGISTRY, mlp
from ..models import classifier as CL
from ..models import transformer as T
from ..ops import collectives as C
from ..parallel import ddp, optim
from ..resilience import RunState, generator_states
from ..runtime import DevicePrefetcher
from ..utils import mesh
from ..utils.config import TrainConfig
from ..utils.profiling import ProfileSchedule
from ..utils.tracker import PerformanceTracker
from . import harness as H

LR = 1e-3
CLASSIFICATION_MODELS = ("smollm3-350m", "tiny")
SOURCES = ("auto", "synthetic", "mrpc")
# the classification examples (the reference's default)
N_EXAMPLES = 2048


def randn_batches(width: int, batch_size: int, seed: int, device):
    """The global (x, y) regression batches, a new pair each step, from
    one generator seeded with ``seed + 1`` (the params draw from
    ``seed``)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    while True:
        yield (torch.randn(batch_size, width, generator=gen, device=device),
               torch.randn(batch_size, width, generator=gen, device=device))


def run(*, scale: int = 20, num_steps: int = 20, batch_size: int = 32,
        bucket_mb: float | None = None, quantize_grads: bool = False,
        error_feedback: bool = False, seed: int = 42, device=None,
        model: str = "mlp", source: str = "auto",
        config: TrainConfig | None = None, profile_schedule=None,
        on_step=None, log=print) -> dict:
    """Train ``num_steps`` DDP steps on this rank under the supervisor.
    Joins (or makes) the process group (``utils.mesh.init_process_group``)
    and leaves it up.  ``config`` holds the harness's options
    (``train.harness.quiet_config`` when None: nothing written, a host
    sync every step).  ``on_step(i, loss)`` is called once each step's
    loss has reached the host.  Returns the losses (stitched across
    restarts), ``status``, each step's collectives and host-clock seconds
    of this segment (from the step's call until the pump returns; with
    ``dispatch="sync"`` the loss has then reached the host), the
    collectives of the init broadcast and of the sync check, the first
    batch's loss under the final params (``final_loss_batch0``), peak
    device memory (None on the CPU), the pump's host syncs and the
    checkpoint saves (``ckpt_saves``: bytes, blocking and write seconds)
    and restore seconds.  The classification leg (``model`` one of
    ``CLASSIFICATION_MODELS``, ``source`` its examples) returns the same
    keys, with each step's padded width (``widths``) and the first
    batch's accuracy under the final params (``accuracy_batch0``) in
    place of the MLP's ``final_loss_batch0``."""
    if model not in ("mlp",) + CLASSIFICATION_MODELS:
        raise ValueError(f"model={model!r}; choose from "
                         f"{('mlp',) + CLASSIFICATION_MODELS}")
    if source not in SOURCES:
        raise ValueError(f"source={source!r}; choose from {SOURCES}")
    cfg = H.run_config(config, num_steps=num_steps, batch_size=batch_size,
                       seed=seed)
    fp = {"bucket_mb": bucket_mb, "quantize_grads": quantize_grads,
          "error_feedback": error_feedback}
    fp.update({"scale": scale} if model == "mlp"
              else {"model": model, "source": source})
    # the examples before the process group: a refused source raises here
    examples = None if model == "mlp" else make_classification_examples(
        getattr(T, MODEL_REGISTRY[model]).vocab_size, n_examples=N_EXAMPLES,
        seed=cfg.seed, source=source)
    return H.supervise(cfg, "ddp", lambda ctx, holder: _run(
        ctx, holder, cfg, model=model, examples=examples, scale=scale,
        bucket_mb=bucket_mb, quantize_grads=quantize_grads,
        error_feedback=error_feedback, device=device,
        profile_schedule=profile_schedule, on_step=on_step, log=log),
        extra_fingerprint=fp)


def _mlp_payload(scale, batch_size, seed, dev) -> dict:
    """The MLP leg: params, loss, the seeded randn stream (device
    tensors), what a step logs."""
    width = mlp.ZERO_TOY_SIZES[0] // scale
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"params": mlp.zero_toy_mlp(gen, scale=scale, device=dev),
            "loss": mlp.mse_loss,
            "stream": lambda: randn_batches(width, batch_size, seed, dev),
            "tokens": lambda batch: batch_size,
            "describe": f"width={width}", "width": width}


def cls_batches(examples, batch_size: int, ws: int, seed: int, epochs: int):
    """The classification leg's global batches as host tensors
    ``(input_ids, attention_mask, labels)``, int32, from
    ``data.classification_batches``."""
    for b in classification_batches(examples, batch_size, ws, seed=seed,
                                     epochs=epochs):
        yield tuple(torch.from_numpy(b[k]) for k in
                    ("input_ids", "attention_mask", "labels"))


def _cls_payload(model, examples, num_steps, batch_size, num_epochs, seed,
                 ws, dev) -> dict:
    """The classification leg: the classifier from the seed, its loss on
    a ``(input_ids, attention_mask, labels)`` tuple, the batch stream of
    ``examples``."""
    if batch_size % ws:
        raise SystemExit(f"--batch-size {batch_size} must be divisible by "
                         f"the world size {ws}")
    mcfg = getattr(T, MODEL_REGISTRY[model])
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = CL.init_classifier_params(mcfg, gen, dev)
    epochs = max(num_epochs, 1 + num_steps * batch_size
                 // max(len(examples), 1))

    def loss(p, batch):
        ids, mask, labels = batch
        return CL.classification_loss(p, {"input_ids": ids,
                                           "attention_mask": mask,
                                           "labels": labels}, mcfg)
    return {"params": params, "loss": loss, "cfg": mcfg,
            "stream": lambda: cls_batches(examples, batch_size, ws, seed,
                                          epochs),
            "tokens": lambda batch: int(batch[0].numel()),
            "describe": (f"model={model} ({mcfg.param_count() / 1e9:.3f}B) "
                         f"examples={len(examples)}")}


def _run(ctx, holder, cfg, *, model, examples, scale, bucket_mb,
         quantize_grads, error_feedback, device, profile_schedule, on_step,
         log) -> dict:
    num_steps, batch_size, seed = cfg.num_steps, cfg.batch_size, cfg.seed
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    leg = (_mlp_payload(scale, batch_size, seed, dev) if model == "mlp" else
           _cls_payload(model, examples, num_steps, batch_size,
                        cfg.num_epochs, seed, ws, dev))
    params = leg["params"]
    n_leaves = len(list(optim.tree_leaves(params)))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    C.COLLECTIVES.reset()
    params = ddp.broadcast_params(params)
    init_counts = C.COLLECTIVES.read()
    C.COLLECTIVES.reset()
    err = float(ddp.params_sync_error(params))
    sync_counts = C.COLLECTIVES.read()
    if err != 0.0:
        raise RuntimeError(f"params diverged across replicas: {err}")
    opt = optim.sgd_init(params)
    if quantize_grads and error_feedback:
        opt = (opt, ddp.init_grad_residual(params))
    key = generator_states({"params": seed, "data": seed + 1}, dev)
    H.track(holder, ctx)
    rs = ctx.restore(RunState(params=params, opt_state=opt, prng_key=key))
    if rs is not None:
        params, opt = rs.params, rs.opt_state
    step = ddp.make_ddp_train_step(
        leg["loss"], lambda g, s, p: optim.sgd_update(g, s, p, lr=LR),
        bucket_mb=bucket_mb, quantize_grads=quantize_grads,
        error_feedback=error_feedback)
    if quantize_grads:
        sync = (f"int8 q8 buckets of "
                f"{bucket_mb or ddp.DEFAULT_Q8_BUCKET_MB} MB"
                + (", EF residual" if error_feedback else ""))
    elif bucket_mb:
        sync = f"{bucket_mb} MB flat buckets"
    else:
        sync = f"{n_leaves} per-leaf all_reduces"
    if rank == 0:
        log(f"[ddp] world={ws} {leg['describe']} leaves={n_leaves} "
            f"batch={batch_size} sync={sync} dispatch={cfg.dispatch} "
            f"device={dev}")
        nz = C.COLLECTIVES.nonzero
        log(f"[ddp] param sync check passed (divergence {err}); init "
            f"broadcast {json.dumps(nz(init_counts))}, sync check "
            f"{json.dumps(nz(sync_counts))}")
    first = next(leg["stream"]())
    stream = leg["stream"]()
    if ctx.data_cursor:
        # resume: the seeded stream, past the batches already consumed
        stream = itertools.islice(stream, ctx.data_cursor, None)
    tracker = PerformanceTracker(
        warmup_steps=min(5, num_steps - 1) if num_steps > 1 else 0,
        num_devices=ws, device=dev)
    prof = H.profiler(cfg, profile_schedule, ProfileSchedule(
        skip_first=5, wait=1, warmup=2, active=5))
    counts, step_s, widths = [], [], []

    def logger(i):
        pad = f" (padded width {widths[-1]})" if widths else ""
        n = json.dumps(C.COLLECTIVES.nonzero(counts[-1]))

        def cb(lf):
            if rank == 0:
                log(f"[ddp] step {i:3d} loss {lf:.6f}{pad} collectives {n}")
            if on_step is not None:
                on_step(i, lf)
        return cb

    pref = DevicePrefetcher(stream, device=dev, depth=cfg.prefetch_depth)
    with pref, H.telemetry("ddp", cfg, ctx, dev, model=model,
                           profiler=prof) as telem:
        H.wire(telem, ctx, pref)
        with H.pump(cfg, telem, tracker, ctx) as pump:
            for i, batch in zip(range(ctx.start_step, num_steps), pref):
                if ctx.should_stop(i):
                    break
                C.COLLECTIVES.reset()
                t = time.perf_counter()
                params, opt, loss = step(params, opt, batch)
                counts.append(C.COLLECTIVES.read())
                if model != "mlp":
                    widths.append(int(batch[0].shape[1]))
                synced = pump.emit(loss, tokens=leg["tokens"](batch),
                                   log=logger(i))
                step_s.append(time.perf_counter() - t)
                ctx.after_step(i, synced, lambda i=i: RunState(
                    params=params, opt_state=opt, step=i, data_cursor=i + 1,
                    prng_key=key, loss_log=ctx.full_losses(pump.losses)))
        holder["losses"] = losses = ctx.full_losses(pump.losses)
        ctx.finalize(telem)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    # the first batch again under the final params: the losses of new
    # random batches move by their draw far more than SGD moves them
    first = tuple(t.to(dev) for t in first)
    with torch.no_grad():
        if model == "mlp":
            final = {"final_loss_batch0": float(C.all_reduce(mlp.mse_loss(
                params, ddp.local_batch(first)), mean=True))}
            said = (f"first batch's loss: step 0 {losses[0]:.6f}, under the "
                    f"final params {final['final_loss_batch0']:.6f}")
        else:
            ids, mask, labels = ddp.local_batch(first)
            acc = CL.classification_accuracy(params, {
                "input_ids": ids, "attention_mask": mask, "labels": labels},
                leg["cfg"])
            final = {"accuracy_batch0": float(C.all_reduce(acc, mean=True)),
                     "widths": widths}
            said = (f"train-batch acc {final['accuracy_batch0']:.3f} (the "
                    f"first batch under the final params); padded widths "
                    f"{sorted(set(widths))}")
    if rank == 0:
        log(f"[ddp] step ms (host clock) "
            f"{[round(t * 1e3, 3) for t in step_s]}; host syncs "
            f"{pump.host_sync_count} {pump.sync_breakdown}")
        log(f"[ddp] {said}")
        log("[ddp] peak memory " + (f"{peak / 2 ** 30:.2f} GiB a rank"
                                    if peak is not None
                                    else "not measured (CPU)"))
        if telem.run_dir:
            log(f"[ddp] telemetry in {telem.run_dir}")
    return {"world_size": ws, "model": model, "scale": scale,
            "width": leg.get("width"), "n_leaves": n_leaves,
            "batch_size": batch_size,
            "bucket_mb": bucket_mb, "quantize_grads": quantize_grads,
            "error_feedback": error_feedback, "device": str(dev),
            "sync_error": err, "init_collectives": init_counts,
            "sync_check_collectives": sync_counts, "losses": losses,
            "status": "completed", "start_step": ctx.start_step,
            "collectives": counts, "step_s": step_s, **final,
            "peak_memory_bytes": peak,
            "params": params, "host_syncs": dict(pump.sync_breakdown),
            "tracker": pump.metrics, "run_dir": telem.run_dir,
            **H.ckpt_report(holder)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--model", default="mlp",
                   choices=("mlp",) + CLASSIFICATION_MODELS)
    p.add_argument("--source", default="auto", choices=SOURCES,
                   help="the classification leg's examples")
    p.add_argument("--scale", type=int, default=20,
                   help="divide the 10k toy width by this")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args, rest = p.parse_known_args(argv)
    cfg = TrainConfig.from_args(rest, batch_size=32)
    try:
        res = run(scale=args.scale, num_steps=cfg.num_steps,
                  batch_size=cfg.batch_size, bucket_mb=cfg.bucket_mb,
                  quantize_grads=cfg.quantize_grads,
                  error_feedback=cfg.error_feedback, seed=cfg.seed,
                  device=args.device, model=args.model,
                  source=args.source, config=cfg)
        res.pop("params", None)
        if args.out and mesh.axis_rank() == 0:
            Path(args.out).write_text(json.dumps(res, default=str))
        if mesh.axis_rank() == 0 and not all(np.isfinite(res["losses"])):
            raise SystemExit(f"non-finite loss in {res['losses']}")
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
