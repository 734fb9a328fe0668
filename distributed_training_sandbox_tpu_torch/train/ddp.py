"""Data-parallel training of the ZeRO toy MLP: the twin of the JAX
package's ``scripts/ddp.py`` (its MLP leg).

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

Not ported: the classification leg (``--model smollm3-350m|tiny``, which
needs ROADMAP.md queue A items A2 and A4), the supervisor and
checkpoints, telemetry, the profiler, the prefetcher and step pump (A8),
and the contract and rules verdicts (A12).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..models import mlp
from ..ops import collectives as C
from ..parallel import ddp, optim
from ..utils import mesh

LR = 1e-3
CLASSIFICATION_MODELS = ("smollm3-350m", "tiny")


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
        model: str = "mlp", on_step=None, log=print) -> dict:
    """Train ``num_steps`` DDP steps on this rank.  Joins (or makes) the
    process group (``utils.mesh.init_process_group``) and leaves it up.
    ``on_step(i, loss)`` is called once each step's loss has reached the
    host.  Returns the losses, each step's collectives and host-clock
    seconds (from the step's call until its loss reaches the host, as
    ``train.zero`` times its legs), the collectives of the init broadcast and of the sync check,
    the first batch's loss under the final params
    (``final_loss_batch0``) and peak device memory (None on the CPU)."""
    if model in CLASSIFICATION_MODELS:
        raise NotImplementedError(
            f"--model {model}: the classification leg is not ported yet — "
            "see ROADMAP.md, queue A items A2 (models/classifier.py) and A4 "
            "(data/classification.py)")
    if model != "mlp":
        raise ValueError(f"model={model!r}; choose from "
                         f"{('mlp',) + CLASSIFICATION_MODELS}")
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    width = mlp.ZERO_TOY_SIZES[0] // scale
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = mlp.zero_toy_mlp(gen, scale=scale, device=dev)
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
    step = ddp.make_ddp_train_step(
        mlp.mse_loss, lambda g, s, p: optim.sgd_update(g, s, p, lr=LR),
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
        log(f"[ddp] world={ws} width={width} leaves={n_leaves} "
            f"batch={batch_size} sync={sync} device={dev}")
        nz = C.COLLECTIVES.nonzero
        log(f"[ddp] param sync check passed (divergence {err}); init "
            f"broadcast {json.dumps(nz(init_counts))}, sync check "
            f"{json.dumps(nz(sync_counts))}")
    batches = randn_batches(width, batch_size, seed, dev)
    losses, counts, step_s = [], [], []
    for i, batch in zip(range(num_steps), batches):
        if i == 0:
            first = batch
        C.COLLECTIVES.reset()
        t = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))   # a host sync: the step has ended
        step_s.append(time.perf_counter() - t)
        counts.append(C.COLLECTIVES.read())
        if rank == 0:
            log(f"[ddp] step {i:3d} loss {losses[-1]:.6f} collectives "
                f"{json.dumps(C.COLLECTIVES.nonzero(counts[-1]))}")
        if on_step is not None:
            on_step(i, losses[-1])
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    # the first batch again under the final params: the losses of new
    # random batches move by their draw far more than SGD moves them
    with torch.no_grad():
        final0 = float(C.all_reduce(mlp.mse_loss(
            params, ddp.local_batch(first)), mean=True))
    if rank == 0:
        log(f"[ddp] step ms (host clock) "
            f"{[round(t * 1e3, 3) for t in step_s]}")
        log(f"[ddp] first batch's loss: step 0 {losses[0]:.6f}, under the "
            f"final params {final0:.6f}")
        log("[ddp] peak memory " + (f"{peak / 2 ** 30:.2f} GiB a rank"
                                    if peak is not None
                                    else "not measured (CPU)"))
    return {"world_size": ws, "scale": scale, "width": width,
            "n_leaves": n_leaves, "batch_size": batch_size,
            "bucket_mb": bucket_mb, "quantize_grads": quantize_grads,
            "error_feedback": error_feedback, "device": str(dev),
            "sync_error": err, "init_collectives": init_counts,
            "sync_check_collectives": sync_counts, "losses": losses,
            "collectives": counts, "step_s": step_s,
            "final_loss_batch0": final0, "peak_memory_bytes": peak}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="mlp",
                   choices=("mlp",) + CLASSIFICATION_MODELS)
    p.add_argument("--scale", type=int, default=20,
                   help="divide the 10k toy width by this")
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32,
                   help="the global batch")
    p.add_argument("--bucket-mb", type=float, default=None)
    p.add_argument("--quantize-grads", action="store_true")
    p.add_argument("--error-feedback", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args = p.parse_args(argv)
    try:
        res = run(scale=args.scale, num_steps=args.num_steps,
                  batch_size=args.batch_size, bucket_mb=args.bucket_mb,
                  quantize_grads=args.quantize_grads,
                  error_feedback=args.error_feedback, seed=args.seed,
                  device=args.device, model=args.model)
        if args.out and mesh.axis_rank() == 0:
            Path(args.out).write_text(json.dumps(res))
        if mesh.axis_rank() == 0 and not all(np.isfinite(res["losses"])):
            raise SystemExit(f"non-finite loss in {res['losses']}")
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
