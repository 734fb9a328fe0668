"""One-card flagship training: the twin of the JAX package's
``scripts/train_flagship.py`` (``run_leg``).

    python -m distributed_training_sandbox_tpu_torch.train.flagship \
        --num-steps 20 --warmup-steps 5

Runs ``smollm3-3b-l8`` (SmolLM3-3B width, 8 layers) on the card with
AdamW under warmup-cosine, on fresh synthetic Zipfian windows, through
``parallel.fsdp.make_fsdp_train_step`` at one rank; on the card the
attention is the flash kernel, ``fp8_pallas`` the fp8 kernel (K6) and
the int8 precisions the int8 kernels (K5 forward under
``int8_pallas``, K4 for the other int8 products), as the reference
selects its TPU kernels.  ``--precision`` takes every name of
``models.transformer.PRECISIONS``.  The data comes from the numpy
engine (the reference script uses its native engine, whose stream
differs).  Not ported: checkpointing and resume, ``--plan``,
``--spike-demo``, corpus data and the loss plot (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..data import make_packed_dataset, packed_batches
from ..device import resolve_device
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..parallel import fsdp, optim


def leg_batches(vocab_size: int, seq: int, bs: int, num_steps: int,
                seed: int):
    """The numpy (input, label) batches of ``run_leg``, in order: packed
    windows of a synthetic stream long enough for ``num_steps``."""
    n_tokens = num_steps * bs * (seq + 1) + seq + 1
    ii, ll = make_packed_dataset(seq, vocab_size, num_tokens=n_tokens,
                                 seed=seed, source="synthetic")
    return packed_batches(ii, ll, bs)


def run_leg(model: str, precision: str, seq: int, bs: int, num_steps: int,
            warmup_steps: int, peak_lr: float, *, seed: int = 42,
            device=None, on_step=None) -> dict:
    """Train ``num_steps`` steps; returns the reference's result keys
    (``losses``, ``lrs``, ``tokens_per_second``, ``loss_first``,
    ``loss_max_first20``, ``loss_final_mean20``) and the run's shape.
    ``on_step(i, loss)`` is called after each step's loss has reached
    the host."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        getattr(T, MODEL_REGISTRY[model]), matmul_precision=precision,
        attention_impl="flash" if dev.type == "cuda" else "xla")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen, dev)
    opt = fsdp.init_fsdp_opt_state(params)
    sched = (optim.warmup_cosine_schedule(peak_lr, warmup_steps, num_steps)
             if warmup_steps else None)
    step = fsdp.make_fsdp_train_step(params, cfg, lr=peak_lr,
                                     lr_schedule=sched)
    losses, lrs, times = [], [], []
    t0 = time.perf_counter()
    for i, (ib, lb) in enumerate(leg_batches(cfg.vocab_size, seq, bs,
                                             num_steps, seed)):
        if i >= num_steps:
            break
        batch = (torch.as_tensor(ib, device=dev),
                 torch.as_tensor(lb, device=dev))
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))   # a host sync: the step has ended
        lrs.append(sched(i) if sched else peak_lr)
        times.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(i, losses[-1])
    # tokens/s over the steps after the first two (the reference's
    # window: compile there, kernel builds and allocator warm-up here).
    # The reference counts len - 1 steps' tokens over that window of
    # len - 2 steps; this counts len - 2.
    n_timed, dt = ((len(times) - 2, times[-1] - times[1]) if len(times) > 2
                   else (len(times), times[-1] if times else 0.0))
    tok_s = n_timed * bs * seq / dt if dt > 0 else 0.0
    return {
        "model": model, "precision": precision, "sequence_length": seq,
        "batch_size": bs, "num_steps": len(losses),
        "warmup_steps": warmup_steps, "peak_lr": peak_lr,
        "device": str(dev), "tokens_per_second": tok_s,
        "loss_first": losses[0], "loss_max_first20": max(losses[:20]),
        "loss_final_mean20": float(np.mean(losses[-20:])),
        "losses": losses, "lrs": lrs, "step_times_s": times,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY),
                   default="smollm3-3b-l8")
    p.add_argument("--precision", default="fp8_pallas",
                   choices=list(T.PRECISIONS))
    p.add_argument("--sequence-length", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-steps", type=int, default=500)
    p.add_argument("--warmup-steps", type=int, default=50)
    p.add_argument("--peak-lr", type=float, default=3e-4)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' for the plain path")
    p.add_argument("--out", default=None, help="write the result as JSON")
    args = p.parse_args(argv)
    result = run_leg(
        args.model, args.precision, args.sequence_length, args.batch_size,
        args.num_steps, args.warmup_steps, args.peak_lr, device=args.device,
        on_step=lambda i, loss: print(f"[flagship] step {i:4d} loss "
                                      f"{loss:8.4f}", flush=True))
    print(f"[flagship] first {result['loss_first']:.3f} max(first20) "
          f"{result['loss_max_first20']:.3f} final(mean20) "
          f"{result['loss_final_mean20']:.3f} "
          f"{result['tokens_per_second']:.0f} tok/s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result))


if __name__ == "__main__":
    main()
