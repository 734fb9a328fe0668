"""Fully-sharded training of the transformer LM: the twin of the JAX
package's ``scripts/train_fsdp.py`` (its explicit variant).

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

Not ported (ROADMAP.md): the memory planner (``--hbm-budget-gb``,
``--auto-fit``, the predicted waterline), ``--offload``, telemetry and
the run manifest, collective contracts and the sharding-rules verdict,
checkpoint and resume, the auto variant, profiling flags, and the
device prefetcher and step pump.
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
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..ops import collectives as C
from ..parallel import fsdp, optim8
from ..utils import mesh

PRECISIONS = ("bf16", "fp32", "int8", "int8_pallas", "int8_bwd",
              "int8_pallas_bwd")


def model_config(model: str, precision: str = "bf16",
                 attention: str | None = None,
                 remat_policy: str | None = None) -> T.TransformerConfig:
    """The run's config: int8 names set the projections' precision,
    ``fp32`` the dtype, as the reference script reads ``--precision``."""
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
        remat_policy: str | None = None, quantized_gather: bool = False,
        quantized_grads: bool = False, state_precision: str = "full",
        on_step=None, log=print) -> dict:
    """Train ``num_steps`` FSDP steps on this rank.  Joins (or makes)
    the process group (``utils.mesh.init_process_group``) and leaves it
    up.  ``on_step(i, loss)`` is called once each step's loss has
    reached the host.  ``quantized_gather``, ``quantized_grads`` and
    ``state_precision`` are the reference step's options.  Returns the
    losses, each step's collective counts and host-clock time, tokens/s,
    peak device memory (None on the CPU) and the Adam moments' bytes at
    rest on this rank."""
    dev = mesh.init_process_group(device)
    ws, rank = mesh.axis_size(), mesh.axis_rank()
    cfg = model_config(model, precision, attention, remat_policy)
    seq = seq or (256 if model == "tiny" else 8192)
    bs = batch_size or ws
    if bs % ws:
        raise ValueError(f"batch size {bs} must be divisible by the "
                         f"{ws} ranks")
    if (bs // ws) % accum_steps:
        raise ValueError(f"accum_steps={accum_steps} must divide the "
                         f"per-rank batch {bs // ws}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    shards = fsdp.shard_params_fsdp(T.init_params(cfg, gen, dev))
    opt = (fsdp.init_fsdp_opt_state8(shards) if state_precision == "int8"
           else fsdp.init_fsdp_opt_state(shards))
    step = fsdp.make_fsdp_train_step(
        shards, cfg, reshard_after_forward=reshard_after_forward,
        overlap=overlap, accum_steps=accum_steps,
        quantized_gather=quantized_gather, quantized_grads=quantized_grads,
        state_precision=state_precision)
    state_bytes = optim8.state_bytes(opt)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if rank == 0:
        log(f"[fsdp] model={model} world={ws} overlap={overlap} "
            f"reshard_after_forward={reshard_after_forward} "
            f"accum_steps={accum_steps} batch={bs} seq={seq} "
            f"precision={precision} attention={cfg.attention_impl} "
            f"remat_policy={cfg.remat_policy} "
            f"quantized_gather={quantized_gather} "
            f"quantized_grads={quantized_grads} "
            f"state_precision={state_precision} device={dev}")
    losses, counts, times = [], [], []
    t0 = time.perf_counter()
    batches = fsdp_batches(cfg.vocab_size, seq, bs, num_steps, seed)
    for i, (ib, lb) in zip(range(num_steps), batches):
        batch = (torch.as_tensor(ib, device=dev),
                 torch.as_tensor(lb, device=dev))
        C.COLLECTIVES.reset()
        shards, opt, loss = step(shards, opt, batch)
        losses.append(float(loss))   # a host sync: the step has ended
        counts.append(C.COLLECTIVES.read())
        times.append(time.perf_counter() - t0)
        if rank == 0:
            log(f"[fsdp] step {i:3d} loss {losses[-1]:.4f} collectives "
                f"{json.dumps(C.COLLECTIVES.nonzero(counts[-1]))}")
        if on_step is not None:
            on_step(i, losses[-1])
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
            + f"; Adam moments at rest {state_bytes} bytes a rank")
    return {"model": model, "world_size": ws, "overlap": overlap,
            "reshard_after_forward": reshard_after_forward,
            "accum_steps": accum_steps, "batch_size": bs,
            "sequence_length": seq, "precision": precision,
            "remat_policy": cfg.remat_policy,
            "quantized_gather": quantized_gather,
            "quantized_grads": quantized_grads,
            "state_precision": state_precision,
            "opt_state_bytes": state_bytes,
            "device": str(dev), "losses": losses, "collectives": counts,
            "step_times_s": times, "tokens_per_second": tok_s,
            "peak_memory_bytes": peak,
            "model_flops_per_token": T.model_flops_per_token(cfg, seq)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY), default="tiny")
    p.add_argument("--overlap", choices=fsdp.OVERLAP_MODES, default="none")
    p.add_argument("--no-reshard-after-forward", dest="reshard",
                   action="store_false", default=True)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (default: one row a rank)")
    p.add_argument("--sequence-length", type=int, default=None,
                   help="default 256 for tiny, else 8192")
    p.add_argument("--num-steps", type=int, default=20)
    p.add_argument("--attention", choices=["xla", "flash"], default=None)
    p.add_argument("--precision", choices=PRECISIONS, default="bf16")
    p.add_argument("--remat-policy", choices=T.REMAT_POLICIES, default=None)
    p.add_argument("--quantized-gather", action="store_true",
                   help="int8 codes and scales on the gathers' wire")
    p.add_argument("--quantized-grads", action="store_true",
                   help="the gathers' backward reduce-scatter in int8 too "
                        "(needs --quantized-gather)")
    p.add_argument("--state-precision", choices=fsdp.STATE_PRECISIONS,
                   default="full", help="int8: Adam moments int8 at rest")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo and "
                        "the plain path")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args = p.parse_args(argv)
    try:
        res = run(args.model, overlap=args.overlap,
                  reshard_after_forward=args.reshard,
                  accum_steps=args.accum_steps, batch_size=args.batch_size,
                  seq=args.sequence_length, num_steps=args.num_steps,
                  attention=args.attention, precision=args.precision,
                  device=args.device, seed=args.seed,
                  remat_policy=args.remat_policy,
                  quantized_gather=args.quantized_gather,
                  quantized_grads=args.quantized_grads,
                  state_precision=args.state_precision)
        if args.out and mesh.axis_rank() == 0:
            Path(args.out).write_text(json.dumps(res))
        if mesh.axis_rank() == 0 and not all(np.isfinite(res["losses"])):
            raise SystemExit(f"non-finite loss in {res['losses']}")
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
