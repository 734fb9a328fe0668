"""Low-precision throughput benchmark: the twin of the JAX package's
``scripts/precision_benchmark.py``.  Train the LM fully sharded
(``parallel.fsdp``) at one projection precision and sequence length,
track steps/s, tokens/s, TFLOP/s a device and memory, and write a
per-run ``.txt`` log and a ``summary_*.json`` with the reference's keys.

    python -m distributed_training_sandbox_tpu_torch.train.precision_benchmark \\
        --precision int8_pallas_bwd --sequence-length 4096
    python -m distributed_training_sandbox_tpu_torch.train.precision_benchmark \\
        --sweep [--batch-sweep]
    python -m distributed_training_sandbox_tpu_torch.train.precision_benchmark \\
        --device cpu --model tiny --num-steps 2

The model registry is the port's (``models.MODEL_REGISTRY``); the
default model is ``smollm3-3b-l8`` on the card and ``tiny`` on the CPU.
Attention is ``flash`` on the card and ``xla`` on the CPU, as the
reference picks by backend.  The precisions are ``ops.quant``'s: on the
card ``fp8_pallas`` runs K6, ``int8_pallas`` K5, the ``_bwd`` names K4
in the backward.  ``--sweep`` runs ``SWEEP_SEQS`` × ``SWEEP_PRECISIONS``;
``--batch-sweep`` crosses each cell with batch 1, 2, 4 and 8 and stops
the doubling at the first ``torch.cuda.OutOfMemoryError``, recording
that edge.  Under ``torchrun`` the ranks share one process group, as
the reference's mesh spans every device.

``peak_memory.memory_plan_gb`` holds the allocator's measured peak on
the card (``plan_formula`` says so); the reference fills it with XLA's
compile-time plan, which has no PyTorch counterpart.  Results go under
``build/precision/`` by default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from ..data import make_packed_dataset
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..parallel import fsdp, optim8
from ..utils import mesh
from ..utils.memory import MB, tree_size_bytes
from ..utils.prng import set_seed

SWEEP_SEQS = (2048, 4096, 8192)
SWEEP_PRECISIONS = ("bf16", "int8", "int8_bwd", "fp8", "fp8_delayed",
                    "fp8_pallas")
SWEEP_BATCHES = (1, 2, 4, 8)
PRECISIONS = T.PRECISIONS


def row_inputs(model: str, precision: str, seq_len: int,
               batch_size: int | None, dev: torch.device):
    """``(config, shards, batch)`` of one row on ``dev`` in the process
    group: the model at ``precision`` (flash attention on the card),
    its seeded FSDP shards and the global batch of ``batch_size`` rows
    (default: one a rank)."""
    mcfg = dataclasses.replace(
        getattr(T, MODEL_REGISTRY[model]), matmul_precision=precision,
        attention_impl="flash" if dev.type == "cuda" else "xla")
    bs = batch_size or mesh.axis_size()
    gen = set_seed(42, dev)
    shards = fsdp.shard_params_fsdp(T.init_params(mcfg, gen, dev))
    ii, ll = make_packed_dataset(seq_len, mcfg.vocab_size,
                                 num_tokens=max(bs * 4, 8) * (seq_len + 1))
    batch = (torch.as_tensor(ii[:bs], device=dev),
             torch.as_tensor(ll[:bs], device=dev))
    return mcfg, shards, batch


def run_one(model: str, precision: str, seq_len: int, num_steps: int,
            batch_size: int | None, out_dir: Path, *, device=None,
            log=print, on_step=None) -> dict:
    """Train ``num_steps`` FSDP steps of ``model`` at ``precision`` on
    :func:`row_inputs` and return the reference's result row; the run's
    log goes to ``out_dir/<tag>.txt``.  ``on_step(i, loss)`` sees each
    step's loss."""
    dev = mesh.init_process_group(device)
    on_card = dev.type == "cuda"
    ws = mesh.axis_size()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    mcfg, shards, batch = row_inputs(model, precision, seq_len, batch_size,
                                     dev)
    bs = batch[0].shape[0]
    opt = fsdp.init_fsdp_opt_state(shards)
    step = fsdp.make_fsdp_train_step(shards, mcfg)
    flops_tok = T.model_flops_per_token(mcfg, seq_len)
    # the reference's tracker: the clock restarts after the warm-up
    # steps, the rates and the mean loss cover the steps after them
    warmup = min(3, num_steps - 1)
    log_lines, losses, t0 = [], [], None
    for i in range(num_steps):
        shards, opt, loss = step(shards, opt, batch)
        loss = float(loss)   # a host sync: the step has ended
        log_lines.append(f"step {i} loss {loss:.4f}")
        if on_step is not None:
            on_step(i, loss)
        if i + 1 == warmup:
            t0 = time.perf_counter()
        elif i + 1 > warmup:
            losses.append(loss)
    if t0 is None:
        t0 = time.perf_counter()
    elapsed = max(time.perf_counter() - t0, 1e-9)
    timed = len(losses)
    tok_s = timed * bs * seq_len / elapsed
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    mem = {"model_mb": tree_size_bytes(shards) / MB,
           "optimizer_mb": optim8.state_bytes(opt) / MB}
    log_lines.append(
        f"[memory:{model}-{precision}-{seq_len}] "
        + " | ".join(f"{k}={v:,.1f}" for k, v in mem.items())
        + (f" | device_peak_mb={peak / MB:,.1f}" if peak is not None
           else " | device_peak_mb=not measured (CPU)"))
    result = {
        "model": model,
        "precision": precision,
        "sequence_length": seq_len,
        "num_devices": ws,
        "batch_size": bs,
        "steps_per_second": timed / elapsed,
        "tokens_per_second": tok_s,
        "tflops_per_device": tok_s * flops_tok / ws / 1e12,
        "avg_loss": sum(losses) / timed if timed else None,
        "peak_memory": {
            "memory_plan_gb": (round(peak / 2 ** 30, 2) if peak is not None
                               else None),
            "plan_formula": ("allocator peak (torch.cuda."
                             "max_memory_allocated)" if peak is not None
                             else "not measured (CPU)"),
            "model_mb": mem["model_mb"],
            "optimizer_mb": mem["optimizer_mb"],
        },
    }
    tag = f"{model}_{precision}_seq{seq_len}_b{bs}_dev{ws}"
    if mesh.axis_rank() == 0:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{tag}.txt").write_text("\n".join(log_lines) + "\n")
        log(f"[precision] {tag}: {result['tokens_per_second']:.0f} tok/s "
            f"{result['tflops_per_device']:.2f} TFLOPS/dev")
    return result


def _failure(e: Exception) -> tuple[str, str]:
    """``(kind, message)``: ``"oom"`` for the allocator's out-of-memory
    error, else ``"error"``."""
    kind = "oom" if isinstance(e, torch.cuda.OutOfMemoryError) else "error"
    return kind, f"{type(e).__name__}: {e}"


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY), default=None,
                   help="default: smollm3-3b-l8 on the card, tiny on the CPU")
    p.add_argument("--precision", choices=PRECISIONS, default="bf16")
    p.add_argument("--sequence-length", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-steps", type=int, default=12)
    p.add_argument("--sweep", action="store_true",
                   help="the seq x precision grid")
    p.add_argument("--batch-sweep", action="store_true",
                   help="cross each cell with batch 1/2/4/8, stop doubling "
                        "at the OOM edge and record it")
    p.add_argument("--out-dir", type=str, default="build/precision")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo and "
                        "the plain path")
    args = p.parse_args(argv)
    on_card = args.device in (None, "cuda") or str(args.device).startswith(
        "cuda")
    model = args.model or ("smollm3-3b-l8" if on_card else "tiny")
    out_dir = Path(args.out_dir)
    if args.sweep:
        grid = [(s, pr) for s in SWEEP_SEQS for pr in SWEEP_PRECISIONS]
    else:
        default_seq = 256 if model == "tiny" else 4096
        grid = [(args.sequence_length or default_seq, args.precision)]
    stamp = time.strftime("%Y%m%d-%H%M%S")
    summary = out_dir / f"summary_{model}_{stamp}.json"
    mesh.init_process_group(args.device)
    rank, results = mesh.axis_rank(), []

    def write_summary():
        if rank == 0:
            out_dir.mkdir(parents=True, exist_ok=True)
            summary.write_text(json.dumps(results, indent=2))

    try:
        for seq, precision in grid:
            for bs in (SWEEP_BATCHES if args.batch_sweep
                       else (args.batch_size,)):
                try:
                    results.append(run_one(model, precision, seq,
                                           args.num_steps, bs, out_dir,
                                           device=args.device))
                except Exception as e:   # a row records the failure
                    kind, msg = _failure(e)
                    results.append({
                        "model": model, "precision": precision,
                        "sequence_length": seq, "batch_size": bs,
                        "num_devices": mesh.axis_size(),
                        "failure": kind, "error": msg})
                    print(f"[precision] {model}/{precision}/seq{seq}/b{bs} "
                          f"{kind.upper()}: {msg[:120]}")
                    if on_card:
                        torch.cuda.empty_cache()
                    if kind == "oom":
                        break   # the edge: larger batches only OOM harder
                write_summary()   # after every cell
    finally:
        mesh.destroy_process_group()
    write_summary()
    if rank == 0:
        print(f"[precision] summary -> {summary}")
    return results


if __name__ == "__main__":
    main()
