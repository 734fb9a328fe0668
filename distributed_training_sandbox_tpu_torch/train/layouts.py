"""The two- and three-axis layouts the twins have no flag for, through
the library: FSDP × SP with the zigzag ring, dp × sp × tp and the dp ×
sp × ep MoE step.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.layouts \\
        --layout zigzag --sp 4 --model smollm3-3b-l8 --sequence-length 32768
    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.layouts \\
        --layout dp_sp_tp --sp 2 --tp 2 --model smollm3-3b-l8
    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.layouts \\
        --layout dp_sp_ep --sp 2 --ep 2 --model smollm3-3b-l8 --experts 8
    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.layouts \\
        --device cpu --layout zigzag --sp 2 --num-steps 2

The reference's driver (``scripts/_2d_driver.py``) reaches these only
through its library (``parallel.sequence.sp_config(layout="zigzag")``,
``tensor.make_tp_train_step(sp_axis=...)``,
``expert.make_moe_lm_train_step(sp_axis=...)``), and so does this
script: the ranks form the reference mesh's grid (``utils.mesh.grid_axes``,
dp the ranks left over), each rank initialises the model from the seed
and keeps its shards, and a global batch of the synthetic stream (one
row a dp rank by default; zigzag-shuffled for the zigzag layout) goes
through ``--num-steps`` steps, each ending in a sync.  Rank 0 prints the
losses, the collectives a step and the first step's contract verdict
(``analysis.contracts``), step ms (the median after the first),
tokens/s, MFU (``utils.flops``) and peak memory a rank.  NCCL and the
card by default, gloo and the plain paths with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch

from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..ops import collectives as C
from ..analysis.contracts import evaluate_contract
from ..parallel import expert, fsdp, optim, sequence, tensor
from ..utils import mesh
from ..utils.flops import PEAK_BF16_FLOPS
from .moe import model_config as moe_config
from .train_fsdp import fsdp_batches, model_config

LAYOUTS = ("zigzag", "dp_sp_tp", "dp_sp_ep")


def run(layout: str, model: str = "tiny", *, sp: int = 2, tp: int = 1,
        ep: int = 1, experts: int = 8, precision: str = "bf16",
        attention: str | None = None, batch_size: int | None = None,
        seq: int | None = None, num_steps: int = 4, device=None,
        seed: int = 42, log=print) -> dict:
    """``num_steps`` steps of ``layout`` on this rank (joins or makes the
    process group and leaves it up).  Returns the losses, the host
    seconds and collectives of each step, the contract, tokens/s, MFU
    and peak memory (None on the CPU)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}; choose from {LAYOUTS}")
    dev = mesh.init_process_group(device)
    ws = mesh.axis_size()
    seq = seq or (256 if model == "tiny" else 8192)
    second = {"zigzag": 1, "dp_sp_tp": tp, "dp_sp_ep": ep}[layout]
    if ws % (sp * second):
        raise ValueError(f"sp={sp} x {second} must divide the {ws} ranks")
    dp = ws // (sp * second)
    bs = batch_size or dp * (second if layout == "dp_sp_ep" else 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batches = ((torch.as_tensor(i, device=dev),
                torch.as_tensor(lb, device=dev))
               for i, lb in fsdp_batches(
                   getattr(T, MODEL_REGISTRY[model]).vocab_size, seq, bs,
                   num_steps, seed))
    if layout == "zigzag":
        axes = mesh.grid_axes(("dp", "sp"), (dp, sp))
        cfg = sequence.sp_config(model_config(model, precision),
                                 axes["sp"], "zigzag")
        shards = fsdp.shard_params_fsdp(T.init_params(cfg, gen, dev),
                                        axes["dp"])
        step = sequence.make_sp_train_step(shards, cfg, dp_axis=axes["dp"],
                                           sp_axis=axes["sp"])
        cname = "sp"
        batches = (tuple(sequence.zigzag_shuffle(t, sp) for t in b)
                   for b in batches)
    elif layout == "dp_sp_tp":
        axes = mesh.grid_axes(("dp", "sp", "tp"), (dp, sp, tp))
        cfg = model_config(model, precision, attention)
        shards = tensor.shard_params_tp(T.init_params(cfg, gen, dev),
                                        axes["tp"])
        step = tensor.make_tp_train_step(shards, cfg, dp_axis=axes["dp"],
                                         tp_axis=axes["tp"],
                                         sp_axis=axes["sp"])
        cname = "tp"
    else:
        axes = mesh.grid_axes(("dp", "sp", "ep"), (dp, sp, ep))
        cfg = moe_config(model, experts=experts, precision=precision)
        shards = expert.shard_moe_lm_params(T.init_params(cfg, gen, dev),
                                            axes["ep"])
        step = expert.make_moe_lm_train_step(shards, cfg, dp_axis=axes["dp"],
                                             ep_axis=axes["ep"],
                                             sp_axis=axes["sp"])
        cname = "moe"
    opt = optim.adam_init(shards)
    sizes = {a: mesh.axis_size(x) for a, x in axes.items() if "_" not in a}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rank = mesh.axis_rank()
    if rank == 0:
        log(f"[layouts] {layout} model={model} mesh="
            f"{sizes}"
            f" batch={bs} seq={seq} precision={cfg.matmul_precision} "
            f"device={dev}")
    losses, times, colls = [], [], []
    for i, batch in zip(range(num_steps), batches):
        C.COLLECTIVES.reset()
        t = time.perf_counter()
        shards, opt, loss = step(shards, opt, batch)
        losses.append(float(loss))   # a host sync ends the step
        times.append(time.perf_counter() - t)
        colls.append(C.COLLECTIVES.read())
        if rank == 0:
            log(f"[layouts] step {i} loss {losses[-1]:.6f} "
                f"{times[-1] * 1e3:.1f} ms")
    # the first step's verdict (``analysis.contracts``: the library's
    # layout runs as the contract it composes, the ring's axis in it)
    verdict = evaluate_contract(cname, colls[0] if colls else {},
                                params=shards, axes=sizes,
                                n_layers=cfg.num_hidden_layers,
                                remat=cfg.remat)
    holds = verdict.ok and all(c == colls[0] for c in colls)
    ms = statistics.median(times[1:] or times) * 1e3
    tok_s = bs * seq / ms * 1e3
    flops_tok = T.model_flops_per_token(cfg, seq)
    mfu = flops_tok * tok_s / (ws * PEAK_BF16_FLOPS)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if rank == 0:
        log(f"[layouts] {layout}: losses {losses}; step {ms:.1f} ms "
            f"(median after the first), {tok_s:.1f} tokens/s, MFU {mfu:.4f}; "
            f"peak memory " + (f"{peak / 2 ** 30:.2f} GiB a rank"
                               if peak is not None else "not measured (CPU)")
            + f"; collectives a step "
            f"{json.dumps(C.COLLECTIVES.nonzero(colls[-1]))}; "
            f"contract[{cname}]: {verdict.summary()} (every step: {holds})")
    return {"layout": layout, "model": model, "world_size": ws, "dp": dp,
            "sp": sp, "tp": tp, "ep": ep, "batch_size": bs,
            "sequence_length": seq, "losses": losses, "step_times_s": times,
            "collectives": colls, "contract": verdict.to_dict(),
            "contract_ok": holds, "step_ms": ms,
            "tokens_per_second": tok_s, "mfu": mfu,
            "peak_memory_bytes": peak, "device": str(dev)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--layout", choices=LAYOUTS, required=True)
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY), default="tiny")
    p.add_argument("--sp", type=int, default=2)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--attention", choices=["xla", "flash"], default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--sequence-length", type=int, default=None)
    p.add_argument("--num-steps", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    p.add_argument("--out", default=None,
                   help="rank 0 writes the result as JSON")
    a = p.parse_args(argv)
    try:
        res = run(a.layout, a.model, sp=a.sp, tp=a.tp, ep=a.ep,
                  experts=a.experts, precision=a.precision,
                  attention=a.attention, batch_size=a.batch_size,
                  seq=a.sequence_length, num_steps=a.num_steps,
                  device=a.device, seed=a.seed)
        if a.out and mesh.axis_rank() == 0:
            Path(a.out).write_text(json.dumps(res))
        if not res["contract_ok"]:
            raise SystemExit("collectives off the contract")
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
