"""Zigzag against contiguous ring attention: the FLOPs of one dp × sp
step under each layout; the twin of the JAX package's
``scripts/zigzag_flops.py``.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.zigzag_flops \\
        --device cpu --sp 4 --seq 1024

The zigzag layout's win is the work each remote hop does: two fully
visible W × W stripe products instead of one masked S_local² block, so
the ring's score and PV products shrink to (D + D(D - 1)/2) / D² of the
contiguous ring's at D ranks (10/16 at 4).  The reference reads XLA's
``cost_analysis()`` of the compiled step; here the same FSDP × SP step
(``parallel.sequence.make_sp_train_step``, dp × sp over the process
group, remat off) runs once under each layout inside
``torch.utils.flop_counter.FlopCounterMode``, which counts the
products' FLOPs (matmuls and einsums, forward and backward), and once
more with the ring's forward counted apart, beside
``ops.ring_attention.MERGES`` (merges, fully masked merges, score
elements).  Every number is summed over the ranks.  A count of
operations, not a time: the CPU run gives it exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..ops import collectives as C
from ..ops import ring_attention as RA
from ..parallel import fsdp, sequence
from ..utils import mesh


def step_flops(layout: str, cfg: T.TransformerConfig, seq: int, batch: int,
               axes: dict, dev) -> dict:
    """One step of the dp × sp train step under ``layout`` on this rank:
    its FLOPs, the ring's forward FLOPs and the merges, each summed over
    the ranks."""
    sp = mesh.axis_size(axes["sp"])
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, dev)
    lcfg = sequence.sp_config(cfg, axes["sp"], layout=layout)
    shards = fsdp.shard_params_fsdp(params, axes["dp"])
    step = sequence.make_sp_train_step(shards, lcfg, dp_axis=axes["dp"],
                                       sp_axis=axes["sp"])
    opt = fsdp.init_fsdp_opt_state(shards)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen
                        ).to(dev)
    b = (ids, ids.roll(-1, 1))
    if layout == "zigzag":
        b = tuple(sequence.zigzag_shuffle(t, sp) for t in b)
    ring = []
    inner = T.ring_attention

    def counted(*a, **kw):       # the ring's forward, counted apart
        # (a counter starts from zero each time it is entered)
        ring.append(FlopCounterMode(display=False))
        with ring[-1]:
            return inner(*a, **kw)

    RA.MERGES.reset()
    total = FlopCounterMode(display=False)
    T.ring_attention = counted
    try:
        with total:
            step(shards, opt, b)
    finally:
        T.ring_attention = inner
    merges = RA.MERGES.read()
    vals = torch.tensor([float(total.get_total_flops()),
                         float(sum(f.get_total_flops() for f in ring)),
                         float(merges["calls"]), float(merges["masked"]),
                         float(merges["scores"])], dtype=torch.float64,
                        device=dev)
    vals = C.all_reduce(vals, mesh.span(axes["dp"], axes["sp"]))
    keys = ("step_flops", "ring_forward_flops", "merges", "masked_merges",
            "score_elements")
    return {k: int(v) for k, v in zip(keys, vals.tolist())}


def run(model: str = "tiny", *, sp: int = 4, seq: int = 1024,
        layers: int = 2, batch: int | None = None, device=None) -> dict:
    """Both layouts on this rank's group (every rank calls it): the
    totals of each and their ratios."""
    dev = mesh.init_process_group(device)
    ws = mesh.axis_size()
    if ws % sp:
        raise ValueError(f"--sp {sp} must divide the {ws} ranks")
    axes = mesh.grid_axes(("dp", "sp"), (ws // sp, sp))
    cfg = dataclasses.replace(getattr(T, MODEL_REGISTRY[model]),
                              num_hidden_layers=layers, remat=False,
                              attention_impl="xla")
    batch = batch or ws // sp
    out = {"model": model, "layers": layers, "seq": seq, "batch": batch,
           "grid": {"dp": ws // sp, "sp": sp}}
    for layout in RA.LAYOUTS:
        out[layout] = step_flops(layout, cfg, seq, batch, axes, dev)
    c, z = out["contiguous"], out["zigzag"]
    out["ring_forward_ratio"] = z["ring_forward_flops"] / c[
        "ring_forward_flops"]
    out["score_element_ratio"] = z["score_elements"] / c["score_elements"]
    out["step_flops_saved_share"] = 1 - z["step_flops"] / c["step_flops"]
    out["expected_ratio"] = (sp + sp * (sp - 1) / 2) / sp ** 2
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY), default="tiny")
    p.add_argument("--sp", type=int, default=4)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=None,
                   help="the global batch; default one row a dp rank")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    p.add_argument("--out", default=None, help="rank 0 writes the result "
                                               "as JSON")
    args = p.parse_args(argv)
    try:
        res = run(args.model, sp=args.sp, seq=args.seq, layers=args.layers,
                  batch=args.batch_size, device=args.device)
        if mesh.axis_rank() == 0:
            print(f"[zigzag-flops] step FLOPs contiguous "
                  f"{res['contiguous']['step_flops']:.4e} zigzag "
                  f"{res['zigzag']['step_flops']:.4e} (saved "
                  f"{100 * res['step_flops_saved_share']:.2f} % of the "
                  f"step); the ring's forward zigzag/contiguous "
                  f"{res['ring_forward_ratio']:.4f}, score elements "
                  f"{res['score_element_ratio']:.4f} (expected "
                  f"{res['expected_ratio']:.4f})")
            print(json.dumps(res))
            if args.out:
                Path(args.out).write_text(json.dumps(res, indent=1))
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
