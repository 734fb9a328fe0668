"""The TP rejoins side by side: ``all_reduce`` (``overlap="none"``)
against ``decomposed_all_reduce`` (``overlap="ring"``: a reduce_scatter,
then the ring all-gather) on the same partial sums.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.rejoin_reading \\
        --out chiprun_out/rejoin.json

Every rank draws its partial sum from its own seed, shaped as one layer
rejoin of ``--model`` (B 1, S ``--sequence-length``, the hidden width),
in bf16 and in f32.  Rank 0 prints, for each dtype, the elements where
the two rejoins differ, the largest difference, and how far each lies
from the exact (f64) sum of the partials in units of the dtype's
rounding and over the n-roundings bound (``over_ws_roundings``: ≤ 1
holds the tier the 4-rank CPU test pins); and whether the
reduce_scatter's chunk equals the same chunk of the all_reduce (which
locates a difference in the reduction, not in the ring's data
movement).  The process group is NCCL on the cards (the
library picks each collective's algorithm; set ``NCCL_ALGO`` on the
command line to pin one for a run) and gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..ops import collectives as C
from ..utils import mesh

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _ulps(v: torch.Tensor, exact: torch.Tensor, dtype) -> float:
    """The largest distance of ``v`` from ``exact`` in units of
    ``dtype``'s spacing at ``exact`` (eps · |exact|, at least eps)."""
    eps = torch.finfo(dtype).eps
    spacing = exact.abs().clamp_min(1.0) * eps
    return float(((v.double() - exact).abs() / spacing).max())


def read(model: str = "smollm3-3b-l8", seq: int = 8192, seed: int = 0,
         device=None) -> dict:
    """The reading on this rank's group (every rank calls it); the
    result is the same on every rank."""
    dev = mesh.init_process_group(device)
    n, rank = mesh.axis_size(), mesh.axis_rank()
    tp = mesh.grid_axes(("tp",), (n,))["tp"]
    H = getattr(T, MODEL_REGISTRY[model]).hidden_size
    out = {"world_size": n, "shape": [1, seq, H], "device": str(dev),
           "NCCL_ALGO": os.environ.get("NCCL_ALGO")}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
        out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
    for name, dtype in DTYPES.items():
        gen = torch.Generator(device=dev).manual_seed(seed + rank)
        x = torch.randn((1, seq, H), generator=gen, device=dev).to(dtype)
        ar = C.all_reduce(x, tp)
        dec = C.decomposed_all_reduce(x, tp, axis=-1)
        chunk = H // n
        rs = C.reduce_scatter(x, tp, axis=-1)
        # every rank's partials, for the exact sum (f64)
        parts = C.all_gather(x.double().unsqueeze(0), tp, axis=0)
        exact = parts.sum(0)
        # n roundings of the partial sums, each at most eps of the sum of
        # the terms' magnitudes (the 4-rank CPU test's tier)
        limit = n * torch.finfo(dtype).eps * parts.abs().sum(0)
        differ = ar != dec
        rs_same = torch.equal(rs, ar.narrow(-1, rank * chunk, chunk))
        rs_flag = torch.tensor([0.0 if rs_same else 1.0], device=dev)
        rs_flag = C.all_reduce(rs_flag, tp)
        out[name] = {
            "elements": int(x.numel()),
            "differ": int(differ.sum()),
            "max_abs_diff": float((ar.double() - dec.double()).abs().max()),
            "all_reduce_ulps_from_exact": _ulps(ar, exact, dtype),
            "decomposed_ulps_from_exact": _ulps(dec, exact, dtype),
            "ranks_whose_reduce_scatter_chunk_differs": int(rs_flag.item()),
            "over_ws_roundings": {
                k: float(((v.double() - exact).abs() / limit).max())
                for k, v in (("all_reduce", ar), ("decomposed", dec))},
        }
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY),
                   default="smollm3-3b-l8")
    p.add_argument("--sequence-length", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    p.add_argument("--out", default=None, help="rank 0 writes the reading "
                                               "as JSON")
    args = p.parse_args(argv)
    try:
        res = read(args.model, args.sequence_length, args.seed, args.device)
        if mesh.axis_rank() == 0:
            print(json.dumps(res))
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps(res, indent=1))
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
