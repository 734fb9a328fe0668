"""MoE transformer benchmark on the card: dispatch × capacity × precision,
the twin of the JAX package's ``scripts/moe_bench.py``.

    python -m distributed_training_sandbox_tpu_torch.train.moe_bench
    python -m distributed_training_sandbox_tpu_torch.train.moe_bench \\
        --device cpu --model tiny --seq 32 --rows 0,3 --steps 1

Each row of ``GRID`` (the reference's, with its batch) trains the
switch-MoE flagship geometry (``BASE``: 8 experts × ``moe_ffn`` 2752,
the dense SmolLM3-3B-L8's MLP FLOPs split 4 ways active) through the
FSDP twin at one rank (``train.bench_row.measure_row``) at seq 8192;
a row that fails is an ``error`` row, as in the reference.  The drop
rates at init come from the port's ``parallel.expert.
grouped_drop_fraction`` (the capacity rule the timed dispatch enforces)
on router logits of numpy-seeded tokens and weights.  Writes
``moe_results/moe_<platform>.json`` (``gpu`` or ``cpu``: never the
reference's ``*_tpu.json``) as ``{"rows", "drop_rates_at_init"}``.

Cuts for a short run: ``--rows`` (indices into ``GRID``), ``--layers``
(every row's depth), ``--batch`` (every row's batch).  ``--model tiny``
scales ``BASE`` to TINY_LM (``TINY_BASE``: 8 experts of width 40).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..parallel.expert import _topk_lowest_index, grouped_drop_fraction
from ..utils import mesh
from .bench_row import measure_row, registry_name

_M = T.SMOLLM3_3B_L8_MOE
BASE = {"n_experts": _M.n_experts, "moe_ffn": _M.moe_ffn,
        "num_hidden_layers": _M.num_hidden_layers}
TINY_BASE = {"n_experts": 8, "moe_ffn": 40,
             "num_hidden_layers": T.TINY_LM.num_hidden_layers}
GRID = [
    # the grouped one-hot dispatch, capacity-factor sweep
    ({"moe_dispatch": "grouped"}, 4),
    ({"moe_dispatch": "grouped", "moe_capacity_factor": 1.25}, 4),
    ({"moe_dispatch": "grouped", "moe_capacity_factor": 1.0}, 4),
    ({"moe_dispatch": "grouped", "moe_capacity_factor": 1.25,
      "matmul_precision": "int8_bwd"}, 4),
    ({"moe_dispatch": "grouped", "moe_capacity_factor": 1.0,
      "matmul_precision": "int8_bwd"}, 4),
    ({"moe_dispatch": "grouped"}, 2),
    ({"moe_dispatch": "grouped", "moe_top_k": 2,
      "moe_capacity_factor": 1.0}, 4),
    # the sort and einsum paths, kept for the A/B record
    ({"moe_dispatch": "sort"}, 4),
    ({"moe_dispatch": "sort", "matmul_precision": "int8_bwd"}, 4),
    ({"moe_dispatch": "einsum"}, 2),
]


def measure_drop_rates(seq: int, batch: int, *, hidden: int,
                       n_experts: int, group_sizes=(128,),
                       cap_factors=(2.0, 1.25, 1.0), top_ks=(1, 2),
                       seed: int = 0) -> list[dict]:
    """Fraction of (token, assignment) pairs the per-group capacity rule
    drops for router logits at init: numpy-seeded bf16 tokens (N =
    batch · seq) times a router of std ``hidden ** -0.5``, the top-k by
    ``expert._topk_lowest_index`` (the dispatch's), the rule by
    ``grouped_drop_fraction``.  The reference draws the same shapes from
    ``jax.random``, whose stream differs."""
    rng = np.random.default_rng(seed)
    N = batch * seq
    x = torch.from_numpy(rng.standard_normal((N, hidden),
                                             dtype=np.float32)).bfloat16()
    wr = torch.from_numpy(rng.standard_normal((hidden, n_experts),
                                              dtype=np.float32)
                          * np.float32(hidden ** -0.5))
    logits = x.float() @ wr
    rows = []
    for k in top_ks:
        _, assignment = _topk_lowest_index(logits, k)
        rows += [{"group_size": G, "capacity_factor": cf, "top_k": k,
                  "drop_fraction": round(float(grouped_drop_fraction(
                      assignment, n_experts, G, cf)), 4)}
                 for G in group_sizes for cf in cap_factors]
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="SMOLLM3_3B_L8")
    p.add_argument("--seq", type=int, default=8192)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--rows", default=None,
                   help="comma-separated indices into GRID (default all)")
    p.add_argument("--layers", type=int, default=None,
                   help="every row's depth (default BASE's)")
    p.add_argument("--batch", type=int, default=None,
                   help="every row's batch (default the row's own)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain path)")
    p.add_argument("--out-dir", default="moe_results")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    platform = "gpu" if dev.type == "cuda" else dev.type
    base = dict(TINY_BASE if registry_name(args.model) == "tiny" else BASE)
    if args.layers:
        base["num_hidden_layers"] = args.layers
    picks = (range(len(GRID)) if args.rows is None
             else [int(i) for i in args.rows.split(",")])
    rows = []
    joined = mesh.initialized()
    try:
        for i in picks:
            over, b = GRID[i]
            cfgo = {**base, **over}
            rows.append(measure_row(args.model, args.seq,
                                    args.batch or b, num_steps=args.steps,
                                    cfg_overrides=cfgo, device=dev,
                                    log=lambda m: print(f"[moe-bench] {m}",
                                                        flush=True)))
    finally:
        if not joined:   # a group the caller made stays up
            mesh.destroy_process_group()
    mcfg = getattr(T, MODEL_REGISTRY[registry_name(args.model)])
    drops = measure_drop_rates(args.seq, 4, hidden=mcfg.hidden_size,
                               n_experts=base["n_experts"])
    print(f"[moe-bench] drop rates: {drops}", flush=True)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"moe_{platform}.json"
    doc = {"rows": rows, "drop_rates_at_init": drops}
    path.write_text(json.dumps(doc, indent=1))
    print(f"[moe-bench] wrote {path}", flush=True)
    return doc


if __name__ == "__main__":
    main()
