"""Autoregressive decode benchmark: precision × batch sweep of the port's
one-shot ``generate`` with the prefill / decode split and the weight-read
roofline — the twin of the JAX package's ``scripts/decode_bench.py``.

    python -m distributed_training_sandbox_tpu_torch.train.decode_bench --sweep
    python -m distributed_training_sandbox_tpu_torch.train.decode_bench \\
        --precision int8 --batch 8 --prompt 2048 --new 128
    python -m distributed_training_sandbox_tpu_torch.train.decode_bench \\
        --device cpu --model tiny --batch 2 --prompt 16 --new 8

Decode at these shapes is weight-read-bound: every step reads every
weight byte the step touches and the whole KV cache, so a step's floor
is ``(weight_read_bytes + kv_bytes_per_step) / HBM rate`` (the formulas
of ``serving.accounting``, shared with the serving pool's planner).
Each row reports the steady decode time a step beside that roofline and
the achieved fraction.  ``int8`` rows decode with
``quantize_decode_params``' int8 weights: on the card every projection
and the unembedding run K4.  The steady rate is a slope: the total time
at N/2 and at N new tokens, best of 3 each, the prefill cancelled.
A slope that is not positive (two wall times within the host's noise,
as a few steps of a tiny model on a loaded CPU give) is no reading: the
row's ``steady_ms_per_step`` and the rates derived from it are None and
``failed_reading`` names why.

  * ``--sweep``: precision {bf16, int8} × batch {1, 8, 32} at
    ``--prompt``, plus the long-prompt (2048) rows with and without the
    int8 cache.
  * one row: ``--precision``, ``--batch``, ``--prompt``, ``--new``,
    ``--kv-quant``.

The roofline column uses the card's published HBM rate (H100 SXM, 3.35
TB/s; ``HBM_GBPS``); the CPU has none, so its rows leave it null.  Rows
carry the card's ``nvidia-smi`` name and power limit.  The params build
lazily per precision (the previous set dropped first), as the
reference's do.  Writes ``decode_results/decode_<platform>.json``
(``--out-dir``, ``--out-file``), a list of rows with the reference's
keys.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models.generate import generate, quantize_decode_params
from ..serving.accounting import (kv_bytes_per_step, tree_bytes,
                                  weight_read_bytes)
from ..utils.memory import classify_failure
from .busbench import card_line
from .serve_bench import model_config

# published HBM rate a card, GB/s (NVIDIA's H100 SXM data sheet); the
# roofline column only
HBM_GBPS = {"gpu": 3350.0}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_one(cfg, params, precision: str, batch: int, prompt_len: int,
            new_tokens: int, dev, kv_quant: bool = False) -> dict:
    """One row: the steady decode rate from the slope between N/2 and N
    new tokens, the prefill estimate, and the read roofline."""
    platform = "gpu" if dev.type == "cuda" else dev.type
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(batch, prompt_len)),
                             device=dev)

    def timed(ids, n) -> float:
        _sync(dev)
        t0 = time.perf_counter()
        generate(params, ids, cfg, max_new_tokens=n, kv_quant=kv_quant,
                 device=dev).cpu()
        return time.perf_counter() - t0

    n_half = max(new_tokens // 2, 1)
    for n in (n_half, new_tokens):       # warm both lengths first
        timed(prompt, n)
    p2 = torch.roll(prompt, 1, dims=1)
    tH = tN = float("inf")
    for _ in range(3):                   # best of 3 a point
        tH = min(tH, timed(p2, n_half))
        tN = min(tN, timed(p2, new_tokens))
    step_s = (tN - tH) / max(new_tokens - n_half, 1)
    failed = None
    if not step_s > 0:
        failed = (f"non-positive slope: best of 3 at {new_tokens} new tokens "
                  f"{tN:.6f} s, at {n_half} {tH:.6f} s")
    steady = batch / step_s if failed is None else None
    prefill_s = max(tN - new_tokens * step_s, 0.0) if failed is None else None

    wb = tree_bytes(params)
    wrb = weight_read_bytes(cfg, params, wb)
    kvb = kv_bytes_per_step(cfg, batch, prompt_len + new_tokens, kv_quant)
    bw = HBM_GBPS.get(platform)
    # every mandatory read of a step: the weights it touches and the
    # whole KV cache (cache writes a step are one token column)
    roofline_ms = (wrb + kvb) / (bw * 1e9) * 1e3 if bw else None
    row = {
        "precision": precision + ("+kvq" if kv_quant else ""),
        "batch": batch, "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "weight_gib": wb / 2 ** 30,
        "weight_read_gib": wrb / 2 ** 30,
        "kv_cache_gib": kvb / 2 ** 30,
        "prefill_est_s": prefill_s,
        "total_s": tN,
        "steady_decode_tokens_per_sec": steady,
        "steady_ms_per_step": step_s * 1e3 if failed is None else None,
        "steady_ms_per_token_per_seq": (step_s * 1e3 if failed is None
                                        else None),
        "read_roofline_ms_per_step": roofline_ms,
        "roofline_fraction": (roofline_ms / (step_s * 1e3)
                              if roofline_ms and failed is None else None),
        "failed_reading": failed,
    }
    if failed is None:
        print(f"[decode] {row['precision']} b{batch} p{prompt_len} "
              f"n{new_tokens}: {row['steady_ms_per_step']:.3f} ms/step "
              f"({steady:.0f} tok/s, roofline {roofline_ms} ms, "
              f"{row['roofline_fraction']})", flush=True)
    else:
        print(f"[decode] {row['precision']} b{batch} p{prompt_len} "
              f"n{new_tokens}: FAILED READING ({failed})", flush=True)
    return row


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="SMOLLM3_3B_L8")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain path)")
    p.add_argument("--precision", choices=["bf16", "int8"], default="bf16")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt", type=int, default=128)
    p.add_argument("--new", type=int, default=128)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--kv-quant", action="store_true",
                   help="store the KV cache int8 (+per-row scales)")
    p.add_argument("--out-dir", default="decode_results")
    p.add_argument("--out-file", default=None,
                   help="output filename (default decode_<platform>.json)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config(args.model)
    platform = "gpu" if dev.type == "cuda" else dev.type
    card = card_line() if dev.type == "cuda" else None
    # params build lazily per precision GROUP, the previous set dropped
    # first: a bf16 and an int8 copy of a 3B model held at once would
    # distort the large-batch rows
    param_cache: dict = {}

    def params_for(precision: str):
        if precision not in param_cache:
            param_cache.clear()
            from .serve_bench import build_params
            bf16 = build_params(cfg, 0, 1.0, dev)
            param_cache[precision] = (
                bf16 if precision == "bf16"
                else quantize_decode_params(bf16, cfg))
            del bf16
        return param_cache[precision]

    if args.sweep:
        # grouped by precision so the lazy params rebuild once; the
        # (8, 2048) cells are the long-prompt split, with the int8 cache
        # too
        cells = [(1, args.prompt, False), (8, args.prompt, False),
                 (32, args.prompt, False), (8, 2048, False), (8, 2048, True),
                 (32, args.prompt, True)]
        grid = [(prec, b, plen, args.new, kvq)
                for prec in ("bf16", "int8") for b, plen, kvq in cells]
    else:
        grid = [(args.precision, args.batch, args.prompt, args.new,
                 args.kv_quant)]

    rows = []
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / (args.out_file or f"decode_{platform}.json")
    for prec, b, plen, new, kvq in grid:
        head = {"model": args.model, "platform": platform, "card": card}
        try:
            rows.append({**head, **run_one(cfg, params_for(prec), prec, b,
                                           plen, new, dev, kv_quant=kvq)})
        except (RuntimeError, ValueError) as e:
            kind, msg = classify_failure(e)
            rows.append({**head, "precision": prec, "batch": b,
                         "prompt_len": plen, "failure": kind, "error": msg})
            print(f"[decode] {prec} b{b} p{plen} {kind.upper()}: "
                  f"{msg[:120]}", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        path.write_text(json.dumps(rows, indent=1))
    print(f"[decode] wrote {path}")
    return rows


if __name__ == "__main__":
    main()
