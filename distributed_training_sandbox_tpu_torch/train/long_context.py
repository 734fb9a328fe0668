"""Long-context one-card sweep: training past the reference's ceiling of
8192 tokens, the twin of the JAX package's ``scripts/long_context.py``.

    python -m distributed_training_sandbox_tpu_torch.train.long_context
    python -m distributed_training_sandbox_tpu_torch.train.long_context \\
        --device cpu --model tiny --seqs 64 128 --chunk-above 64 \\
        --chunk 96 --steps 1

Each sequence length of ``--seqs`` (8192, 16384, 32768, 65536) at
``bf16`` and ``int8_bwd`` trains the flagship FSDP step (AdamW, the
flash kernels, the streamed-vocab loss, full remat) at batch 1 through
the FSDP twin at one rank (``train.bench_row.measure_row``).  Above
``--chunk-above`` (32768) the loss streams the vocab in chunks of
``--chunk`` (4008) instead of the config's 16 032, as the reference
does: the chunk's f32 logits are B · S · chunk floats, 4.2 GB at 64k
with the default chunk.  A length that fails (out of memory, most
likely) is an ``error`` row.  Writes ``longcontext_results/
longcontext_<platform>.json`` (``gpu`` or ``cpu``; the reference's
``*_tpu.json`` stays as it is), one row a (seq, precision), and prints
the reference's markdown table.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..device import resolve_device
from ..utils import mesh
from .bench_row import measure_row

SEQS = (8192, 16384, 32768, 65536)
PRECISIONS = ("bf16", "int8_bwd")
CHUNK_ABOVE = 32768
CHUNK = 4008


def overrides(seq: int, precision: str, *, chunk_above: int = CHUNK_ABOVE,
              chunk: int = CHUNK) -> dict:
    """The reference's config overrides of one (seq, precision) row."""
    over = {"loss_vocab_chunk": chunk} if seq > chunk_above else {}
    if precision != "bf16":
        over = {**over, "matmul_precision": precision}
    return over


def table(rows) -> str:
    """The reference's markdown table of the rows."""
    lines = ["| seq | precision | tok/s | step ms | TFLOPS/device |",
             "|---|---|---|---|---|"]
    for r in rows:
        prec = r.get("config", {}).get("matmul_precision", "bf16")
        if "error" in r:
            lines.append(f"| {r['seq_len']} | {prec} | — | — | "
                         f"{r['error'][:60]} |")
        else:
            lines.append(f"| {r['seq_len']} | {prec} | "
                         f"{r['tokens_per_sec']:.0f} | {r['step_ms']:.0f} | "
                         f"{r['tflops_per_device']:.2f} |")
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="SMOLLM3_3B_L8")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--seqs", type=int, nargs="*", default=list(SEQS))
    p.add_argument("--precisions", nargs="*", default=list(PRECISIONS))
    p.add_argument("--chunk-above", type=int, default=CHUNK_ABOVE)
    p.add_argument("--chunk", type=int, default=CHUNK)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain path)")
    p.add_argument("--out-dir", default="longcontext_results")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    platform = "gpu" if dev.type == "cuda" else dev.type
    rows = []
    joined = mesh.initialized()
    try:
        # one group for every row: a row joins it and leaves it up
        mesh.init_process_group(dev)
        for seq in args.seqs:
            for precision in args.precisions:
                over = overrides(seq, precision,
                                 chunk_above=args.chunk_above,
                                 chunk=args.chunk)
                rows.append(measure_row(
                    args.model, seq, 1, num_steps=args.steps,
                    cfg_overrides=over, device=dev,
                    log=lambda m: print(f"[longctx] {m}", flush=True)))
    finally:
        if not joined:   # a group the caller made stays up
            mesh.destroy_process_group()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"longcontext_{platform}.json"
    path.write_text(json.dumps(rows, indent=1))
    print("\n" + table(rows))
    print(f"\n[longctx] wrote {path}", flush=True)
    return rows


if __name__ == "__main__":
    main()
