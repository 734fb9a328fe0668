"""Collective bus-bandwidth sweep: the twin of the JAX package's
``scripts/busbench.py``, one process a rank.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.busbench
    torchrun --nproc-per-node 2 -m \\
        distributed_training_sandbox_tpu_torch.train.busbench --device cpu \\
        --payloads-mb 1,4

Runs ``ops.busbench.run_sweep`` (nccl-tests accounting: algbw and busbw
per collective and payload) over the process group that ``torchrun``
sets up: NCCL between cards (one a rank), gloo with ``--device cpu``;
run alone it is one rank.  Rank 0 writes ``busbench_gpu_<n>dev.{json,md}``
(``busbench_gloo_<n>proc.{json,md}`` on the CPU) into ``--out-dir``
(default ``build/busbench/``, which git ignores).  The markdown's
preamble carries the card's ``nvidia-smi`` name and power limit.  At one
rank every collective is a copy (``ppermute`` not even that), and the
file says so: no link is measured.  On the CPU the numbers time gloo
over loopback, not any interconnect of a card.

Not ported: the reference's in-process CPU mesh (``--cpu-devices``) and
its self-spawning ``--gloo-procs`` mode (``torchrun`` starts the ranks).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch.distributed as dist

from ..ops.busbench import COLLECTIVE_NAMES, run_sweep
from ..utils import mesh


def card_line() -> str | None:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line (the
    first card's), or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def make_markdown(results, n: int, transport: str,
                  card: str | None) -> str:
    payloads = sorted({r.payload_bytes for r in results})
    collectives = list(dict.fromkeys(r.collective for r in results))
    lines = [f"# {transport.upper()} bus-bandwidth sweep — {n} rank(s)", "",
             "nccl-tests accounting (`ops/busbench.py`): `algbw = payload / "
             "t`;", "`busbw` applies the per-collective wire factor "
             "(all_reduce 2(n-1)/n, gather/scatter/all_to_all (n-1)/n, "
             "ppermute 1).", ""]
    if card is not None:
        lines += [f"Card (`nvidia-smi --query-gpu=name,power.limit`): "
                  f"{card}", ""]
    if transport == "gloo":
        lines += ["> gloo over loopback on the CPU: these numbers time host",
                  "> memory and TCP, no interconnect of a card.", ""]
    if n == 1:
        lines += ["> One rank: every collective is a copy of the buffer",
                  "> (`ppermute` returns its input without a call); no link",
                  "> is measured.", ""]
    header = "| collective | " + " | ".join(
        f"{p / 2 ** 20:g} MiB" for p in payloads) + " |"
    by = {(r.collective, r.payload_bytes): r for r in results}
    for title, key, fmt in (("busbw (GB/s)", "busbw_gbps", "{:.2f}"),
                            ("time a call (ms)", "time_ms", "{:.4f}")):
        lines += [f"## {title}, {n} rank(s)", "", header,
                  "|" + "---|" * (len(payloads) + 1)]
        for c in collectives:
            row = [c] + [fmt.format(getattr(by[c, p], key))
                         if (c, p) in by else "—" for p in payloads]
            lines.append("| " + " | ".join(row) + " |")
        lines.append("")
    return "\n".join(lines)


def run(*, payloads_mb=(1, 16, 128), collectives=COLLECTIVE_NAMES,
        iters: int = 10, out_dir="build/busbench", device=None,
        log=print) -> dict:
    """Sweep on this rank in bf16, as the reference does (joining or
    making the process group); rank 0 writes the JSON and markdown files
    and returns the document, the other ranks an empty dict."""
    dev = mesh.init_process_group(device)
    n, rank = mesh.axis_size(), mesh.axis_rank()
    transport = dist.get_backend()
    payloads = tuple(int(float(m) * 2 ** 20) for m in payloads_mb)
    if rank == 0:
        log(f"[busbench] transport={transport} ranks={n} device={dev} "
            f"payloads={[f'{p / 2 ** 20:g}MiB' for p in payloads]} bf16")
    results = run_sweep(payloads, collectives=tuple(collectives),
                        iters=iters, device=dev)
    if rank != 0:
        return {}
    for r in results:
        log(f"[busbench] {r.collective:15s} {r.payload_bytes / 2 ** 20:7g} "
            f"MiB {r.time_ms:9.4f} ms  algbw {r.algbw_gbps:8.2f} GB/s  "
            f"busbw {r.busbw_gbps:8.2f} GB/s")
    card = card_line() if dev.type == "cuda" else None
    tag = (f"busbench_gpu_{n}dev" if dev.type == "cuda"
           else f"busbench_gloo_{n}proc")
    doc = {"schema": 1, "platform": "gpu" if dev.type == "cuda" else "cpu",
           "devices": n, "processes": n, "transport": transport,
           "card": card, "dtype": "bf16",
           "payload_bytes": sorted({r.payload_bytes for r in results}),
           "harness_validation": n == 1 or dev.type != "cuda",
           "rows": [r.to_dict() for r in results]}
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{tag}.json").write_text(json.dumps(doc, indent=2) + "\n")
    (out / f"{tag}.md").write_text(make_markdown(results, n, transport,
                                                 card))
    log(f"[busbench] wrote {out / f'{tag}.json'} and {out / f'{tag}.md'}")
    return doc


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--payloads-mb", default="1,16,128",
                   help="comma-separated payload sizes in MiB")
    p.add_argument("--collectives", default="all",
                   help='"all" or a comma-separated subset of '
                        f'{",".join(COLLECTIVE_NAMES)}')
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out-dir", default="build/busbench")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card (NCCL); 'cpu' for gloo")
    args = p.parse_args(argv)
    colls = (COLLECTIVE_NAMES if args.collectives == "all"
             else tuple(args.collectives.split(",")))
    try:
        run(payloads_mb=args.payloads_mb.split(","), collectives=colls,
            iters=args.iters, out_dir=args.out_dir, device=args.device)
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main()
