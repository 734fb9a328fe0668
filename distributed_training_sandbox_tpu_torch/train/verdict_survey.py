"""Every training twin's contract verdict and collective ledger over the
ranks of one group: a survey of the wire, for a four-card run.

    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.verdict_survey \\
        --out-dir /tmp/survey
    python -m distributed_training_sandbox_tpu_torch.train.verdict_survey \\
        --summarize /tmp/survey/runs
    torchrun --nproc-per-node 4 -m \\
        distributed_training_sandbox_tpu_torch.train.verdict_survey \\
        --device cpu --out-dir /tmp/survey

The first form runs, on one process group (NCCL and the cards by
default, gloo with ``--device cpu``), each twin that files a verdict
for ``--num-steps`` steps with the last two profiled: DDP (per leaf,
1 MiB buckets, q8) and ZeRO-1/2/3 on the toy MLP at width 500; TP (tp 2:
none, ring, q8), SP (sp 2), MoE (ep = the ranks, 8 experts) and FSDP
(none, ring, fp8_pallas in bf16) on TINY_LM at seq 256; the composable
twin at ``fsdp2xtp2`` and ``dp<ws>xw1``.  Each run's telemetry lands
under ``<out-dir>/runs/<tag>``: the manifest with its verdict, the
collective ledger joined to it.  The second form prints, for each
rank-0 run directory under the runs folder, one JSON line: the
contract, its verdict's ``summary()``, the rules verdict's ok, and the
ledger's join (ok, expected, compiled and measured sites, violations).
The pipeline twin (``train.pipeline --n-stages 4``, one process over
the cards) files its verdict the same way and is summarised with them
when its runs share the folder.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import torch

from ..analysis.contracts import ContractVerdict
from ..utils import mesh
from ..utils.profiling import ProfileSchedule
from . import _2d, ddp, moe, train_composable, train_fsdp, zero
from .harness import quiet_config

# the last two of four steps traced
SCHEDULE = ProfileSchedule(skip_first=1, wait=0, warmup=1, active=2)


def survey(out_dir: Path, device=None, num_steps: int = 4) -> None:
    """Every twin on this rank's group (made or joined here, destroyed
    at the end if made here)."""
    joined = mesh.initialized()
    mesh.init_process_group(device)
    ws = mesh.axis_size()
    log = (lambda *a, **k: None) if mesh.axis_rank() else print

    def kw(tag):
        return dict(num_steps=num_steps, device=device, log=log,
                    profile_schedule=SCHEDULE, config=quiet_config(
                        telemetry=True, profile=True,
                        results_dir=str(out_dir / "runs" / tag),
                        trace_dir=str(out_dir / "traces" / tag)))
    try:
        for tag, extra in (("ddp", {}), ("ddp_bucketed", {"bucket_mb": 1.0}),
                           ("ddp_q8", {"quantize_grads": True})):
            ddp.run(scale=20, batch_size=32, **kw(tag), **extra)
        for stage in (1, 2, 3):
            zero.run(stage, scale=20, batch_size=16, **kw(f"zero{stage}"))
        for overlap in ("none", "ring", "q8"):
            _2d.run("tp", "tiny", second=2, overlap=overlap, seq=256,
                    **kw("tp" if overlap == "none" else f"tp_{overlap}"))
        _2d.run("sp", "tiny", second=2, seq=256, **kw("sp"))
        moe.run("tiny", ep=ws, seq=256, batch_size=ws, **kw("moe"))
        for tag, extra in (("fsdp", {}), ("fsdp_ring", {"overlap": "ring"}),
                           ("fsdp_fp8", {"cfg_overrides": {
                               "matmul_precision": "fp8_pallas",
                               "dtype": torch.bfloat16}})):
            train_fsdp.run("tiny", seq=256, **kw(tag), **extra)
        train_composable.run("fsdp2xtp2", "tiny", seq=256,
                             **kw("composable_fsdp2xtp2"))
        train_composable.run(f"dp{ws}xw1", scale=20,
                             **kw(f"composable_dp{ws}xw1"))
    finally:
        if not joined:
            mesh.destroy_process_group()


def summarize(runs: Path) -> list[dict]:
    """One line a rank-0 run directory under ``runs/<tag>/``."""
    lines = []
    for d in sorted(p for p in runs.glob("*/*") if p.is_dir()
                    and not re.search(r"-r[1-9][0-9]*$", p.name)):
        man = json.loads((d / "manifest.json").read_text())
        c = man.get("contract")
        line = {"run": f"{d.parent.name}/{d.name}",
                "contract": c and c["strategy"],
                "verdict": ContractVerdict(**c).summary() if c else None,
                "rules_ok": (man.get("rules") or {}).get("ok")}
        led = d / "collectives.json"
        if led.exists():
            join = json.loads(led.read_text())["contract_join"]
            line.update(join_ok=join["ok"], expected=join["expected"],
                        compiled=join["compiled_sites"],
                        measured=join["measured_sites"],
                        violations=join["violations"])
        lines.append(line)
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", type=Path,
                   default=Path("runs") / "verdict_survey")
    p.add_argument("--device", default=None,
                   help="default: the CUDA cards (NCCL); 'cpu' for gloo")
    p.add_argument("--num-steps", type=int, default=4)
    p.add_argument("--summarize", type=Path, default=None, metavar="RUNS",
                   help="print the survey of a runs folder and exit")
    args = p.parse_args(argv)
    if args.summarize is not None:
        for line in summarize(args.summarize):
            print(json.dumps(line), flush=True)
        return
    survey(args.out_dir, args.device, args.num_steps)


if __name__ == "__main__":
    main()
