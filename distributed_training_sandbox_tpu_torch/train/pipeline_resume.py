"""The pipeline twin preempted and resumed against its uninterrupted run,
on every card the host sees.

    python -m distributed_training_sandbox_tpu_torch.train.pipeline_resume \\
        --out pipeline_resume.json

For each case of ``--cases`` (``model:schedule[:opt8]``),
``train.pipeline.run`` trains ``--epochs`` epochs uninterrupted, then
again with a checkpoint under ``--checkpoint-root`` (a fresh directory
under ``TMPDIR`` by default), preempted after epoch ``--preempt`` and
resumed in process. A case holds when the two runs' losses are equal,
every stage's params and Adam state (moments and count; int8 codes and
scales under ``opt8``) are bit-equal, and every tensor of the resumed
stages lies on its stage's own card; with several cards, the 1F1B stages
sit one a card and the interleaved schedule's ``n_stages / 2`` logical
devices put two stages on each card. Prints one JSON object (each case's
readings and ``"ok"``) and exits 1 when a case fails.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..utils.checkpoint import flatten
from . import pipeline as pp_run
from .harness import quiet_config

CASES = ("mlp:1f1b", "mlp:interleaved", "mlp:gpipe", "mlp:1f1b:opt8",
         "smollm3-3b-l8:1f1b", "smollm3-3b-l8:interleaved")


def _state(stage) -> dict:
    return flatten({"p": stage.params, "o": stage.opt_state})


def compare(a_stages, b_stages) -> dict:
    """Leaves that differ between two runs' stages, and the resumed
    stages' leaves that lie off their stage's device."""
    differ, misplaced, n = [], [], 0
    for i, (sa, sb) in enumerate(zip(a_stages, b_stages, strict=True)):
        fa, fb = _state(sa), _state(sb)
        if fa.keys() != fb.keys():
            differ.append(f"stage {i}: keys")
            continue
        for k, x in fa.items():
            y = fb[k]
            n += 1
            if isinstance(x, torch.Tensor):
                if y.device != sb.device:
                    misplaced.append(f"stage {i} {k}: {y.device}")
                if not torch.equal(x, y.to(x.device)):
                    differ.append(f"stage {i} {k}")
            elif x != y:
                differ.append(f"stage {i} {k}")
    return {"leaves": n, "differ": differ, "misplaced": misplaced}


def check_case(case: str, *, epochs: int, preempt: int, root: Path,
               device="cuda", log=print) -> dict:
    model, schedule, *rest = case.split(":")
    opt8 = rest == ["opt8"]
    big = model != "mlp"
    n_stages = (8 if schedule == "interleaved" else 4) if big else (
        4 if schedule == "interleaved" else 2)
    kw = dict(model=model, n_stages=n_stages, num_epochs=epochs,
              n_micro=4, batch_size=16 if big else 64, seq=256, seed=0,
              opt8=opt8, keep_stages=True, device=device, log=log)
    a = pp_run.run(schedule, **kw)
    ck = root / case.replace(":", "_")
    t = time.perf_counter()
    try:
        b = pp_run.run(schedule, config=quiet_config(
            checkpoint_dir=str(ck), max_restarts=1,
            inject_fault=f"preempt@{preempt}"), **kw)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    wall = time.perf_counter() - t
    cmp = compare(a["stages"], b["stages"])
    out = {"case": case, "n_stages": n_stages,
           "devices": [str(s.device) for s in b["stages"]],
           "status": b["status"], "start_epoch": b["start_epoch"],
           "losses_equal": b["losses"] == a["losses"],
           "leaves": cmp["leaves"], "differ": cmp["differ"][:8],
           "misplaced": cmp["misplaced"][:8],
           "saves": [{k: sv[k] for k in ("bytes", "blocking_s", "write_s")}
                     for sv in b["saves"]],
           "restore_s": b["restore_s"], "resumed_wall_s": round(wall, 2)}
    out["ok"] = (b["status"] == "completed" and b["start_epoch"] == preempt
                 and out["losses_equal"] and not cmp["differ"]
                 and not cmp["misplaced"])
    del a, b
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                allow_abbrev=False)
    p.add_argument("--cases", default=",".join(CASES),
                   help="comma-separated model:schedule[:opt8]")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--preempt", type=int, default=2)
    p.add_argument("--checkpoint-root", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cpu' for a dry run (at one thread)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("pipeline_resume: no CUDA card", file=sys.stderr)
        return 2
    if args.device == "cpu":
        # a transformer's threaded CPU backward is not bit-equal run to
        # run (ROADMAP.md, C12); one thread is
        torch.set_num_threads(1)
    root = Path(args.checkpoint_root or tempfile.mkdtemp(
        prefix="pipeline_resume_"))
    rows = []
    try:
        for c in args.cases.split(","):
            rows.append(check_case(c, epochs=args.epochs,
                                   preempt=args.preempt, root=root,
                                   device=args.device, log=lambda m: None))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    finally:
        if args.checkpoint_root is None:
            shutil.rmtree(root, ignore_errors=True)
    cuda = args.device == "cuda"
    res = {"cards": torch.cuda.device_count() if cuda else 0,
           "card": torch.cuda.get_device_name(0) if cuda else "cpu",
           "cases": rows,
           "ok": all(r["ok"] for r in rows)}
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
