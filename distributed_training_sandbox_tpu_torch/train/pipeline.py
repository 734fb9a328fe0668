"""Pipeline-parallel training: the twin of the JAX package's
``scripts/_pp_driver.py`` and of the ``gpipe.py``, ``1f1b.py`` and
``interleaved_1f1b.py`` scripts that share it.  A module name cannot
start with a digit, so the three scripts are one flag, ``--schedule``.

    python -m distributed_training_sandbox_tpu_torch.train.pipeline \\
        --schedule 1f1b --n-stages 4
    python -m distributed_training_sandbox_tpu_torch.train.pipeline \\
        --schedule interleaved --n-stages 8 --virtual-per-device 2
    python -m distributed_training_sandbox_tpu_torch.train.pipeline \\
        --model smollm3-3b --n-stages 4 --schedule gpipe --num-epochs 3
    python -m distributed_training_sandbox_tpu_torch.train.pipeline \\
        --device cpu --schedule 1f1b --num-epochs 2

One process drives every stage.  Stages go on ``cuda:0 … cuda:D−1``,
cycling over the cards (the interleaved schedule on ``--n-stages /
--virtual-per-device`` of them); with ``--device cpu`` every stage is on
the CPU, the interleaved clock counting that many logical devices.  The
model is the reference's PP toy (``--model mlp``: 50 → 4 × 500 → 50,
mean squared error) or a transformer staged by
``build_transformer_pipeline``, seeded from ``--seed``.  Each epoch
draws a fresh batch from one generator seeded with ``--seed`` + 1:
randn inputs and targets for the toy, and for the transformer packed
windows of ``--seq`` + 1 random tokens, inputs ``w[:-1]`` and labels
``w[1:]``, as ``_pp_driver.py``'s.  ``--opt8`` keeps each stage's Adam
moments int8 at rest (``parallel.optim8``).  The JSON printed (and
written to ``--results-file``) is ``PipeResult.as_dict()`` plus the
shim's collectives against the ``gpipe`` / ``1f1b`` contract (zero of
every kind), each epoch's step time and the memory of each card.

Not wired yet, with the ROADMAP.md queue A item that holds each: the run
harness that the other twins run under (``train.harness``: the
supervisor, RunState checkpoints, the prefetcher, the profiler) with
resume by the epoch cursor of ``scripts/_pp_driver.py`` (A8);
``evaluate_contract``'s verdict (A12; the shim's counts against
``parallel.contracts`` stand in for it).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import MODEL_REGISTRY, mlp
from ..models import transformer as T
from ..ops import collectives as C
from ..parallel import optim
from ..parallel import pipeline as PP
from ..parallel.contracts import step_collectives
from ..utils.memory import MB, device_memory_stats

SCHEDULES = ("gpipe", "1f1b", "interleaved")
MODELS = ("mlp",) + tuple(sorted(MODEL_REGISTRY))
# ``_pp_driver.py``'s flags that this twin refuses: flag -> why
NOT_PORTED = {
    "resume": "resume by the epoch cursor is not wired into the pipeline "
              "twin yet — see ROADMAP.md, queue A item A8",
    "checkpoint_dir": "the pipeline twin does not write RunState "
                      "checkpoints yet — see ROADMAP.md, queue A item A8",
    "max_restarts": "the pipeline twin does not run under the supervisor "
                    "yet — see ROADMAP.md, queue A item A8",
    "prefetch_depth": "the pipeline twin does not use the device "
                      "prefetcher yet — see ROADMAP.md, queue A item A8",
    "trace_dir": "the pipeline twin does not run the profiler yet — see "
                 "ROADMAP.md, queue A item A8",
}


def stage_devices(schedule: str, n_stages: int, virtual_per_device: int,
                  device=None) -> list[torch.device]:
    """The devices ``build_pipeline`` cycles over: every card; for the
    interleaved schedule ``n_stages / virtual_per_device`` logical
    devices, placed on the cards in turn (two on one card share it), or
    on the CPU."""
    dev = resolve_device(device)
    n_dev = None
    if schedule == "interleaved":
        if n_stages % virtual_per_device:
            raise ValueError(f"--n-stages {n_stages} not divisible by "
                             f"--virtual-per-device {virtual_per_device}")
        n_dev = n_stages // virtual_per_device
    if dev.type == "cpu":
        return [dev] * (n_dev or 1)
    cards = PP.default_devices()
    return cards if n_dev is None else [cards[i % len(cards)]
                                        for i in range(n_dev)]


def epoch_batches(cfg, batch_size: int, seq: int, seed: int, device):
    """A fresh (inputs, targets) batch an epoch, on ``device``, from one
    generator seeded with ``seed + 1``: randn pairs of the toy's widths
    (``cfg`` None), or packed token windows of ``cfg``'s vocabulary."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    while True:
        if cfg is None:
            yield (torch.randn(batch_size, mlp.PP_TOY_SIZES[0],
                               generator=gen, device=device),
                   torch.randn(batch_size, mlp.PP_TOY_SIZES[-1],
                               generator=gen, device=device))
        else:
            w = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1),
                              generator=gen, device=device)
            yield w[:, :-1], w[:, 1:]


def build_stages(model: str, schedule: str, n_stages: int,
                 virtual_per_device: int, seed: int, device=None,
                 opt8: bool = False):
    """``(stages, cfg)``: the seeded model split over ``stage_devices``
    (``cfg`` None for the toy); ``opt8``: int8 Adam moments."""
    devs = stage_devices(schedule, n_stages, virtual_per_device, device)
    gen = torch.Generator(device=devs[0]).manual_seed(seed)
    if model == "mlp":
        return PP.build_pipeline(mlp.pp_toy_mlp(gen, device=devs[0]),
                                 n_stages, devices=devs, opt8=opt8), None
    cfg = getattr(T, MODEL_REGISTRY[model])
    params = T.init_params(cfg, gen, devs[0])
    return PP.build_transformer_pipeline(params, cfg, n_stages,
                                         devices=devs, opt8=opt8), cfg


def run(schedule: str = "1f1b", *, model: str = "mlp", n_stages: int = 2,
        virtual_per_device: int = 2, n_micro: int = 4, lr: float = 1e-3,
        warmup_epochs: int = 0, num_epochs: int = 16, batch_size: int = 64,
        seq: int = 256, seed: int = 42, device=None, opt8: bool = False,
        on_step=None, log=print) -> dict:
    """Train ``num_epochs`` pipeline steps of ``schedule``;
    ``on_step(epoch, loss)`` is called once each epoch's loss has
    reached the host.  Returns ``PipeResult.as_dict()`` plus
    ``"contract"`` (the shim's collectives of each epoch against
    ``parallel.contracts``), ``"step_ms"`` (each epoch on the host
    clock, until its loss reaches the host), ``"final_loss_batch0"``
    (the first batch's loss under the final params: fresh batches move
    the epoch losses by their draw more than a few steps move the
    model), ``"devices"`` and ``"start_memory_mb"`` (each card's
    allocated MB when training starts; ``"peak_memory_mb"`` holds its
    peak since then); for a
    transformer also ``"tokens_per_s"`` (over the median epoch after the
    first) and ``"model_flops_per_token"``."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule={schedule!r}; choose from {SCHEDULES}")
    stages, cfg = build_stages(model, schedule, n_stages, virtual_per_device,
                               seed, device, opt8)
    cards = list(dict.fromkeys(s.device for s in stages
                               if s.device.type == "cuda"))
    start = {}
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        start[str(d)] = device_memory_stats(d)["bytes_in_use"] / MB
    batches = epoch_batches(cfg, batch_size, seq, seed, stages[0].device)
    first = []

    def make_batch(epoch):
        batch = next(batches)
        if not first:
            first.append(batch)
        return batch

    log(f"[{schedule}] model={model} stages={len(stages)} micro={n_micro} "
        f"batch={batch_size}" + (f" seq={seq}" if cfg else "")
        + f" devices={[str(s.device) for s in stages]}")
    cname = schedule if schedule in ("gpipe", "1f1b") else "1f1b"
    n_leaves = sum(len(list(optim.tree_leaves(s.params))) for s in stages)
    want = step_collectives(cname, n_leaves)
    counts, step_ms, marks = [], [], {}

    def on_epoch(epoch, loss):
        now = time.perf_counter()
        step_ms.append((now - marks["t"]) * 1e3)
        marks["t"] = now
        counts.append(C.COLLECTIVES.read())
        C.COLLECTIVES.reset()
        if epoch % 4 == 0 or epoch == num_epochs - 1:
            log(f"[{schedule}] epoch {epoch:3d} loss {loss:.6f}")
        if on_step is not None:
            on_step(epoch, loss)

    if warmup_epochs:
        def lr_fn(e):
            return lr * min(1.0, (e + 1) / warmup_epochs)
    else:
        lr_fn = lr
    C.COLLECTIVES.reset()
    marks["t"] = time.perf_counter()
    result = PP.train_pipeline(stages, schedule, make_batch,
                               num_epochs=num_epochs, n_micro=n_micro,
                               lr=lr_fn, log=on_epoch)
    out = result.as_dict()
    out["contract"] = {"name": cname, "expected": want,
                       "collectives": counts,
                       "holds": all(c == want for c in counts)}
    out["step_ms"] = step_ms
    out["final_loss_batch0"] = PP.pipeline_loss(stages, *first[0])
    if cfg is not None and len(step_ms) > 1:
        out["tokens_per_s"] = (batch_size * seq * 1e3
                               / float(np.median(step_ms[1:])))
        out["model_flops_per_token"] = T.model_flops_per_token(cfg, seq)
    out["devices"] = [str(s.device) for s in stages]
    out["start_memory_mb"] = start
    log(f"[{schedule}] contract[{cname}]: collectives a step "
        f"{json.dumps(C.COLLECTIVES.nonzero(counts[-1]) if counts else {})}"
        f", holds {out['contract']['holds']}")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--schedule", choices=SCHEDULES, default="1f1b")
    p.add_argument("--n-stages", type=int, default=2,
                   help="stage count; for the interleaved schedule the "
                        "virtual-stage count D·V")
    p.add_argument("--virtual-per-device", type=int, default=2,
                   help="interleaved only: V chunks a device")
    p.add_argument("--n-micro", type=int, default=4)
    p.add_argument("--model", choices=MODELS, default="mlp")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup-epochs", type=int, default=0)
    p.add_argument("--results-file", default=None)
    p.add_argument("--num-epochs", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--seq", type=int, default=256,
                   help="the transformer's sequence length")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="default: the CUDA cards; 'cpu' for the CPU")
    p.add_argument("--opt8", action="store_true",
                   help="int8 Adam moments at rest (parallel.optim8)")
    p.add_argument("--resume", action="store_true", help="not ported (A8)")
    for flag in ("checkpoint-dir", "max-restarts", "prefetch-depth",
                 "trace-dir"):
        p.add_argument(f"--{flag}", default=None, help="not ported (A8)")
    args = p.parse_args(argv)
    for name, why in NOT_PORTED.items():
        if getattr(args, name) not in (None, False):
            raise NotImplementedError(f"--{name.replace('_', '-')}: {why}")
    out = run(args.schedule, model=args.model, n_stages=args.n_stages,
              virtual_per_device=args.virtual_per_device,
              n_micro=args.n_micro, lr=args.lr,
              warmup_epochs=args.warmup_epochs, num_epochs=args.num_epochs,
              batch_size=args.batch_size, seq=args.seq, seed=args.seed,
              device=args.device, opt8=args.opt8)
    print(f"[{args.schedule}] {json.dumps(out)}", flush=True)
    if args.results_file:
        Path(args.results_file).write_text(json.dumps(out, indent=2))
        print(f"[{args.schedule}] results -> {args.results_file}")
    if not (np.all(np.isfinite(out["losses"])) and out["contract"]["holds"]):
        raise SystemExit(f"non-finite loss in {out['losses']} or "
                         f"collectives off the contract")


if __name__ == "__main__":
    main()
