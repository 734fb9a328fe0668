"""One-card flagship training: the twin of the JAX package's
``scripts/train_flagship.py`` (``run_leg``).

    python -m distributed_training_sandbox_tpu_torch.train.flagship \
        --num-steps 20 --warmup-steps 5

Runs ``smollm3-3b-l8`` (SmolLM3-3B width, 8 layers) on the card with
AdamW under warmup-cosine, on fresh synthetic Zipfian windows, through
``parallel.fsdp.make_fsdp_train_step`` at one rank; on the card the
attention is the flash kernel, ``fp8_pallas`` the fp8 kernel (K6) and
the int8 precisions the int8 kernels (K5 forward under
``int8_pallas``, K4 for the other int8 products), as the reference
selects its TPU kernels.  ``--precision`` takes every name of
``models.transformer.PRECISIONS``.  The data comes from the numpy
engine (the reference script uses its native engine, whose stream
differs).  ``--ckpt-dir D --checkpoint-every N`` saves RunState
checkpoints (params, Adam state, the seed's generator state, the data
cursor and the losses) under ``D/runstate`` every N steps, and
``--resume`` continues from the newest intact one: the batch stream is
rebuilt and fast-forwarded, the lr series' prefix rebuilt from the
schedule, and the stitched losses equal an uninterrupted run's bit for
bit.  With ``--ckpt-dir`` the final params are also saved alone under
``D/<steps>/`` (``utils.checkpoint``), beside ``runstate/``, for
``train.eval_lm``.

``--data corpus`` trains on the committed corpus (``data/corpus``,
tokenized by its ``tokenizer.json``: ``corpus-70m`` and ``corpus-350m``
have its vocab, 8192): the windows less the held-out tail
(``data.corpus_holdout_split``, which ``train.eval_lm`` scores), in as
many epochs as ``--num-steps`` needs over the usable windows.  The
synthetic data keeps the numpy engine (``--data synthetic``, the
default).

``--spike-demo`` first runs a short leg with no warmup (``--spike-steps``,
30 as the reference's) into the same out dir, to pin the step-2 spike of
Adam's cold second moment that the warmup exists to kill.  Each leg
writes ``<out dir>/<tag>.json`` (the reference's tag, ``--out-dir``,
default ``flagship_results/<platform>``, beside the reference's own
files), and the loss plot reads every leg there: two panels, the whole
series and the first 40 steps, written to ``--plot`` (default
``plots/flagship_loss.png``).  ``matplotlib`` is imported in
:func:`plot`; where it is missing the twin says it wrote no plot and
keeps its JSON.  Not ported: ``--plan`` (ROADMAP.md, A12d).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..data import corpus_holdout_split, make_packed_dataset, packed_batches
from ..data.packing import CORPUS_DOCS, CORPUS_TOKENIZER
from ..device import resolve_device
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..parallel import fsdp, optim
from ..resilience import Checkpointer, RunState, generator_states
from ..utils import checkpoint as CK

DATA = ("synthetic", "corpus")


def leg_batches(vocab_size: int, seq: int, bs: int, num_steps: int,
                seed: int):
    """The numpy (input, label) batches of ``run_leg``, in order: packed
    windows of a synthetic stream long enough for ``num_steps``."""
    n_tokens = num_steps * bs * (seq + 1) + seq + 1
    ii, ll = make_packed_dataset(seq, vocab_size, num_tokens=n_tokens,
                                 seed=seed, source="synthetic")
    return packed_batches(ii, ll, bs)


@functools.lru_cache(maxsize=2)
def corpus_windows(vocab_size: int, seq: int):
    """The committed corpus as windows of ``seq``, split by
    ``corpus_holdout_split``: ((train ids, labels), (held-out ids,
    labels)).  Tokenized once a process for each (vocab, seq); callers
    read the arrays and never write them."""
    ii, ll = make_packed_dataset(seq, vocab_size, source="corpus",
                                 corpus_path=CORPUS_DOCS,
                                 tokenizer_file=CORPUS_TOKENIZER)
    return corpus_holdout_split(ii, ll)


def corpus_batches(vocab_size: int, seq: int, bs: int, num_steps: int):
    """``run_leg``'s corpus batches: the train windows in as many epochs
    as ``num_steps`` batches of ``bs`` need (epochs counted from the
    usable windows, ``len // bs`` a pass).  Exits when the train split
    holds fewer windows than one batch."""
    (ii, ll), (hi, _) = corpus_windows(vocab_size, seq)
    usable = len(ii) // bs
    if not usable:
        raise SystemExit(f"[flagship] corpus too small: {len(ii)} train "
                         f"windows < batch size {bs}")
    epochs = -(-num_steps // usable)
    print(f"[flagship] corpus: {len(ii)} windows x seq {seq} (+{len(hi)} "
          f"held out; {epochs} epoch(s) x {usable} batches for "
          f"{num_steps} steps)", flush=True)
    return packed_batches(ii, ll, bs, epochs=epochs)


def run_leg(model: str, precision: str, seq: int, bs: int, num_steps: int,
            warmup_steps: int, peak_lr: float, *, seed: int = 42,
            device=None, on_step=None, ckpt_dir=None, ckpt_every: int = 0,
            resume: bool = False, data: str = "synthetic") -> dict:
    """Train ``num_steps`` steps; returns the reference's result keys
    (``losses``, ``lrs``, ``tokens_per_second``, ``loss_first``,
    ``loss_max_first20``, ``loss_final_mean20``) and the run's shape.
    ``on_step(i, loss)`` is called after each step's loss has reached
    the host.  With ``ckpt_dir`` and ``ckpt_every`` or ``resume``,
    RunState checkpoints live under ``<ckpt_dir>/runstate``: every
    ``ckpt_every`` steps (asynchronously: this loop syncs every step)
    and once at the end; ``resume`` starts from the newest intact one,
    and ``losses`` and ``lrs`` are then the stitched series
    (``start_step`` says where this segment began).  With ``ckpt_dir``
    the final params are saved alone under ``<ckpt_dir>/<steps>/``.
    ``data``: ``"synthetic"`` (fresh numpy windows) or ``"corpus"``
    (:func:`corpus_batches`)."""
    if data not in DATA:
        raise ValueError(f"data={data!r}; choose from {DATA}")
    dev = resolve_device(device)
    cfg = dataclasses.replace(
        getattr(T, MODEL_REGISTRY[model]), matmul_precision=precision,
        attention_impl="flash" if dev.type == "cuda" else "xla")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen, dev)
    opt = fsdp.init_fsdp_opt_state(params)
    sched = (optim.warmup_cosine_schedule(peak_lr, warmup_steps, num_steps)
             if warmup_steps else None)
    step = fsdp.make_fsdp_train_step(params, cfg, lr=peak_lr,
                                     lr_schedule=sched)
    key = generator_states({"params": seed}, dev)
    ckptr = Checkpointer(Path(ckpt_dir) / "runstate", every=ckpt_every,
                         fingerprint={"strategy": "flagship",
                                      "model": model, "seed": seed,
                                      "precision": precision,
                                      "batch_size": bs, "seq": seq}) \
        if ckpt_dir and (ckpt_every or resume) else None
    start, prior = 0, []
    if resume and ckptr is not None:
        rs = ckptr.restore_latest(RunState(params=params, opt_state=opt,
                                           prng_key=key))
        if rs is not None:
            params, opt, start = rs.params, rs.opt_state, rs.step + 1
            prior = list(rs.loss_log)
            print(f"[flagship] resumed from step {rs.step} "
                  f"({len(prior)} losses) in {ckptr.directory}")
    # the lr series is the schedule's: rebuild the restored prefix
    losses = list(prior)
    lrs = [sched(i) if sched else peak_lr for i in range(start)]
    times = []
    batches = (corpus_batches(cfg.vocab_size, seq, bs, num_steps)
               if data == "corpus" else
               leg_batches(cfg.vocab_size, seq, bs, num_steps, seed))
    try:
        t0 = time.perf_counter()
        for i, (ib, lb) in enumerate(itertools.islice(batches, start, None),
                                     start=start):
            if i >= num_steps:
                break
            batch = (torch.as_tensor(ib, device=dev),
                     torch.as_tensor(lb, device=dev))
            params, opt, loss = step(params, opt, batch)
            losses.append(float(loss))   # a host sync: the step has ended
            lrs.append(sched(i) if sched else peak_lr)
            times.append(time.perf_counter() - t0)
            if ckptr is not None:
                # every step is a sync point of this loop
                ckptr.maybe_save(i, lambda i=i: RunState(
                    params=params, opt_state=opt, step=i,
                    data_cursor=i + 1, prng_key=key,
                    loss_log=list(losses)), synced=True)
            if on_step is not None:
                on_step(i, losses[-1])
        if ckptr is not None and losses:
            ckptr.save_final(RunState(
                params=params, opt_state=opt, step=len(losses) - 1,
                data_cursor=len(losses), prng_key=key,
                loss_log=list(losses)))
    finally:
        if ckptr is not None:
            ckptr.close()
    if ckpt_dir and losses:
        # the params alone, for train.eval_lm's restore_params
        with CK.closing(CK.checkpoint_manager(ckpt_dir)) as mgr:
            CK.save_state(mgr, len(losses), {"params": params}, wait=False)
        print(f"[flagship] checkpoint step {len(losses)} -> {ckpt_dir}",
              flush=True)
    # tokens/s over the steps after the first two (the reference's
    # window: compile there, kernel builds and allocator warm-up here).
    # The reference counts len - 1 steps' tokens over that window of
    # len - 2 steps; this counts len - 2.
    n_timed, dt = ((len(times) - 2, times[-1] - times[1]) if len(times) > 2
                   else (len(times), times[-1] if times else 0.0))
    tok_s = n_timed * bs * seq / dt if dt > 0 else 0.0
    return {"start_step": start,
        "model": model, "precision": precision, "sequence_length": seq,
        "batch_size": bs, "data": data, "num_steps": len(losses),
        "warmup_steps": warmup_steps, "peak_lr": peak_lr,
        "device": str(dev), "tokens_per_second": tok_s,
        "loss_first": losses[0], "loss_max_first20": max(losses[:20]),
        "loss_final_mean20": float(np.mean(losses[-20:])),
        "losses": losses, "lrs": lrs, "step_times_s": times,
    }


def leg_tag(result: dict) -> str:
    """The reference's file tag of a leg's result."""
    warm = (f"warm{result['warmup_steps']}" if result["warmup_steps"]
            else "nowarm")
    corp = "_corpus" if result["data"] == "corpus" else ""
    return (f"{result['model']}_{result['precision']}_seq"
            f"{result['sequence_length']}_b{result['batch_size']}_{warm}"
            f"{corp}")


def write_leg(result: dict, out_dir) -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{leg_tag(result)}.json"
    path.write_text(json.dumps(result))
    return path


def plot(out_dir, plot_path) -> Path | None:
    """The reference's loss plot of every leg in ``out_dir``: the whole
    series and the first 40 steps (the spike zone).  None, and a line
    saying so, where matplotlib is missing or there is no leg."""
    try:
        import matplotlib
    except ImportError:
        print("[flagship] matplotlib is not installed: wrote no plot "
              "(the legs' JSON stays)", flush=True)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = sorted(Path(out_dir).glob("*.json"))
    if not runs:
        return None
    fig, (ax, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    for f in runs:
        r = json.loads(f.read_text())
        warm = (f"warmup {r['warmup_steps']}" if r["warmup_steps"]
                else "no warmup")
        label = f"{r['precision']} b{r['batch_size']} {warm}"
        ax.plot(r["losses"], label=label, lw=1)
        ax2.plot(r["losses"][:40], label=label, lw=1)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.set_title("flagship loss (full run)")
    ax2.set_xlabel("step")
    ax2.set_title("first 40 steps (spike zone)")
    ax.legend(fontsize=7)
    ax2.legend(fontsize=7)
    fig.tight_layout()
    plot_path = Path(plot_path)
    plot_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(plot_path, dpi=120)
    plt.close(fig)
    print(f"[flagship] plot -> {plot_path}", flush=True)
    return plot_path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY),
                   default="smollm3-3b-l8")
    p.add_argument("--precision", default="fp8_pallas",
                   choices=list(T.PRECISIONS))
    p.add_argument("--sequence-length", type=int, default=8192)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--num-steps", type=int, default=500)
    p.add_argument("--warmup-steps", type=int, default=50)
    p.add_argument("--peak-lr", type=float, default=3e-4)
    p.add_argument("--data", choices=DATA, default="synthetic",
                   help="'corpus': the committed corpus less its held-out "
                        "tail")
    p.add_argument("--ckpt-dir", default=None,
                   help="RunState checkpoints under DIR/runstate, the final "
                        "params under DIR/<steps>")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest intact checkpoint")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' for the plain path")
    p.add_argument("--out", default=None, help="write the result as JSON")
    p.add_argument("--spike-demo", action="store_true",
                   help="first run a short no-warmup leg to pin the "
                        "cold-Adam step-2 spike")
    p.add_argument("--spike-steps", type=int, default=30,
                   help="the spike leg's steps (the reference's 30)")
    p.add_argument("--out-dir", default=None,
                   help="each leg's <tag>.json (default "
                        "flagship_results/<platform>)")
    p.add_argument("--plot", default="plots/flagship_loss.png")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out_dir = Path(args.out_dir or Path("flagship_results") / (
        "gpu" if dev.type == "cuda" else dev.type))

    def log_step(i, loss):
        print(f"[flagship] step {i:4d} loss {loss:8.4f}", flush=True)

    if args.spike_demo:
        spike = run_leg(args.model, args.precision, args.sequence_length,
                        args.batch_size, args.spike_steps, 0, args.peak_lr,
                        device=dev, data=args.data, on_step=log_step)
        print(f"[flagship] spike leg -> {write_leg(spike, out_dir)}",
              flush=True)
    result = run_leg(
        args.model, args.precision, args.sequence_length, args.batch_size,
        args.num_steps, args.warmup_steps, args.peak_lr, device=dev,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.checkpoint_every,
        resume=args.resume, data=args.data, on_step=log_step)
    print(f"[flagship] first {result['loss_first']:.3f} max(first20) "
          f"{result['loss_max_first20']:.3f} final(mean20) "
          f"{result['loss_final_mean20']:.3f} "
          f"{result['tokens_per_second']:.0f} tok/s -> "
          f"{write_leg(result, out_dir)}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result))
    plot(out_dir, args.plot)


if __name__ == "__main__":
    main()
