"""Held-out evaluation of a language model: the twin of the JAX package's
``scripts/eval_lm.py``.

    python -m distributed_training_sandbox_tpu_torch.train.eval_lm \
        --model corpus-70m --data corpus --ckpt-dir runs/flagship

Scores the held-out tail of the windows (``data.corpus_holdout_split``,
the boundary the flagship twin's ``--data corpus`` leaves out of
training) with ``lm_loss``, batch by batch, and prints one JSON line:
the mean loss, its perplexity, the windows, steps and tokens scored and
the restored step.  The params are the fresh init from seed 42 (the
flagship twin's; the number a training run has to beat) or, with
``--ckpt-dir``, the newest params-only step written there
(``utils.checkpoint.restore_params``, as ``train.flagship`` saves them).
``--data synthetic`` scores the held-out tail of 64 batches' worth of
synthetic windows instead.  The card by default (the flash kernels
for attention), ``--device cpu`` for the plain path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..data import corpus_holdout_split, make_packed_dataset, packed_batches
from ..device import resolve_device
from ..models import MODEL_REGISTRY
from ..models import transformer as T
from ..utils.checkpoint import restore_params
from .flagship import DATA, corpus_windows

SEED = 42


def holdout(data: str, vocab_size: int, seq: int, bs: int):
    """The held-out (input_ids, labels) windows of ``data``."""
    if data == "corpus":
        _, (ii, ll) = corpus_windows(vocab_size, seq)
        return ii, ll
    ii, ll = make_packed_dataset(seq, vocab_size,
                                 num_tokens=64 * bs * (seq + 1),
                                 source="synthetic")
    _, (ii, ll) = corpus_holdout_split(ii, ll)
    return ii, ll


@torch.no_grad()
def evaluate(params: dict, cfg: T.TransformerConfig, ii: np.ndarray,
             ll: np.ndarray, bs: int, device) -> tuple[float, int]:
    """(mean ``lm_loss`` over the batches of ``bs`` windows, the batch
    count); each batch's loss reaches the host as an f32 scalar and the
    mean is taken in Python floats, as the reference's loop does."""
    tot, steps = 0.0, 0
    for ib, lb in packed_batches(ii, ll, bs):
        batch = (torch.as_tensor(ib, device=device),
                 torch.as_tensor(lb, device=device))
        tot += float(T.lm_loss(params, batch, cfg))
        steps += 1
    return tot / max(steps, 1), steps


def run(model: str = "corpus-350m", data: str = "corpus", seq: int = 2048,
        bs: int = 4, ckpt_dir=None, precision: str = "bf16",
        device=None) -> dict:
    """Score the held-out windows; returns the reference's JSON keys."""
    if data not in DATA:
        raise ValueError(f"data={data!r}; choose from {DATA}")
    dev = resolve_device(device)
    cfg = getattr(T, MODEL_REGISTRY[model])
    if precision.startswith("int8"):
        cfg = dataclasses.replace(cfg, matmul_precision=precision)
    cfg = dataclasses.replace(
        cfg, attention_impl="flash" if dev.type == "cuda" else "xla")
    ii, ll = holdout(data, cfg.vocab_size, seq, bs)
    # a small holdout may hold fewer windows than a batch
    bs = min(bs, len(ii))
    print(f"[eval] holdout: {len(ii)} windows × seq {seq} (batch {bs})",
          flush=True)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           dev)
    restored = None
    if ckpt_dir:
        params, restored = restore_params(ckpt_dir, params, tag="eval")
    loss, steps = evaluate(params, cfg, ii, ll, bs, dev)
    return {"model": model, "data": data, "sequence_length": seq,
            "holdout_windows": len(ii), "eval_steps": steps,
            "eval_tokens": steps * bs * seq, "restored_step": restored,
            "eval_loss": round(loss, 4),
            "perplexity": round(float(np.exp(loss)), 2)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=sorted(MODEL_REGISTRY),
                   default="corpus-350m")
    p.add_argument("--data", choices=DATA, default="corpus")
    p.add_argument("--sequence-length", type=int, default=2048)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--ckpt-dir", default=None,
                   help="restore the newest params-only step there; default "
                        "scores the fresh init")
    p.add_argument("--precision", default="bf16")
    p.add_argument("--device", default=None,
                   help="default: the CUDA card; 'cpu' for the plain path")
    p.add_argument("--out-file", default=None)
    args = p.parse_args(argv)
    out = run(args.model, args.data, args.sequence_length, args.batch_size,
              args.ckpt_dir, args.precision, args.device)
    print(json.dumps(out), flush=True)
    if args.out_file:
        Path(args.out_file).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
