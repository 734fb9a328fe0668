"""Sentence-pair classification data: the port of the JAX package's
``data/classification.py`` (the DDP classification leg's data).

Examples are dicts ``{"input_ids": list[int], "labels": int}``.  The
synthetic source makes deterministic pairs of variable length whose
label a model can learn (1 iff the second span reuses the first span's
most frequent token); ``pad_collate`` pads a batch to its longest row
rounded up to a multiple of 8 (the reference's ``tokenizer.pad(padding=
"longest", pad_to_multiple_of=8)``); ``shard_examples`` gives each rank
a contiguous shard, the remainder to the last; ``classification_batches``
draws each rank's rows from its own shard and collates the global batch,
rank-major, to one width.  All of it is numpy, so every example and
batch is the reference's bit for bit.  GLUE MRPC needs a hub download:
``source="mrpc"`` is refused and ``"auto"`` takes the synthetic pairs,
as the reference does offline.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_pair_examples", "make_classification_examples",
           "pad_collate", "shard_examples", "classification_batches"]


def synthetic_pair_examples(n_examples: int, vocab_size: int,
                            seed: int = 42, min_len: int = 16,
                            max_len: int = 96) -> list[dict]:
    """Deterministic pairs ``a [sep] b`` (sep = vocab_size - 1); label 1
    iff ``b`` reuses ``a``'s most frequent token."""
    rng = np.random.default_rng(seed)
    sep = vocab_size - 1
    out = []
    for _ in range(n_examples):
        la, lb = rng.integers(min_len // 2, max_len // 2, size=2)
        a = rng.integers(1, vocab_size - 1, size=la)
        b = rng.integers(1, vocab_size - 1, size=lb)
        label = int(rng.random() < 0.5)
        dominant = np.bincount(a).argmax()
        if label:
            b[rng.integers(0, lb, size=max(lb // 4, 1))] = dominant
        else:
            b = b[b != dominant]
            if len(b) == 0:
                b = np.array([1 + (dominant + 1) % (vocab_size - 2)])
        ids = np.concatenate([a, [sep], b]).astype(np.int32)
        out.append({"input_ids": ids.tolist(), "labels": label})
    return out


def make_classification_examples(vocab_size: int, *, n_examples: int = 2048,
                                 seed: int = 42,
                                 source: str = "auto") -> list[dict]:
    """``source``: ``"synthetic"``; ``"auto"`` (the synthetic pairs, with
    the reference's offline fallback line); ``"mrpc"`` is refused."""
    if source not in ("mrpc", "synthetic", "auto"):
        raise ValueError(f"unknown source {source!r}")
    if source == "mrpc":
        raise NotImplementedError(
            "source='mrpc' needs the GLUE MRPC download (datasets' "
            "load_dataset('glue', 'mrpc') and a hub tokenizer), which the "
            "port does not fetch; use source='synthetic'")
    if source == "auto":
        print("[data] GLUE MRPC unusable (OSError: hub unreachable); "
              "falling back to synthetic pairs", flush=True)
    return synthetic_pair_examples(n_examples, vocab_size, seed)


def pad_collate(examples: list[dict], *, pad_to_multiple_of: int = 8,
                pad_id: int = 0) -> dict:
    """Examples → ``input_ids`` and ``attention_mask`` (B, width) and
    ``labels`` (B,), int32: each row right-padded with ``pad_id`` to the
    longest row rounded up to a multiple of ``pad_to_multiple_of``."""
    longest = max(len(e["input_ids"]) for e in examples)
    m = pad_to_multiple_of
    width = -(-longest // m) * m
    B = len(examples)
    input_ids = np.full((B, width), pad_id, np.int32)
    mask = np.zeros((B, width), np.int32)
    labels = np.empty((B,), np.int32)
    for i, e in enumerate(examples):
        ids = e["input_ids"]
        input_ids[i, :len(ids)] = ids
        mask[i, :len(ids)] = 1
        labels[i] = e["labels"]
    return {"input_ids": input_ids, "attention_mask": mask,
            "labels": labels}


def shard_examples(examples: list, rank: int, ws: int) -> list:
    """Rank ``rank``'s contiguous shard: ``len // ws`` examples each, the
    last rank running to the end."""
    per = len(examples) // ws
    start = rank * per
    end = start + per if rank != ws - 1 else len(examples)
    return examples[start:end]


def classification_batches(examples: list[dict], batch_size: int, ws: int,
                           *, seed: int = 42, epochs: int = 1,
                           pad_to_multiple_of: int = 8):
    """Global batches: each rank draws ``batch_size // ws`` rows from its
    own shard (shuffled each epoch, the ragged tail dropped), the global
    batch is the ranks' rows rank-major, collated to one width."""
    rng = np.random.default_rng(seed)
    shards = [shard_examples(examples, r, ws) for r in range(ws)]
    per_rank = batch_size // ws
    if per_rank == 0:
        raise ValueError(f"batch_size {batch_size} < world size {ws}")
    steps = min(len(s) for s in shards) // per_rank
    for _ in range(epochs):
        orders = [rng.permutation(len(s)) for s in shards]
        for b in range(steps):
            chosen = []
            for r, shard in enumerate(shards):
                idx = orders[r][b * per_rank:(b + 1) * per_rank]
                chosen += [shard[i] for i in idx]
            yield pad_collate(chosen, pad_to_multiple_of=pad_to_multiple_of)
