"""Packed causal-LM windows from a token stream.

Port of the JAX package's ``data/packing.py`` for the synthetic source:
a seeded Zipfian token stream, cut into (seq_len + 1) windows with
``input_ids = window[:-1]`` and ``labels = window[1:]``.  Both packages
build it with numpy, so the windows are bit for bit the reference's.
Not ported: the native C++ engine (ROADMAP.md queue A item 4) and the
TinyStories and corpus sources, which need ``datasets`` and
``transformers``.
"""

from __future__ import annotations

import numpy as np


def pack_tokens(tokens: np.ndarray,
                seq_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Token stream → (input_ids, labels), each (n_windows, seq_len)
    int32; window stride seq_len + 1, the ragged tail dropped."""
    tokens = np.asarray(tokens).reshape(-1)
    window = seq_len + 1
    n = len(tokens) // window
    if n == 0:
        raise ValueError(f"stream of {len(tokens)} tokens too short for one "
                         f"window of {window}")
    w = tokens[: n * window].reshape(n, window)
    return w[:, :-1].astype(np.int32), w[:, 1:].astype(np.int32)


def synthetic_token_stream(num_tokens: int, vocab_size: int,
                           seed: int = 42) -> np.ndarray:
    """Seeded Zipfian token stream (p ∝ 1 / rank)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab_size, size=num_tokens, p=probs).astype(np.int32)


def make_packed_dataset(seq_len: int, vocab_size: int, *,
                        num_tokens: int | None = None, seed: int = 42,
                        source: str = "synthetic", engine: str = "numpy"):
    """(input_ids, labels) windows of a synthetic stream of
    ``num_tokens`` (default 64 windows' worth)."""
    if engine == "native":
        raise NotImplementedError(
            "engine='native' is not ported yet — see ROADMAP.md, queue A "
            "item 4 (data); use engine='numpy'")
    if engine != "numpy":
        raise ValueError(f"unknown engine {engine!r}")
    if source in ("tinystories", "corpus", "auto"):
        raise NotImplementedError(
            f"source={source!r} needs datasets/transformers, which the "
            f"port does not use; use source='synthetic'")
    if source != "synthetic":
        raise ValueError(f"unknown source {source!r}")
    if num_tokens is None:
        num_tokens = 64 * (seq_len + 1)
    return pack_tokens(synthetic_token_stream(num_tokens, vocab_size, seed),
                       seq_len)


def packed_batches(input_ids: np.ndarray, labels: np.ndarray,
                   batch_size: int, *, epochs: int = 1,
                   drop_last: bool = True):
    """Minimal epoch iterator over the windows."""
    n = len(input_ids)
    for _ in range(epochs):
        for i in range(0, n - (batch_size - 1 if drop_last else 0),
                       batch_size):
            yield input_ids[i:i + batch_size], labels[i:i + batch_size]
