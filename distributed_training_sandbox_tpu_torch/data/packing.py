"""Packed causal-LM windows from a token stream.

Port of the JAX package's ``data/packing.py``: a token stream cut into
(seq_len + 1) windows with ``input_ids = window[:-1]`` and ``labels =
window[1:]``.  Two sources: ``"synthetic"``, a seeded Zipfian stream
(numpy, bit for bit the reference's, or the native C++ engine,
``data/native.py``, whose stream is its own), and ``"corpus"``, a local
text file through a real tokenizer (``transformers``'
``PreTrainedTokenizerFast`` over a committed ``tokenizer.json``,
imported inside the call), as the reference's offline real-text path.
``CORPUS_DOCS`` and ``CORPUS_TOKENIZER`` are the committed corpus;
``corpus_holdout_split`` is the one train / held-out boundary the
flagship twin and ``train.eval_lm`` share.  The TinyStories source and
``"auto"`` need a hub download and stay refused.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
# the committed corpus and its tokenizer (vocab 8192: corpus-70m's and
# corpus-350m's)
CORPUS_DOCS = ROOT / "data" / "corpus" / "docstrings.txt"
CORPUS_TOKENIZER = ROOT / "data" / "corpus" / "tokenizer.json"
# the corpus train / held-out boundary's parameters, the reference's:
# the flagship twin and train.eval_lm split with these values only
CORPUS_HOLDOUT_FRAC = 0.05
CORPUS_HOLDOUT_MIN_WINDOWS = 4


class VocabMismatchError(ValueError):
    """Token ids past the model's vocab: a configuration error, raised
    rather than papered over."""


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


def tokenize_documents(docs, tok, max_docs: int | None = None) -> np.ndarray:
    """Each document tokenized, EOS appended, all concatenated into one
    int32 stream (the reference's per-document loop).  ``tok`` is any
    tokenizer with ``__call__`` and ``eos_token_id``."""
    chunks = []
    for i, doc in enumerate(docs):
        if max_docs is not None and i >= max_docs:
            break
        ids = list(tok(doc)["input_ids"])
        if tok.eos_token_id is not None:
            ids.append(tok.eos_token_id)
        chunks.append(np.asarray(ids, dtype=np.int32))
    if not chunks:
        raise ValueError("no documents to tokenize")
    return np.concatenate(chunks)


def read_corpus_documents(corpus_path) -> list[str]:
    """A text file as documents: its blank-line-separated blocks,
    stripped, empty ones dropped."""
    text = Path(corpus_path).read_text()
    docs = [blk.strip() for blk in text.split("\n\n") if blk.strip()]
    if not docs:
        raise ValueError(f"no documents in {corpus_path}")
    return docs


def load_corpus_tokenizer(tokenizer_file):
    """A committed ``tokenizer.json`` as ``transformers``'
    ``PreTrainedTokenizerFast`` with the reference's special tokens
    (``<eos>``, ``<unk>``)."""
    from transformers import PreTrainedTokenizerFast
    return PreTrainedTokenizerFast(tokenizer_file=str(tokenizer_file),
                                   eos_token="<eos>", unk_token="<unk>")


def get_corpus_tokens(corpus_path, *, tokenizer_file=None,
                      tokenizer_name: str | None = None,
                      max_docs: int | None = None) -> np.ndarray:
    """A local corpus tokenized through a real tokenizer: ``tokenizer_file``
    (a committed ``tokenizer.json``).  ``tokenizer_name`` (a hub name)
    needs a download and is refused."""
    if tokenizer_name is not None:
        raise NotImplementedError(
            f"tokenizer_name={tokenizer_name!r} needs a hub download; "
            f"pass tokenizer_file (a local tokenizer.json)")
    if tokenizer_file is None:
        raise ValueError("need tokenizer_file or tokenizer_name")
    return tokenize_documents(read_corpus_documents(corpus_path),
                              load_corpus_tokenizer(tokenizer_file),
                              max_docs)


def make_packed_dataset(seq_len: int, vocab_size: int, *,
                        num_tokens: int | None = None, seed: int = 42,
                        source: str = "synthetic", engine: str = "numpy",
                        corpus_path=None, tokenizer_file=None,
                        tokenizer_name: str | None = None):
    """(input_ids, labels) windows.  ``source="synthetic"``: a Zipfian
    stream of ``num_tokens`` (default 64 windows' worth) from ``engine``
    (``"numpy"`` or ``"native"``, which raises if the C++ engine cannot
    build or load); ``source="corpus"``: ``corpus_path`` through
    ``tokenizer_file``, packed by ``engine``'s packer, raising
    ``VocabMismatchError`` for ids past ``vocab_size``."""
    if source not in ("tinystories", "synthetic", "auto", "corpus"):
        raise ValueError(f"unknown source {source!r}; expected 'tinystories',"
                         f" 'synthetic', 'corpus' or 'auto'")
    if engine not in ("numpy", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "native":
        from . import native
        if not native.available():
            raise RuntimeError("native data engine unavailable "
                               f"({native.build_error()}); use "
                               f"engine='numpy'")
        sample, pack = native.synthetic_token_stream, native.pack_tokens
    else:
        sample, pack = synthetic_token_stream, pack_tokens
    if source in ("tinystories", "auto"):
        raise NotImplementedError(
            f"source={source!r} needs datasets/transformers, which the "
            f"port does not use; use source='synthetic'")
    if source == "corpus":
        if corpus_path is None:
            raise ValueError("source='corpus' needs corpus_path")
        stream = get_corpus_tokens(corpus_path, tokenizer_file=tokenizer_file,
                                   tokenizer_name=tokenizer_name)
        if stream.max() >= vocab_size:
            raise VocabMismatchError(
                f"corpus token ids go up to {stream.max()}, model vocab is "
                f"{vocab_size}; use a matching tokenizer")
        return pack(stream, seq_len)
    if num_tokens is None:
        num_tokens = 64 * (seq_len + 1)
    return pack(sample(num_tokens, vocab_size, seed), seq_len)


def corpus_holdout_split(input_ids, labels, *,
                         frac: float = CORPUS_HOLDOUT_FRAC,
                         min_windows: int = CORPUS_HOLDOUT_MIN_WINDOWS):
    """The corpus train / held-out split: the tail ``frac`` of the
    windows (at least ``min_windows``) is held out.  Returns ((train
    ids, labels), (held-out ids, labels)); raises where the held-out
    tail would take every window."""
    n_hold = max(int(len(input_ids) * frac), min_windows)
    if n_hold >= len(input_ids):
        raise ValueError(
            f"corpus_holdout_split: holdout of {n_hold} windows would "
            f"consume the whole corpus ({len(input_ids)} windows); need "
            f"more data or smaller frac/min_windows")
    return ((input_ids[:-n_hold], labels[:-n_hold]),
            (input_ids[-n_hold:], labels[-n_hold:]))


def packed_batches(input_ids: np.ndarray, labels: np.ndarray,
                   batch_size: int, *, epochs: int = 1,
                   drop_last: bool = True):
    """Minimal epoch iterator over the windows."""
    n = len(input_ids)
    for _ in range(epochs):
        for i in range(0, n - (batch_size - 1 if drop_last else 0),
                       batch_size):
            yield input_ids[i:i + batch_size], labels[i:i + batch_size]
