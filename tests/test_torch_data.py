"""The port's data tier (``data/native.py``, ``data/packing.py``'s corpus
source and held-out split, ``data/classification.py``) against the JAX
package's, on the CPU: every stream, window, split, example and batch
bit-equal.

The native engine is built by each package from the same committed
source, ``native/dtsdata.cpp`` (the port into ``build/native/``), so its
streams agree bit for bit; the port's Zipf stream at ``chip_smoke``'s
(n, vocab, seed) has the SHA-256 digest that phase 20d checks on the
card's host.  Only the synthetic classification source is compared:
the reference's ``"auto"`` asks the hub, which the port never does.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from distributed_training_sandbox_tpu.data import classification as RC
from distributed_training_sandbox_tpu.data import native as RN
from distributed_training_sandbox_tpu.data import packing as RP
from distributed_training_sandbox_tpu_torch.data import classification as PC
from distributed_training_sandbox_tpu_torch.data import native as PN
from distributed_training_sandbox_tpu_torch.data import packing as PP

FIX = Path(__file__).parent / "fixtures"
CORPUS = FIX / "tiny_corpus.txt"
TOKENIZER = FIX / "tokenizer.json"
FIXTURE_VOCAB = 512


@pytest.fixture(scope="module")
def engines():
    if not RN.available():
        pytest.skip(f"the reference's native engine: {RN.build_error()}")
    assert PN.available(), PN.build_error()
    return RN, PN


@pytest.mark.parametrize("n,vocab,seed", [(1, 2, 0), (1000, 64, 3),
                                          (100_003, 8192, 42),
                                          (50_000, 128_256, 7)])
def test_native_zipf_stream_is_the_references(engines, n, vocab, seed):
    got = PN.synthetic_token_stream(n, vocab, seed)
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, RN.synthetic_token_stream(n, vocab,
                                                                 seed))


def test_native_zipf_digest_is_the_smokes(engines):
    """Phase 20d's digest on the card's host: the reference's stream at
    ``chip_smoke.NATIVE_ZIPF`` hashes to ``NATIVE_ZIPF_DIGEST``, and so
    does the port's."""
    n, vocab, seed = chip_smoke.NATIVE_ZIPF
    for eng in engines:
        s = eng.synthetic_token_stream(n, vocab, seed)
        assert hashlib.sha256(s.tobytes()).hexdigest() \
            == chip_smoke.NATIVE_ZIPF_DIGEST


@pytest.mark.parametrize("n,seq", [(17, 4), (4097, 64), (10_000, 8191)])
def test_native_packer_equals_numpy_and_the_reference(engines, n, seq):
    tokens = np.random.default_rng(n).integers(0, 1000, n).astype(np.int32)
    got = PN.pack_tokens(tokens, seq)
    for want in (PP.pack_tokens(tokens, seq), RN.pack_tokens(tokens, seq),
                 RP.pack_tokens(tokens, seq)):
        for a, b in zip(got, want):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="too short"):
        PN.pack_tokens(tokens[:seq], seq)


@pytest.mark.parametrize("n,seed", [(1, 0), (10, 1), (9973, 5)])
def test_native_shuffle_is_the_references_permutation(engines, n, seed):
    got = PN.shuffle_indices(n, seed)
    np.testing.assert_array_equal(got, RN.shuffle_indices(n, seed))
    assert sorted(got.tolist()) == list(range(n))


def test_native_library_builds_under_build_never_native(engines):
    """The port's library lives in ``build/native/``, named by a hash of
    the source, and loads from there; nothing is written next to the
    source."""
    lib = PN._library_path()
    assert lib.parent == PN.BUILD_DIR and lib.exists()
    assert PN.BUILD_DIR.parts[-2:] == ("build", "native")
    assert PN.SOURCE.parent.name == "native"
    digest = hashlib.sha256(PN.SOURCE.read_bytes()).hexdigest()[:16]
    assert digest in lib.name
    assert not list(PN.SOURCE.parent.glob(".libdtsdata-*"))


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_make_packed_dataset_synthetic_is_the_references(engines, engine):
    got = PP.make_packed_dataset(32, 300, num_tokens=5000, seed=9,
                                 source="synthetic", engine=engine)
    want = RP.make_packed_dataset(32, 300, num_tokens=5000, seed=9,
                                  source="synthetic", engine=engine)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_refusals_keep_their_messages():
    with pytest.raises(NotImplementedError, match="datasets/transformers"):
        PP.make_packed_dataset(8, 100, source="auto")
    with pytest.raises(NotImplementedError, match="datasets/transformers"):
        PP.make_packed_dataset(8, 100, source="tinystories")
    with pytest.raises(ValueError, match="unknown source"):
        PP.make_packed_dataset(8, 100, source="nope")
    with pytest.raises(ValueError, match="unknown engine"):
        PP.make_packed_dataset(8, 100, engine="nope")
    with pytest.raises(ValueError, match="corpus_path"):
        PP.make_packed_dataset(8, 100, source="corpus")
    with pytest.raises(NotImplementedError, match="hub download"):
        PP.get_corpus_tokens(CORPUS, tokenizer_name="some/hub-name")


def test_corpus_documents_and_tokens_are_the_references():
    assert PP.read_corpus_documents(CORPUS) \
        == RP.read_corpus_documents(CORPUS)
    got = PP.get_corpus_tokens(CORPUS, tokenizer_file=TOKENIZER)
    want = RP.get_corpus_tokens(CORPUS, tokenizer_file=TOKENIZER)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    tok = PP.load_corpus_tokenizer(TOKENIZER)
    docs = PP.read_corpus_documents(CORPUS)
    np.testing.assert_array_equal(
        PP.tokenize_documents(docs, tok, max_docs=3),
        RP.tokenize_documents(docs, tok, max_docs=3))
    with pytest.raises(ValueError, match="no documents"):
        PP.tokenize_documents([], tok)


@pytest.mark.parametrize("engine", ["numpy", "native"])
@pytest.mark.parametrize("seq", [16, 63])
def test_corpus_windows_are_the_references(engines, engine, seq):
    kw = dict(source="corpus", corpus_path=CORPUS, tokenizer_file=TOKENIZER,
              engine=engine)
    got = PP.make_packed_dataset(seq, FIXTURE_VOCAB, **kw)
    want = RP.make_packed_dataset(seq, FIXTURE_VOCAB, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_vocab_mismatch_raises_as_the_reference():
    kw = dict(source="corpus", corpus_path=CORPUS, tokenizer_file=TOKENIZER)
    with pytest.raises(PP.VocabMismatchError, match="go up to") as got:
        PP.make_packed_dataset(16, 64, **kw)
    with pytest.raises(RP.VocabMismatchError) as want:
        RP.make_packed_dataset(16, 64, **kw)
    assert str(got.value) == str(want.value)
    assert issubclass(PP.VocabMismatchError, ValueError)


@pytest.mark.parametrize("n", [5, 20, 81, 1000])
def test_corpus_holdout_split_is_the_references(n):
    assert (PP.CORPUS_HOLDOUT_FRAC, PP.CORPUS_HOLDOUT_MIN_WINDOWS) \
        == (RP.CORPUS_HOLDOUT_FRAC, RP.CORPUS_HOLDOUT_MIN_WINDOWS)
    ii = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    ll = ii + 1
    got = PP.corpus_holdout_split(ii, ll)
    want = RP.corpus_holdout_split(ii, ll)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    (tr, _), (ho, _) = got
    assert len(tr) + len(ho) == n and not set(tr[:, 0]) & set(ho[:, 0])


def test_corpus_holdout_split_refuses_to_take_everything():
    ii = np.zeros((4, 3), np.int32)
    with pytest.raises(ValueError, match="consume the whole corpus"):
        PP.corpus_holdout_split(ii, ii)


@pytest.mark.parametrize("n,vocab,seed", [(1, 4, 0), (64, 50, 3),
                                          (300, 49_152, 42)])
def test_synthetic_pairs_are_the_references(n, vocab, seed):
    assert PC.synthetic_pair_examples(n, vocab, seed) \
        == RC.synthetic_pair_examples(n, vocab, seed)


@pytest.mark.parametrize("m", [1, 8, 16])
def test_pad_collate_is_the_references(m):
    ex = PC.synthetic_pair_examples(23, 97, seed=m)
    got = PC.pad_collate(ex, pad_to_multiple_of=m, pad_id=3)
    want = RC.pad_collate(ex, pad_to_multiple_of=m, pad_id=3)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["input_ids"].shape[1] % m == 0


@pytest.mark.parametrize("n,ws", [(10, 1), (10, 3), (7, 4), (2048, 8)])
def test_shard_examples_is_the_references(n, ws):
    ex = list(range(n))
    shards = [PC.shard_examples(ex, r, ws) for r in range(ws)]
    assert shards == [RC.shard_examples(ex, r, ws) for r in range(ws)]
    assert sum(shards, []) == ex


@pytest.mark.parametrize("bs,ws,epochs", [(8, 1, 1), (8, 2, 2), (12, 4, 1)])
def test_classification_batches_are_the_references(bs, ws, epochs):
    ex = PC.synthetic_pair_examples(100, 300, seed=4)
    got = list(PC.classification_batches(ex, bs, ws, seed=5, epochs=epochs))
    want = list(RC.classification_batches(ex, bs, ws, seed=5,
                                          epochs=epochs))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
        assert g["input_ids"].shape[1] % 8 == 0
    with pytest.raises(ValueError, match="world size"):
        next(PC.classification_batches(ex, 2, 4))


def test_classification_sources(capsys):
    want = RC.make_classification_examples(64, n_examples=16, seed=2,
                                           source="synthetic")
    assert PC.make_classification_examples(
        64, n_examples=16, seed=2, source="synthetic") == want
    assert PC.make_classification_examples(
        64, n_examples=16, seed=2, source="auto") == want
    assert ("[data] GLUE MRPC unusable (OSError: hub unreachable); "
            "falling back to synthetic pairs") in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="GLUE MRPC download"):
        PC.make_classification_examples(64, source="mrpc")
    with pytest.raises(ValueError, match="unknown source"):
        PC.make_classification_examples(64, source="nope")
