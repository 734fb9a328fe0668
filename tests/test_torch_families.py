"""The model families of the JAX package's registry in the port
(``models/transformer.py``, ``models/__init__.py``) and the ``eval_lm``
twin, against the reference on the CPU.

* Every config of the reference's ``MODEL_REGISTRY`` under the same name,
  field for field (``jnp.bfloat16`` / ``jnp.float32`` mapped to torch's),
  ``param_count`` equal.  The reference's ``gated_mlp`` (True in every
  config) and ``offload_activations`` (False; A12) have no port field.
* For each feature the port had not run before these configs (RoPE on
  every layer, ``nope_interval=0``; an untied output head; GQA at rep 3;
  hd 64; vocab 8192 and a streamed-vocab loss), a 2-layer narrow cut of
  the config that brings it, in f32 with plain attention: ``lm_loss`` and
  every grad leaf on bridged weights allclose to the reference at rtol =
  atol = 2e-5 (the two sum in other orders).
* ``train.eval_lm``: the held-out windows bit-equal to the reference's,
  its loss on bridged TINY_LM weights allclose to the reference script's
  loop on the same weights (rtol 1e-5), and the flagship → params save →
  restore lifecycle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.data import packing as RP
from distributed_training_sandbox_tpu.models import MODEL_REGISTRY as RM
from distributed_training_sandbox_tpu.models import transformer as RT
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import MODEL_REGISTRY as PM
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import optim
from distributed_training_sandbox_tpu_torch.train import eval_lm, flagship
torch.set_num_threads(1)  # the suite's workers share the cores

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
TOL = dict(rtol=2e-5, atol=2e-5)
# name: (the config that brings the feature, its cut's overrides)
NARROW = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=96,
              attention_impl="xla", remat=False)
CUTS = {
    "nope0_qwen3_4b_l6": ("QWEN3_4B_L6", dict(NARROW, vocab_size=512,
                                               loss_vocab_chunk=200)),
    "untied_llama31_8b": ("LLAMA31_8B", dict(NARROW, vocab_size=512)),
    "rep3_smollm3_350m": ("SMOLLM3_350M", dict(NARROW, vocab_size=512)),
    "hd64_llama32_1b": ("LLAMA32_1B", dict(NARROW, vocab_size=512,
                                           loss_vocab_chunk=None)),
    "vocab8192_corpus_70m": ("CORPUS_LM", dict(NARROW,
                                               loss_vocab_chunk=3000)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Narrow 2-layer cuts gain nothing from intra-op threads; the
    suite's workers share the cores, so the module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_is_the_references_name_for_name():
    assert PM == RM
    assert len(PM) == 11


@pytest.mark.parametrize("name", sorted(RM))
def test_config_field_for_field(name):
    r, p = getattr(RT, RM[name]), getattr(PT, PM[name])
    rf = {f.name for f in dataclasses.fields(r)}
    pf = {f.name for f in dataclasses.fields(p)}
    assert rf - pf == {"gated_mlp", "offload_activations"} and pf <= rf
    assert r.gated_mlp and not r.offload_activations
    for f in sorted(pf):
        want = getattr(r, f)
        want = DTYPES.get(want, want) if f == "dtype" else want
        assert getattr(p, f) == want, f
    assert p.param_count() == r.param_count()
    assert p.resolved_head_dim == r.resolved_head_dim


def test_features_each_cut_brings():
    cfg = {k: dataclasses.replace(getattr(PT, a), **kw)
           for k, (a, kw) in CUTS.items()}
    assert cfg["nope0_qwen3_4b_l6"].nope_interval == 0
    assert all(PT.rope_flags(cfg["nope0_qwen3_4b_l6"]))
    assert not cfg["untied_llama31_8b"].tie_word_embeddings
    c = cfg["rep3_smollm3_350m"]
    assert c.num_attention_heads // c.num_key_value_heads == 3
    assert cfg["hd64_llama32_1b"].resolved_head_dim == 64
    assert cfg["vocab8192_corpus_70m"].vocab_size == 8192


def _cut(name):
    attr, kw = CUTS[name]
    jc = dataclasses.replace(getattr(RT, attr), dtype=jnp.float32, **kw)
    pc = dataclasses.replace(getattr(PT, attr), dtype=torch.float32, **kw)
    return jc, pc


@pytest.mark.parametrize("name", list(CUTS))
def test_narrow_cut_loss_and_grads_match_the_reference(name):
    jc, pc = _cut(name)
    jp = RT.init_params(jax.random.PRNGKey(len(name)), jc)
    np_tree = jax.tree.map(np.asarray, jp)
    pp = bridge.params_from_jax(np_tree, pc)
    assert ("lm_head" in pp) == (not pc.tie_word_embeddings)
    if not pc.tie_word_embeddings:
        assert pp["lm_head"].shape == (pc.hidden_size, pc.vocab_size)
    rng = np.random.default_rng(len(name))
    ids = rng.integers(0, pc.vocab_size, size=(2, 17)).astype(np.int32)
    batch = (ids[:, :-1], ids[:, 1:])
    want_loss, want_grads = jax.value_and_grad(RT.lm_loss)(
        jp, tuple(jnp.asarray(b) for b in batch), jc)
    leaves = [p for _, p in optim.tree_leaves(pp)]
    for p in leaves:
        p.requires_grad_(True)
    loss = PT.lm_loss(pp, tuple(torch.as_tensor(b) for b in batch), pc)
    grads = optim.tree_unflatten(pp, torch.autograd.grad(loss, leaves))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    want = jax.tree.map(np.asarray, want_grads)
    assert [p for p, _ in optim.tree_leaves(grads)] \
        == [p for p, _ in optim.tree_leaves(bridge.params_from_jax(want,
                                                                    pc))]
    for path, g in optim.tree_leaves(grads):
        np.testing.assert_allclose(g.numpy(), optim.tree_get(want, path),
                                   **TOL, err_msg="/".join(path))


def _reference_holdout(seq, bs, vocab):
    """The reference script's synthetic held-out windows."""
    ii, ll = RP.make_packed_dataset(seq, vocab,
                                    num_tokens=64 * bs * (seq + 1),
                                    source="synthetic")
    return RP.corpus_holdout_split(ii, ll)[1]


def test_eval_holdout_and_loss_match_the_reference():
    seq, bs = 16, 4
    ii, ll = eval_lm.holdout("synthetic", PT.TINY_LM.vocab_size, seq, bs)
    rii, rll = _reference_holdout(seq, bs, RT.TINY_LM.vocab_size)
    np.testing.assert_array_equal(ii, rii)
    np.testing.assert_array_equal(ll, rll)
    jp = RT.init_params(jax.random.PRNGKey(7), RT.TINY_LM)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), PT.TINY_LM)
    loss, steps = eval_lm.evaluate(pp, PT.TINY_LM, ii, ll, bs, "cpu")
    # the reference script's loop: a float per batch, their mean
    loss_fn = jax.jit(lambda p, b: RT.lm_loss(p, b, RT.TINY_LM))
    tot, n = 0.0, 0
    for ib, lb in RP.packed_batches(rii, rll, bs):
        tot += float(loss_fn(jp, (jnp.asarray(ib), jnp.asarray(lb))))
        n += 1
    assert steps == n > 0
    np.testing.assert_allclose(loss, tot / n, rtol=1e-5)


def test_flagship_save_and_eval_restore(tmp_path, capsys):
    ck = tmp_path / "ck"
    flagship.run_leg("tiny", "bf16", 16, 2, 3, 0, 1e-2, device="cpu",
                     ckpt_dir=ck)
    fresh = eval_lm.run("tiny", "synthetic", 16, 4, None, device="cpu")
    got = eval_lm.main(["--model", "tiny", "--data", "synthetic",
                        "--sequence-length", "16", "--batch-size", "4",
                        "--ckpt-dir", str(ck), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[eval] restored step 3 from {ck}" in out
    assert got["restored_step"] == 3 and fresh["restored_step"] is None
    assert set(got) == {"model", "data", "sequence_length",
                        "holdout_windows", "eval_steps", "eval_tokens",
                        "restored_step", "eval_loss", "perplexity"}
    assert np.isfinite(got["eval_loss"])
    assert got["eval_loss"] != fresh["eval_loss"]
    assert got["eval_tokens"] == got["eval_steps"] * 4 * 16
    with pytest.raises(SystemExit, match="no checkpoint steps"):
        eval_lm.run("tiny", "synthetic", 16, 4, tmp_path / "empty",
                    device="cpu")


def test_eval_and_the_corpus_leg_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_lm.run("tiny", "synthetic", 16, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship.run_leg("tiny", "bf16", 16, 2, 1, 0, 1e-2, data="corpus")
    with pytest.raises(ValueError, match="data="):
        flagship.run_leg("tiny", "bf16", 16, 2, 1, 0, 1e-2, device="cpu",
                         data="tinystories")
