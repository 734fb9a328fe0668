"""The MoE model's pipeline stages, ``generate`` and serve against the
JAX reference on the CPU: the reference's MoE pipeline
(``tests/test_pipeline_transformer.py:139-211``: the aux threading
against its stages, GPipe and 1F1B, 2 and 3 stages), MoE ``generate``
(``tests/test_generate.py:35-38``) and the paged engine's tokens, and
the int8 decode params that keep the expert banks
(``tests/test_generate.py:127-140``).  Tiers: tokens and the quantised
weights bitwise, losses and params allclose at the tolerances stated.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fsdp import _flat
from test_torch_moe_lm import _jparams, _port_cfg

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.parallel import pipeline as JP
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import generate as PG
from distributed_training_sandbox_tpu_torch.ops.quant import QuantizedWeight
from distributed_training_sandbox_tpu_torch.parallel import optim as PO
from distributed_training_sandbox_tpu_torch.parallel import pipeline as PP
from distributed_training_sandbox_tpu_torch.serving import engine as PEng

# the module (the package re-exports its function under the same name)
JG = importlib.import_module("distributed_training_sandbox_tpu.models.generate")
# the reference's MoE pipeline config: tight capacity (drops and aux
# both active) and a group of one sequence row, so the grouped capacity
# is the same seen whole or in microbatches
PIPE_J = dataclasses.replace(JT.TINY_LM, tie_word_embeddings=False,
                             n_experts=4, moe_ffn=32,
                             moe_capacity_factor=1.0, moe_group_size=32)


def _pipe_batch(n_stages):
    B = 8 if n_stages == 2 else 6
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (B, 32), 0,
                                        PIPE_J.vocab_size))
    return ids, np.roll(ids, -1, axis=1), (4 if n_stages == 2 else 3)


@functools.cache
def _jax_pipeline(n_stages):
    """One reference 1F1B step of the MoE stages: (loss, each stage's
    params after its Adam step).  The reference's GPipe computes the
    same step (its tests hold both to one monolithic step)."""
    ids, labels, n_micro = _pipe_batch(n_stages)
    jst = JP.build_transformer_pipeline(
        jax.tree.map(jnp.asarray, _jparams(PIPE_J, 3)), PIPE_J,
        n_stages=n_stages)
    loss = float(JP.run_1f1b(jst, jnp.asarray(ids), jnp.asarray(labels),
                             n_micro=n_micro, lr=1e-3))
    return loss, [dict(_flat(jax.tree.map(np.asarray, js.params)))
                  for js in jst]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("n_stages", [2, 3])
def test_moe_pipeline_matches_the_reference(schedule, n_stages):
    """The MoE stages' aux threading (each stage's aux cotangent local,
    only the values travelling to the loss) against the reference's
    pipeline on the same params and batch: one step's loss rtol 1e-5
    and every stage's params after its Adam step atol 2e-4 (as
    ``test_torch_pipeline.py``'s TINY_LM tier)."""
    pcfg = _port_cfg(PIPE_J)
    ids, labels, n_micro = _pipe_batch(n_stages)
    want, jstages = _jax_pipeline(n_stages)
    prun = {"gpipe": PP.run_gpipe, "1f1b": PP.run_1f1b}[schedule]
    pst = PP.build_transformer_pipeline(
        bridge.params_from_jax(_jparams(PIPE_J, 3), pcfg), pcfg, n_stages,
        devices=["cpu"])
    got = prun(pst, torch.from_numpy(ids), torch.from_numpy(labels),
               n_micro=n_micro, lr=1e-3)
    assert got == pytest.approx(want, rel=1e-5)
    for s, (jflat, ps) in enumerate(zip(jstages, pst)):
        for path, t in PO.tree_leaves(ps.params):
            np.testing.assert_allclose(
                t.detach().numpy(), jflat["/".join(path)], rtol=0, atol=2e-4,
                err_msg=f"stage {s}: {'/'.join(path)}")
    assert PP.pipeline_loss(pst, torch.from_numpy(ids),
                            torch.from_numpy(labels)) > 0


GEN_J = dataclasses.replace(JT.TINY_LM, n_experts=4, moe_ffn=32,
                            moe_capacity_factor=8.0)


def test_moe_generate_first_tokens_match_the_reference():
    """Greedy MoE decode (no drops at cf 8.0: decode chunks are tiny)
    token for token against the reference's ``generate``, and the
    paged engine's tokens equal the port's ``generate`` at its view
    capacity (bitwise)."""
    pcfg = _port_cfg(GEN_J)
    params = _jparams(GEN_J, 0)
    pp = bridge.params_from_jax(params, pcfg)
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 7), 0,
                                            GEN_J.vocab_size))
    want = np.asarray(JG.generate(jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(prompts), GEN_J,
                                  max_new_tokens=8))
    got = PG.generate(pp, torch.from_numpy(prompts), pcfg, max_new_tokens=8,
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    eng = PEng.ServingEngine(pp, pcfg, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    for r in reqs:
        ref = PG.generate(pp, torch.from_numpy(r.prompt[None]), pcfg,
                          max_new_tokens=6, cache_capacity=eng.view_capacity,
                          device="cpu")[0]
        assert r.tokens == ref.tolist()


def test_int8_serve_keeps_the_expert_banks_bf16():
    """``quantize_decode_params`` of an MoE config quantises wq, wk, wv
    and wo only (bitwise against the reference's eager quantiser) and
    keeps the router and the banks; decoding with them gives the
    reference's tokens."""
    cfg_j = dataclasses.replace(GEN_J, dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(_port_cfg(GEN_J), dtype=torch.bfloat16)
    params = _jparams(cfg_j, 0)
    jq = JG.quantize_decode_params(jax.tree.map(jnp.asarray, params), cfg_j)
    pq = PG.quantize_decode_params(bridge.params_from_jax(params, pcfg),
                                   pcfg)
    for k in ("wq", "wk", "wv", "wo"):
        assert isinstance(pq["layers"][k], QuantizedWeight)
        np.testing.assert_array_equal(pq["layers"][k].q.numpy(),
                                      np.asarray(jq["layers"][k].q))
        np.testing.assert_array_equal(pq["layers"][k].s.numpy(),
                                      np.asarray(jq["layers"][k].s))
    for k in ("w_router", "w_gate", "w_up", "w_down"):
        assert not isinstance(pq["layers"][k], QuantizedWeight)
        assert pq["layers"][k].dtype == torch.bfloat16
    prompt = np.zeros((1, 4), np.int32)
    want = np.asarray(JG.generate(jq, jnp.asarray(prompt), cfg_j,
                                  max_new_tokens=4))
    got = PG.generate(pq, torch.from_numpy(prompt), pcfg, max_new_tokens=4,
                      device="cpu")
    assert got.shape == (1, 4)
    np.testing.assert_array_equal(got.numpy(), want)
