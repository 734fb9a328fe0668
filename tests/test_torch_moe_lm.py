"""The MoE transformer of the port (``models/transformer.py`` with
``n_experts > 0``) against the JAX reference on the CPU, in one
process: ``lm_loss`` and its grads in seven configurations, the single
expert equal to dense, the config's fields, ``param_count`` and FLOPs,
and the MoE step's refusals.  The MoE pipeline, ``generate`` and the
serve are in ``test_torch_moe_pipeline.py``; the dp × ep step (every
case of the reference's ``tests/test_moe_lm.py`` but the dp × sp × ep
one, which ``test_torch_2d.py`` holds) and FSDP with MoE, on 2 and 4
gloo ranks, in ``test_torch_moe_ranks.py``.

Weights come from the reference's ``init_params`` through the bridge;
batches from ``jax.random`` as the reference's tests draw them.  Tiers:
routing-dependent counts (the shim's collectives) **bitwise**; tokens
**bitwise**; losses and params **allclose** at the tolerances stated
(f32 reduced in other orders by XLA, torch and gloo; Adam's first steps
move each weight by about lr, which magnifies last-bit grad
differences).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fsdp import _flat

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.utils.flops import (
    get_model_flops_per_token as jax_flops)
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import expert as PE
from distributed_training_sandbox_tpu_torch.parallel import optim as PO
from distributed_training_sandbox_tpu_torch.utils.flops import (
    get_model_flops_per_token as port_flops)
torch.set_num_threads(1)  # the suite's workers share the cores

MOE = dict(n_experts=8, moe_ffn=64, moe_capacity_factor=4.0)
JCFG = dataclasses.replace(JT.TINY_LM, **MOE)
PCFG = dataclasses.replace(PT.TINY_LM, **MOE)


def _batch(vocab, B=8, S=32, seed=1):
    ids = jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0, vocab)
    return np.asarray(ids), np.asarray(jnp.roll(ids, -1, axis=1))


def _tb(batch):
    return tuple(torch.from_numpy(np.array(t)) for t in batch)


def _jparams(cfg, seed):
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(seed),
                                                   cfg))


def _port_cfg(jcfg):
    keys = ("n_experts", "moe_ffn", "moe_capacity_factor", "moe_aux_weight",
            "moe_dispatch", "moe_group_size", "moe_top_k",
            "moe_router_z_weight", "moe_router_lr_mult", "matmul_precision",
            "tie_word_embeddings", "num_hidden_layers")
    return dataclasses.replace(PT.TINY_LM,
                               **{k: getattr(jcfg, k) for k in keys})


# --------------------------------------------------------- single process

def test_single_expert_moe_equals_dense():
    """E = 1 with capacity >= tokens is the dense SwiGLU (router prob 1,
    nothing dropped, the dispatch a permutation), in the port as in the
    reference."""
    dense = _jparams(JT.TINY_LM, 0)
    L, h = JT.TINY_LM.num_hidden_layers, JT.TINY_LM.hidden_size
    moe = {**dense, "layers": dict(dense["layers"])}
    moe["layers"]["w_router"] = np.zeros((L, h, 1), np.float32)
    for k in ("w_gate", "w_up", "w_down"):
        moe["layers"][k] = dense["layers"][k][:, None]
    moe_cfg = dataclasses.replace(
        PT.TINY_LM, n_experts=1, moe_ffn=PT.TINY_LM.intermediate_size,
        moe_capacity_factor=1.0, moe_aux_weight=0.0)
    batch = _tb(_batch(512))
    a = float(PT.lm_loss(bridge.params_from_jax(dense, PT.TINY_LM), batch,
                         PT.TINY_LM))
    b = float(PT.lm_loss(bridge.params_from_jax(moe, moe_cfg), batch,
                         moe_cfg))
    assert a == pytest.approx(b, abs=1e-5), (a, b)
    jcfg = dataclasses.replace(JT.TINY_LM, n_experts=1,
                               moe_ffn=JT.TINY_LM.intermediate_size,
                               moe_capacity_factor=1.0, moe_aux_weight=0.0)
    want = float(JT.lm_loss(moe, tuple(map(jnp.asarray, _batch(512))), jcfg))
    assert b == pytest.approx(want, rel=1e-5)


LM_CASES = {
    "top1": {},
    "top2": dict(moe_top_k=2, moe_capacity_factor=1.0),
    "einsum": dict(moe_dispatch="einsum", moe_capacity_factor=1.0),
    "sort": dict(moe_dispatch="sort", moe_capacity_factor=1.0),
    "z_loss": dict(moe_router_z_weight=1e-3),
    "group8": dict(moe_group_size=8, moe_capacity_factor=1.0),
    "int8_pallas_bwd": dict(matmul_precision="int8_pallas_bwd"),
}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_moe_lm_loss_and_grads_match_the_reference(case):
    """``lm_loss`` (the xent plus the weighted aux) and every grad leaf
    of TINY_LM with 8 experts against the reference's jitted
    value-and-grad (allclose: loss rtol 1e-5; grads atol 2e-5 of f32,
    5e-4 at int8_pallas_bwd, where an int8 code of the backward may flip
    with a last-bit difference upstream), and ``hidden_states``' summed
    aux against the reference's."""
    jcfg = dataclasses.replace(JCFG, **LM_CASES[case])
    pcfg = _port_cfg(jcfg)
    jparams = _jparams(jcfg, 2)
    batch = _batch(512, B=4, seed=3)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, tuple(map(jnp.asarray, batch)), jcfg)))(
        jax.tree.map(jnp.asarray, jparams))
    params = bridge.params_from_jax(jparams, pcfg)
    leaves = [p for _, p in PO.tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss = PT.lm_loss(params, _tb(batch), pcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    atol = 5e-4 if case.startswith("int8") else 2e-5
    want = dict(_flat(jax.tree.map(np.asarray, jg)))
    for (path, _), g in zip(PO.tree_leaves(params), grads):
        np.testing.assert_allclose(g.numpy(), want["/".join(path)], rtol=0,
                                   atol=atol, err_msg="/".join(path))
    with torch.no_grad():
        _, aux = PT.hidden_states(params, _tb(batch)[0], pcfg,
                                  return_aux=True)
    _, jaux = JT.hidden_states(jax.tree.map(jnp.asarray, jparams),
                               jnp.asarray(batch[0]), jcfg, return_aux=True)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def test_config_checks_param_count_and_flops_match_the_reference():
    for kw in ({}, dict(moe_top_k=2), dict(moe_ffn=None)):
        jc = dataclasses.replace(JCFG, **kw)
        pc = dataclasses.replace(PCFG, **kw)
        assert pc.param_count() == jc.param_count()
        assert port_flops(pc, 256) == jax_flops(jc, 256)
    assert PT.SMOLLM3_3B_L8_MOE.param_count() == \
        JT.SMOLLM3_3B_L8_MOE.param_count() == 1_428_850_688
    assert port_flops(PT.SMOLLM3_3B_L8_MOE, 8192) == jax_flops(
        JT.SMOLLM3_3B_L8_MOE, 8192)
    for k in ("n_experts", "moe_ffn", "moe_dispatch", "num_hidden_layers",
              "attention_impl", "loss_vocab_chunk"):
        assert getattr(PT.SMOLLM3_3B_L8_MOE, k) == getattr(
            JT.SMOLLM3_3B_L8_MOE, k), k
    defaults = PT.TransformerConfig()
    for k in ("moe_capacity_factor", "moe_aux_weight", "moe_dispatch",
              "moe_group_size", "moe_top_k", "moe_router_z_weight",
              "moe_router_lr_mult", "ep_axis", "moe_ffn", "n_experts"):
        assert getattr(defaults, k) == getattr(JT.TransformerConfig(), k), k
    with pytest.raises(ValueError, match="unknown moe_dispatch"):
        PT.init_params(dataclasses.replace(PCFG, moe_dispatch="scatter"),
                       torch.Generator(), "cpu")


def test_moe_step_refusals():
    params = bridge.params_from_jax(
        _jparams(dataclasses.replace(JCFG, n_experts=6), 5),
        dataclasses.replace(PCFG, n_experts=6))
    with pytest.raises(ValueError, match="n_experts must be > 0"):
        PE.make_moe_lm_train_step(params, PT.TINY_LM)
    # the dp x sp x ep step is ported; a ring config handed to the step
    # without its sp_axis is refused, as the reference refuses it
    ring = dataclasses.replace(PCFG, attention_impl="ring", sp_axis="sp")
    with pytest.raises(ValueError, match="sp_axis"):
        PE.make_moe_lm_train_step(params, ring)
