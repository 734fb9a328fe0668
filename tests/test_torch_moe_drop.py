"""The MoE drop fraction at init, the port against the JAX reference on
the same weights (ROADMAP.md C8), on the CPU.

``SMOLLM3_3B_L8_MOE`` (reference ``models/transformer.py:212``: 8
experts of ffn 2752, top-1, capacity factor 2.0, the grouped dispatch
in groups of 128) cut in depth to one layer, at its full width, in its
own dtype (bf16), with the reference's ``init_params`` bridged leaf for
leaf.  On one batch (numpy, seeded; 2 × 256 tokens) each package
computes layer 0's router input with its own code (embedding, RMSNorm,
RoPE'd GQA attention, the residual, RMSNorm) and routes it with its own
``_route_topk``; the grouped dispatch's drop fraction
(``grouped_drop_fraction``) follows.  The routes are integers of the
same routing, so the tier is equality: every token's expert, the
tokens each expert receives, and the dropped assignments, bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.parallel import expert as JE
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.parallel import expert as PE

B, S, SEED = 2, 256, 11


def _cut(cfg):
    return dataclasses.replace(cfg, num_hidden_layers=1,
                               attention_impl="xla")


def _layer0(params):
    return {k: v[0] for k, v in params["layers"].items()}


def jax_router_input(params, ids, cfg):
    """The reference's layer 0 up to its MLP's input (``_layer_body``)."""
    hd = cfg.resolved_head_dim
    x = params["embed"].astype(cfg.dtype)[ids]
    cos, sin = JT._rope_tables(S, hd, cfg.rope_theta)
    layer = _layer0(params)
    r = JT.rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = JT._qkv_proj(r, layer, cfg=cfg, cos=cos, sin=sin,
                           use_rope=JT._rope_flags(cfg)[0])
    attn = JT._attention_xla(q, k, v, 1.0 / math.sqrt(hd)).astype(x.dtype)
    x = x + JT._dense(cfg)(attn.reshape(B, S, -1), layer["wo"])
    return JT.rms_norm(x, layer["ln2"], cfg.rms_norm_eps).reshape(B * S, -1)


def port_router_input(params, ids, cfg):
    """The port's layer 0 up to its MLP's input (``_layer_body``)."""
    hd = cfg.resolved_head_dim
    x = params["embed"].to(cfg.dtype)[ids]
    cos, sin = PT._rope_tables(S, hd, cfg.rope_theta)
    layer = PT.layer_params(params, 0)
    r = PT.rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = PT._qkv_proj(r, layer, cfg=cfg, cos=cos, sin=sin,
                           use_rope=PT.rope_flags(cfg)[0])
    attn = PT._attention_xla(q, k, v, 1.0 / math.sqrt(hd)).to(x.dtype)
    x = x + PT._dense(cfg)(attn.reshape(B, S, -1), layer["wo"])
    return PT.rms_norm(x, layer["ln2"], cfg.rms_norm_eps).reshape(B * S, -1)


@pytest.fixture(scope="module")
def routes():
    jcfg, pcfg = _cut(JT.SMOLLM3_3B_L8_MOE), _cut(PT.SMOLLM3_3B_L8_MOE)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree.map(np.asarray, jp)
    pp = bridge.params_from_jax(np_tree, pcfg)
    ids = np.random.default_rng(SEED).integers(0, jcfg.vocab_size, (B, S))
    with torch.no_grad():
        xp = port_router_input(pp, torch.from_numpy(ids), pcfg)
        _, ep, _ = PE._route_topk(xp, pp["layers"]["w_router"][0],
                                  pcfg.moe_top_k)
    xj = jax.jit(lambda p, i: jax_router_input(p, i, jcfg))(
        jp, jnp.asarray(ids))
    _, ej, _ = JE._route_topk(xj, jp["layers"]["w_router"][0],
                              jcfg.moe_top_k)
    return jcfg, pcfg, np.asarray(ej), ep


def test_routes_are_the_references(routes):
    """Every token's expert and every expert's load, bit for bit."""
    jcfg, _, ej, ep = routes
    np.testing.assert_array_equal(ep.numpy(), ej)
    np.testing.assert_array_equal(
        np.bincount(ep.numpy().ravel(), minlength=jcfg.n_experts),
        np.bincount(ej.ravel(), minlength=jcfg.n_experts))


def test_drop_fraction_at_init_is_the_references(routes):
    """The grouped dispatch's drop fraction (group 128, cf 2.0) and the
    dropped assignments it stands for, equal in both packages."""
    jcfg, pcfg, ej, ep = routes
    args = (jcfg.n_experts, jcfg.moe_group_size, jcfg.moe_capacity_factor)
    fj = float(JE.grouped_drop_fraction(jnp.asarray(ej), *args))
    fp = float(PE.grouped_drop_fraction(ep, *args))
    assert fp == fj
    n = ej.size
    assert round(fp * n) == round(fj * n) and abs(fp * n - round(fp * n)) \
        < 1e-6
    # the reading, for PERF.md section 7
    print(f"C8: layer 0 of SMOLLM3_3B_L8_MOE at init, {n} tokens: drop "
          f"fraction {fp} ({round(fp * n)} dropped) in both packages; "
          f"expert loads {np.bincount(ej.ravel(), minlength=8).tolist()}")
