"""The port's expert parallelism (``parallel/expert.py``) against the JAX
reference's, on the CPU, in one process: every single-device case of
the reference's ``tests/test_expert.py`` restated on the port and held
against the JAX function on the same numpy inputs, plus the forced
top-k tie and experts that receive no token.  The multi-rank cases (the
all_to_all's gradient, the sharded layer, the EP toy step, the twin)
are in ``test_torch_expert_ranks.py``.

Tiers, each stated where it is used:
- **bitwise**: routing (expert choices, gates' ranking), capacity
  positions and drops, the one-hot data movement, collective counts,
  the quantisers on all-zero rows;
- **allclose**: outputs, aux losses and grads, at pinned tolerances
  (f32 math reduced in other orders by XLA and torch).

The JAX side runs ``moe_mlp`` under ``jax.jit``, as its train step does
(the quantisers' jitted form, ``ops/quant.py``'s docstring), its Pallas
kernels in interpret mode on the CPU, as its own tests run them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.ops import quant as JQ
from distributed_training_sandbox_tpu.parallel import expert as JE
from distributed_training_sandbox_tpu.parallel import optim as JO
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.ops import quant as PQ
from distributed_training_sandbox_tpu_torch.parallel import expert as PE
from distributed_training_sandbox_tpu_torch.parallel import optim as PO
torch.set_num_threads(1)  # the suite's workers share the cores

HID, FFN, NEXP = 32, 64, 8
# allclose tier of one MoE MLP (f32): outputs and aux; grads
Y_TOL, GRAD_TOL = 2e-6, 2e-5


@pytest.fixture(scope="module")
def moe_params():
    jp = JE.init_moe_params(jax.random.PRNGKey(0), hidden=HID, ffn=FFN,
                            n_experts=NEXP)
    return jp, bridge.moe_params_from_jax(jax.tree.map(np.asarray, jp))


def _x(seed, B, S):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (B, S, HID), jnp.float32))


def _jax_mlp(x, jp, **kw):
    """The reference's moe_mlp, jitted, and the grads of its probe loss
    ``Σ y² + aux`` with respect to x and every weight."""
    f = jax.jit(functools.partial(JE.moe_mlp, axis=None, **kw))

    def probe(x, *w):
        y, aux = f(x, *w)
        return jnp.sum(y * y) + aux
    y, aux = f(jnp.asarray(x), *jp)
    grads = jax.jit(jax.grad(probe, argnums=(0, 1, 2, 3, 4)))(
        jnp.asarray(x), *jp)
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


def _port_mlp(x, pp, **kw):
    leaves = [torch.from_numpy(np.array(x)).requires_grad_()] + [
        t.detach().clone().requires_grad_() for t in pp]
    y, aux = PE.moe_mlp(*leaves, axis=None, **kw)
    grads = torch.autograd.grad((y * y).sum() + aux, leaves)
    return (y.detach().numpy(), float(aux),
            [g.numpy() for g in grads])


def _assert_close(got, want, ytol=Y_TOL, gtol=GRAD_TOL):
    """allclose tier: outputs and aux at ``ytol``, grads at ``gtol``."""
    (y, aux, g), (yj, auxj, gj) = got, want
    np.testing.assert_allclose(y, yj, rtol=ytol, atol=ytol)
    assert aux == pytest.approx(auxj, rel=ytol, abs=ytol)
    for name, a, b in zip(("x", "w_router", "w_gate", "w_up", "w_down"), g,
                          gj):
        np.testing.assert_allclose(a, b, rtol=gtol, atol=gtol, err_msg=name)


# ------------------------------------------------------------- routing

def test_routing_and_capacity_positions_are_bitwise(moe_params):
    """bitwise: the top-k choices, the grouped dispatch's bucket
    positions (choice-major priority) and its drop fraction."""
    jp, pp = moe_params
    x2d = _x(3, 1, 64).reshape(-1, HID)
    for k in (1, 2):
        _, ej, _ = JE._route_topk(jnp.asarray(x2d), jp.w_router, k)
        _, ep_, _ = PE._route_topk(torch.from_numpy(x2d), pp.w_router, k)
        np.testing.assert_array_equal(ep_.numpy(), np.asarray(ej))
        eg = np.asarray(ej).reshape(4, 16, k).transpose(0, 2, 1).reshape(
            4, 16 * k)
        oh_j, pos_j = JE._group_slot_positions(jnp.asarray(eg), NEXP)
        oh_p, pos_p = PE._group_slot_positions(torch.from_numpy(eg), NEXP)
        np.testing.assert_array_equal(pos_p.numpy(), np.asarray(pos_j))
        np.testing.assert_array_equal(oh_p.numpy(), np.asarray(oh_j))
        for cf in (0.75, 1.0, 2.0):
            assert float(PE.grouped_drop_fraction(ep_, NEXP, 16, cf)) == \
                float(JE.grouped_drop_fraction(ej, NEXP, 16, cf))
    assert PE._grouped_caps(40, 16, 1.0, NEXP) == JE._grouped_caps(
        40, 16, 1.0, NEXP) == (10, 4, 2)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_ties_take_the_lowest_index_as_lax_top_k(k):
    """bitwise: router columns made equal give equal probabilities (as
    bf16 logits do); ``lax.top_k`` takes the lower index first, and so
    must the port, whose ``torch.topk`` promises no order."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((HID, NEXP)).astype(np.float32)
    w[:, 5] = w[:, 2] = w[:, 7]          # three tied experts
    x = rng.standard_normal((64, HID)).astype(np.float32)
    x[:32] = np.abs(x[:32]) * np.sign(w[:, 7])   # rows the tie leads
    _, ej, _ = JE._route_topk(jnp.asarray(x), jnp.asarray(w), k)
    gp, ep_, probs = PE._route_topk(torch.from_numpy(x),
                                    torch.from_numpy(w), k)
    np.testing.assert_array_equal(ep_.numpy(), np.asarray(ej))
    top = probs.numpy().max(-1)
    tied = (probs.numpy() == top[:, None]).sum(-1) > 1
    assert tied.sum() >= 16, "the tie must lead rows"
    np.testing.assert_array_equal(ep_.numpy()[tied, 0], 2)
    # and the whole layer through the tie matches the reference
    jp = JE.MoEParams(jnp.asarray(w), *JE.init_moe_params(
        jax.random.PRNGKey(0), hidden=HID, ffn=FFN, n_experts=NEXP)[1:])
    pp = bridge.moe_params_from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(top_k=k, capacity_factor=1.0, group_size=16)
    _assert_close(_port_mlp(x[None], pp, **kw), _jax_mlp(x[None], jp, **kw))


# ------------------------------------------- the reference's cases

@pytest.mark.parametrize("cap_factor", [8.0, 1.0])
def test_moe_layer_matches_dense_oracle(moe_params, cap_factor):
    """Each chunk through the port's moe_layer == the port's dense
    oracle == the reference's oracle, at no-drop and tight capacity."""
    jp, pp = moe_params
    x = _x(1, 8, 16)
    for i in range(8):
        xi = x[i:i + 1]
        got = PE.moe_layer(pp, torch.from_numpy(xi), None,
                           capacity_factor=cap_factor)[0].numpy()
        ref = PE.moe_reference(pp, torch.from_numpy(xi),
                               capacity_factor=cap_factor).numpy()
        want = np.asarray(JE.moe_reference(jp, jnp.asarray(xi),
                                           capacity_factor=cap_factor))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(ref, want, rtol=Y_TOL, atol=Y_TOL)


@pytest.mark.parametrize("dispatch", ["grouped", "einsum", "sort"])
@pytest.mark.parametrize("cap_factor", [8.0, 1.0, 0.75])
def test_each_dispatch_matches_the_reference(moe_params, dispatch,
                                             cap_factor):
    """Outputs, aux and every grad of each dispatch against the JAX
    function at loose and tight capacity (allclose tier)."""
    jp, pp = moe_params
    x = _x(7, 2, 40)
    kw = dict(dispatch=dispatch, capacity_factor=cap_factor, group_size=16)
    _assert_close(_port_mlp(x, pp, **kw), _jax_mlp(x, jp, **kw))


@pytest.mark.parametrize("cap_factor", [8.0, 1.0, 0.75])
def test_sort_dispatch_matches_einsum_dispatch(moe_params, cap_factor):
    """The port's sort dispatch == its one-hot einsum oracle: outputs,
    aux and grads (dropped tokens leak no gradient)."""
    _, pp = moe_params
    x = _x(7, 2, 40)
    s = _port_mlp(x, pp, dispatch="sort", capacity_factor=cap_factor)
    e = _port_mlp(x, pp, dispatch="einsum", capacity_factor=cap_factor)
    _assert_close(s, e, 1e-6, 1e-5)


@pytest.mark.parametrize("cap_factor", [8.0, 1.0, 0.75])
def test_grouped_dispatch_one_group_equals_einsum(moe_params, cap_factor):
    _, pp = moe_params
    x = _x(11, 2, 40)
    g = _port_mlp(x, pp, dispatch="grouped", group_size=80,
                  capacity_factor=cap_factor)
    e = _port_mlp(x, pp, dispatch="einsum", capacity_factor=cap_factor)
    _assert_close(g, e, 1e-6, 1e-5)


def test_grouped_dispatch_matches_per_group_einsum(moe_params):
    _, pp = moe_params
    G, NG = 16, 5
    x = torch.from_numpy(_x(12, 1, G * NG))
    yg, _ = PE.moe_mlp(x, *pp, axis=None, dispatch="grouped", group_size=G,
                       capacity_factor=1.0)
    ref = torch.cat([PE.moe_mlp(x[:, i * G:(i + 1) * G], *pp, axis=None,
                                dispatch="einsum", capacity_factor=1.0)[0]
                     for i in range(NG)], dim=1)
    np.testing.assert_allclose(yg.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_grouped_dispatch_shrinks_non_dividing_group(moe_params):
    _, pp = moe_params
    assert PE._resolve_group(40, 16) == 10
    x = torch.from_numpy(_x(13, 1, 40))
    ya, _ = PE.moe_mlp(x, *pp, axis=None, group_size=16, capacity_factor=1.0)
    yb, _ = PE.moe_mlp(x, *pp, axis=None, group_size=10, capacity_factor=1.0)
    np.testing.assert_array_equal(ya.numpy(), yb.numpy())


def test_top2_matches_dense_reference_no_drops(moe_params):
    """top-2 at no-drop capacity == Σ_j gate_j · expert_j(x), gates
    normalised over the two chosen experts; and == the reference."""
    jp, pp = moe_params
    x = _x(20, 1, 64)
    y, aux = PE.moe_mlp(torch.from_numpy(x), *pp, axis=None, top_k=2,
                        capacity_factor=8.0)
    x2d = torch.from_numpy(x.reshape(-1, HID))
    gates, experts, _ = PE._route_topk(x2d, pp.w_router, 2)
    ref = torch.zeros_like(x2d)
    for j in range(2):
        e = experts[:, j]
        h_g = torch.einsum("nh,nhf->nf", x2d, pp.w_gate[e])
        h_u = torch.einsum("nh,nhf->nf", x2d, pp.w_up[e])
        out = torch.einsum("nf,nfh->nh", torch.nn.functional.silu(h_g) * h_u,
                           pp.w_down[e])
        ref = ref + out * gates[:, j:j + 1]
    np.testing.assert_allclose(y.reshape(-1, HID).numpy(), ref.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert float(aux) > 0
    kw = dict(top_k=2, capacity_factor=8.0)
    _assert_close(_port_mlp(x, pp, **kw), _jax_mlp(x, jp, **kw))


def test_top2_group_consistency_and_drops(moe_params):
    """Multi-group top-2 at tight capacity == per-group chunks; tighter
    capacity really drops (second choices first); grads finite; and the
    drops match the reference's (the whole function, allclose)."""
    jp, pp = moe_params
    G, NG = 16, 4
    x = _x(21, 1, G * NG)
    xt = torch.from_numpy(x)
    kw = dict(group_size=G, top_k=2)
    y, _ = PE.moe_mlp(xt, *pp, axis=None, capacity_factor=0.75, **kw)
    chunks = [PE.moe_mlp(xt[:, i * G:(i + 1) * G], *pp, axis=None,
                         capacity_factor=0.75, **kw)[0] for i in range(NG)]
    np.testing.assert_allclose(y.numpy(), torch.cat(chunks, 1).numpy(),
                               rtol=1e-6, atol=1e-6)
    y_loose, _ = PE.moe_mlp(xt, *pp, axis=None, capacity_factor=8.0, **kw)
    assert float((y - y_loose).abs().max()) > 1e-4
    got = _port_mlp(x, pp, capacity_factor=0.75, **kw)
    assert all(np.isfinite(g).all() for g in got[2])
    _assert_close(got, _jax_mlp(x, jp, capacity_factor=0.75, **kw))


def test_topk_requires_grouped(moe_params):
    _, pp = moe_params
    x = torch.from_numpy(_x(22, 1, 16))
    with pytest.raises(ValueError, match="grouped"):
        PE.moe_mlp(x, *pp, axis=None, dispatch="sort", top_k=2)
    with pytest.raises(ValueError, match="grouped"):
        dataclasses.replace(PT.TINY_LM, n_experts=4, moe_top_k=2,
                            moe_dispatch="sort")


# precision: (output tolerance, grad tolerance), the allclose tier of the
# quantised products against the reference's; the int8 forwards share
# codes exactly, the _bwd grads may flip a code where the two sides'
# f32 upstream grads differ in a last bit
QUANT_TOL = {"int8": (2e-6, 2e-5), "int8_bwd": (2e-6, 2e-3),
             "int8_pallas": (2e-6, 2e-5), "int8_pallas_bwd": (2e-6, 2e-3),
             "fp8_pallas": (1e-5, 1e-4)}


@pytest.mark.parametrize("precision", list(QUANT_TOL))
def test_moe_quantized_experts(moe_params, precision):
    """Per-expert quantised products, one expert at a time (each with
    its own scales, as the reference's vmap): against the reference at
    the same precision, and within quantisation error of bf16."""
    jp, pp = moe_params
    x = _x(8, 1, 32)
    kw = dict(capacity_factor=8.0, matmul_precision=precision)
    got = _port_mlp(x, pp, **kw)
    ytol, gtol = QUANT_TOL[precision]
    _assert_close(got, _jax_mlp(x, jp, **kw), ytol, gtol)
    yb = _port_mlp(x, pp, capacity_factor=8.0)[0]
    err, mag = np.abs(got[0] - yb).max(), np.abs(yb).max()
    assert err < 0.1 * mag + 1e-3, (err, mag)
    assert all(np.isfinite(g).all() for g in got[2])


@pytest.mark.parametrize("precision", ["int8_pallas_bwd", "fp8_pallas"])
def test_experts_with_no_token(moe_params, precision):
    """An expert that receives no token gets an all-zero bucket (and at
    cf 2 every bucket holds zero padding rows): the int8 row quantiser
    gives those rows scale 1 and code 0, fp8's per-tensor scale survives
    an absmax of 0 (bitwise against the jitted reference), and the
    layer still matches the reference with finite grads."""
    jp, pp = moe_params
    w = np.asarray(jp.w_router).copy()
    w[:, 3] = -50.0 * np.abs(w).max()      # expert 3: never chosen
    x = np.abs(_x(9, 1, 32))
    jp0 = jp._replace(w_router=jnp.asarray(w))
    pp0 = pp._replace(w_router=torch.from_numpy(w))
    _, e, _ = PE._route_topk(torch.from_numpy(x[0]), pp0.w_router, 1)
    assert 3 not in e.numpy()
    kw = dict(capacity_factor=2.0, matmul_precision=precision)
    ytol, gtol = QUANT_TOL[precision]
    _assert_close(_port_mlp(x, pp0, **kw), _jax_mlp(x, jp0, **kw), ytol,
                  gtol)
    zeros = np.zeros((4, HID), np.float32)
    zeros[1] = 1.5
    qj, sj = jax.jit(JQ.quantize_int8)(jnp.asarray(zeros))
    qp, sp = PQ.quantize_int8(torch.from_numpy(zeros))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    zero = jnp.zeros((8, HID), jnp.float32)
    qj, sj = jax.jit(JQ.quantize_fp8)(zero)
    qp, sp = PQ.quantize_fp8(torch.zeros(8, HID))
    assert float(sp) == float(sj) == 1.0
    np.testing.assert_array_equal(qp.float().numpy(),
                                  np.asarray(qj).astype(np.float32))


def test_moe_drops_overflow_tokens(moe_params):
    _, pp = moe_params
    x = torch.from_numpy(_x(2, 1, 64))
    y = PE.moe_reference(pp, x, capacity_factor=0.25)
    zeros = (y[0] == 0.0).all(dim=-1)
    assert zeros.any() and not zeros.all()


def test_router_z_loss_value_and_aux_channel(moe_params):
    jp, pp = moe_params
    z0 = PE.router_z_loss(torch.zeros(4, HID), torch.zeros(HID, NEXP))
    assert float(z0) == pytest.approx(np.log(NEXP) ** 2, rel=1e-6)
    x = _x(7, 2, 16)
    xt = torch.from_numpy(x)
    _, aux_plain = PE.moe_mlp(xt, *pp, axis=None)
    y, aux_z = PE.moe_mlp(xt, *pp, axis=None, router_z_ratio=0.5)
    z = PE.router_z_loss(xt.reshape(-1, HID), pp.w_router)
    assert float(aux_z) == pytest.approx(float(aux_plain) + 0.5 * float(z),
                                         rel=1e-5)
    np.testing.assert_array_equal(y.numpy(), PE.moe_mlp(xt, *pp,
                                                         axis=None)[0].numpy())
    assert float(z) == pytest.approx(float(JE.router_z_loss(
        jnp.asarray(x.reshape(-1, HID)), jp.w_router)), rel=1e-6)
    kw = dict(router_z_ratio=0.5)
    _assert_close(_port_mlp(x, pp, **kw), _jax_mlp(x, jp, **kw))


def test_adam_lr_mults_scale_only_matching_leaves():
    params = {"w_router": torch.ones(4, 4), "other": torch.ones(4)}
    grads = PO.tree_map(torch.ones_like, params)
    plain, _ = PO.adam_update(grads, PO.adam_init(params),
                              PO.tree_map(torch.clone, params), lr=1e-2)
    mults = PE.router_lr_mults(params, 0.0)
    assert mults == {"w_router": 0.0, "other": 1.0}
    assert PE.router_lr_mults(params, 1.0) is None
    scaled, _ = PO.adam_update(grads, PO.adam_init(params),
                               PO.tree_map(torch.clone, params), lr=1e-2,
                               lr_mults=mults)
    np.testing.assert_array_equal(scaled["w_router"].numpy(),
                                  params["w_router"].numpy())
    np.testing.assert_array_equal(scaled["other"].numpy(),
                                  plain["other"].numpy())
    # against the reference's update with the same multipliers
    jparams = {"w_router": jnp.ones((4, 4)), "other": jnp.ones((4,))}
    want, _ = JO.adam_update(jax.tree.map(jnp.ones_like, jparams),
                             JO.adam_init(jparams), jparams, lr=1e-2,
                             lr_mults={"w_router": 0.5, "other": 1.0})
    got, _ = PO.adam_update(grads, PO.adam_init(params),
                            PO.tree_map(torch.clone, params), lr=1e-2,
                            lr_mults=PE.router_lr_mults(params, 0.5))
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-7)


def test_router_z_weight_requires_aux_weight():
    with pytest.raises(ValueError, match="moe_aux_weight"):
        dataclasses.replace(PT.TINY_LM, n_experts=4, moe_ffn=32,
                            moe_router_z_weight=1e-3, moe_aux_weight=0.0)


def test_specs_and_shards(moe_params):
    _, pp = moe_params
    assert PE.moe_specs("ep") == PE.MoEParams((), ("ep",), ("ep",),
                                              ("ep",))
    shards = [PE.shard_moe_params(pp, "ep", r, 4) for r in range(4)]
    for k in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            torch.cat([getattr(s, k) for s in shards]).numpy(),
            getattr(pp, k).numpy())
    for s in shards:
        np.testing.assert_array_equal(s.w_router.numpy(),
                                      pp.w_router.numpy())
    cfg = dataclasses.replace(JT.TINY_LM, n_experts=8, moe_ffn=16)
    jparams = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(1),
                                                      cfg))
    jspecs = JE.moe_lm_specs(jparams)
    pspecs = PE.moe_lm_specs(jparams)
    for k, s in jspecs["layers"].items():
        assert tuple(s) == pspecs["layers"][k], k
    pcfg = dataclasses.replace(PT.TINY_LM, n_experts=8, moe_ffn=16)
    ranks = [bridge.params_to_numpy(bridge.moe_shards_from_jax(
        jparams, pcfg, r, 4)) for r in range(4)]
    assert ranks[1]["layers"]["w_gate"].shape == (4, 2, 64, 16)
    back = bridge.assemble_moe_shards(ranks)
    for k, v in jparams["layers"].items():
        np.testing.assert_array_equal(back["layers"][k], v, err_msg=k)
