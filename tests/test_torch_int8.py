"""The port's int8 tier against the JAX reference, on the CPU.

Same inputs, made from a seed with numpy (or by the reference's own
``init_params``, bridged leaf for leaf), go through the JAX function and
its counterpart in the port; they cross as numpy arrays.  On the CPU
the port's kernel wrappers (K4, K5, K2) take their plain versions.

Which JAX form each test is held against: the reference's quantizers
divide by a constant, which XLA turns into a multiplication by the f32
reciprocal under ``jax.jit``.  Its train and serve steps are jitted, so
the port's default quantizer is held against ``jax.jit`` of the
reference; ``quantize_decode_params`` runs eagerly in the reference, so
the port's (``eager=True`` scales) is held against the eager call.

Tolerances, each with its reason:
- quantisers, decode params, the plain K4 and K5, the ``quantized_dense``
  forward and the int8 backward products: bit for bit (integer products
  are exact, and both sides round at the same points);
- losses and straight-through grads: rtol = atol = 1e-5 (f32 sums in
  another order);
- whole-model int8 loss and grads, and one int8 paged layer: rtol =
  atol = 1e-5 (of the leaf's max for a grad).  An f32 summation-order
  difference upstream could flip an int8 code, a step of 1/127 of its
  row's absmax, which no such limit would pass; on these inputs none
  flips (the readings are 4e-7 of a leaf's max, and 4e-7 on layer
  outputs of magnitude 3.6).  Tokens must be equal exactly.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.ops import quant as JQ
from distributed_training_sandbox_tpu.serving import accounting as JA
from distributed_training_sandbox_tpu.serving import engine as JE
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import generate as PG
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.ops import paged_attention as PPA
from distributed_training_sandbox_tpu_torch.ops import quant as PQ
from distributed_training_sandbox_tpu_torch.serving import accounting as PA
from distributed_training_sandbox_tpu_torch.serving import engine as PE
torch.set_num_threads(1)  # the suite's workers share the cores

# the module (the reference's models package exports its generate function
# under the same name)
JG = importlib.import_module("distributed_training_sandbox_tpu.models.generate")

TOL = dict(rtol=1e-5, atol=1e-5)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits(t.numpy())


def _jax_params(cfg=JT.TINY_LM, seed=0, scale=3.0):
    params = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(lambda x: (x * scale).astype(x.dtype), params)


@pytest.fixture(scope="module")
def int8_weights():
    """(jax int8 decode params, port int8 decode params): the reference
    quantises eagerly and the codes cross the bridge."""
    jpq = JG.quantize_decode_params(_jax_params(), JT.TINY_LM)
    ppq = bridge.params_from_jax(jax.tree.map(np.asarray, jpq), PT.TINY_LM)
    return jpq, ppq


# ---- quantisers ----------------------------------------------------------

@pytest.mark.parametrize("form", ["jit", "eager"])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_quantize_int8_is_bitwise_jax(form, axis, in_dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 48)) * 3).astype(np.float32)
    x[5] = 0.0
    x[:, 7] = 0.0          # an all-zero row and column: scale 1, codes 0
    jfn = jax.jit(JQ.quantize_int8, static_argnames=("axis",)) \
        if form == "jit" else JQ.quantize_int8
    jq, js = jfn(jnp.asarray(x, dtype=in_dtype), axis=axis)
    pq, ps = PQ.quantize_int8(torch.from_numpy(x).to(getattr(torch, in_dtype)),
                              axis=axis, eager=form == "eager")
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert (_tbits(pq) == _bits(jq)).all()
    assert (_tbits(ps) == _bits(js)).all()


def test_jitted_and_eager_forms_differ_as_documented():
    """The two forms are not the same function: on random rows the
    scales differ on most tensors (ops/quant.py's docstring)."""
    rng = np.random.default_rng(1)
    differ = 0
    for _ in range(20):
        x = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
        differ += not torch.equal(PQ.quantize_int8(x)[1],
                                  PQ.quantize_int8(x, eager=True)[1])
    assert differ >= 15


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_decode_params_is_bitwise_eager_jax(dtype):
    jcfg = dataclasses.replace(JT.TINY_LM, dtype=jnp.dtype(dtype))
    pcfg = dataclasses.replace(PT.TINY_LM, dtype=getattr(torch, dtype))
    jp = _jax_params(jcfg)
    jpq = JG.quantize_decode_params(jp, jcfg)
    ppq = PG.quantize_decode_params(
        bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg), pcfg)
    assert sorted(ppq) == sorted(jpq) and "lm_head" not in ppq
    pairs = [(f"layers/{k}", ppq["layers"][k], jpq["layers"][k])
             for k in PG._QUANT_LAYER_KEYS] + [
        ("unembed_q", ppq["unembed_q"], jpq["unembed_q"])]
    for name, p, j in pairs:
        assert isinstance(p, PQ.QuantizedWeight), name
        assert p.q.shape == j.q.shape and p.s.shape == j.s.shape, name
        assert (_tbits(p.q) == _bits(j.q)).all(), name
        assert (_tbits(p.s) == _bits(j.s)).all(), name
    assert (_tbits(ppq["layers"]["ln1"]) == _bits(jpq["layers"]["ln1"])).all()


def test_bridge_carries_quantized_weights(int8_weights):
    jpq, ppq = int8_weights
    wq = ppq["layers"]["wq"]
    assert wq.q.dtype == torch.int8 and wq.s.dtype == torch.float32
    back = bridge.params_to_numpy(ppq)
    for k in PG._QUANT_LAYER_KEYS:
        assert (back["layers"][k].q == np.asarray(jpq["layers"][k].q)).all()
        assert (_bits(back["layers"][k].s)
                == _bits(jpq["layers"][k].s)).all()
    assert (back["unembed_q"].q == np.asarray(jpq["unembed_q"].q)).all()


def test_layer_params_slices_quantized_weights_field_by_field(int8_weights):
    """``v[li]`` on a NamedTuple picks a field (the whole stacked q at
    li = 0, s at li = 1); the slice must be taken per field."""
    _, ppq = int8_weights
    for li in (0, 1, 3):
        got = PT.layer_params(ppq, li)["wq"]
        assert isinstance(got, PQ.QuantizedWeight)
        assert torch.equal(got.q, ppq["layers"]["wq"].q[li])
        assert torch.equal(got.s, ppq["layers"]["wq"].s[li])


# ---- K4 and K5: plain versions against the Pallas kernels ----------------

def _int8_operands(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    jq = jax.jit(JQ.quantize_int8, static_argnames=("axis",))
    xq, xs = jq(jnp.asarray(x), axis=-1)
    wq, ws = jq(jnp.asarray(w), axis=0)
    return x, (xq, xs, wq, ws)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 256, 128), (40, 48, 24)],
                         ids=["aligned", "ragged"])
def test_plain_k4_is_bitwise_jax_pallas_interpret(shape, out_dtype):
    _, ops = _int8_operands(2, *shape)
    ref = JQ.int8_matmul_pallas(*ops, out_dtype=jnp.dtype(out_dtype),
                                interpret=True)
    PQ.INT8_COUNTS.reset()
    got = PQ.int8_matmul_kernel(*(torch.from_numpy(np.array(a))
                                  for a in ops), getattr(torch, out_dtype))
    assert (PQ.INT8_COUNTS.launches, PQ.INT8_COUNTS.plain_calls) == (0, 1)
    assert got.dtype == getattr(torch, out_dtype)
    assert (_tbits(got) == _bits(ref)).all()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 256, 128), (40, 48, 24)],
                         ids=["aligned", "ragged"])
def test_plain_k5_is_bitwise_jax_pallas_interpret(shape, out_dtype):
    x, (_, _, wq, ws) = _int8_operands(3, *shape)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = JQ.int8_matmul_pallas_fused(xb, wq, ws,
                                      out_dtype=jnp.dtype(out_dtype),
                                      interpret=True)
    PQ.INT8_FUSED_COUNTS.reset()
    got = PQ.int8_matmul_fused_kernel(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(np.array(wq)), torch.from_numpy(np.array(ws)),
        getattr(torch, out_dtype))
    assert (PQ.INT8_FUSED_COUNTS.launches,
            PQ.INT8_FUSED_COUNTS.plain_calls) == (0, 1)
    assert (_tbits(got) == _bits(ref)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 48), (208, 40)],
                         ids=["aligned", "ragged"])
def test_kmajor_weight_codes_are_the_reference_codes_transposed(shape,
                                                                dtype):
    """The training path's K5 weight: ``quantize_int8(w.t(), axis=-1)``
    gives (N, K) codes and (N, 1) scales, bit for bit the transpose of
    ``quantize_int8(w, axis=0)`` and of jitted JAX's."""
    rng = np.random.default_rng(8)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[:, 3] = 0.0          # an all-zero column: scale 1, codes 0
    jq, js = jax.jit(JQ.quantize_int8, static_argnames=("axis",))(
        jnp.asarray(w, dtype), axis=0)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    pq, ps = PQ.quantize_int8(tw.t(), axis=-1)
    rq, rs = PQ.quantize_int8(tw, axis=0)
    assert pq.shape == shape[::-1] and ps.shape == (shape[1], 1)
    assert torch.equal(pq, rq.t()) and torch.equal(ps, rs.t())
    assert (_tbits(pq) == _bits(np.asarray(jq).T)).all()
    assert (_tbits(ps) == _bits(np.asarray(js).T)).all()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 256, 128), (40, 48, 24)],
                         ids=["aligned", "ragged"])
def test_plain_k5_kmajor_is_bitwise_jax_pallas_interpret(shape, out_dtype):
    """K5's wrapper with the weight K-major (the training path's layout)
    against the reference's Pallas kernel on its (K, N) weight."""
    x, (_, _, wq, ws) = _int8_operands(9, *shape)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = JQ.int8_matmul_pallas_fused(xb, wq, ws,
                                      out_dtype=jnp.dtype(out_dtype),
                                      interpret=True)
    PQ.INT8_FUSED_COUNTS.reset()
    got = PQ.int8_matmul_fused_kernel(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(np.ascontiguousarray(np.asarray(wq).T)),
        torch.from_numpy(np.array(ws).T), getattr(torch, out_dtype),
        b_kmajor=True)
    assert (PQ.INT8_FUSED_COUNTS.launches,
            PQ.INT8_FUSED_COUNTS.plain_calls) == (0, 1)
    assert (_tbits(got) == _bits(ref)).all()



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(70, 40), (333, 24), (14, 160)],
                         ids=["ragged", "tall", "tiny_lm_rows"])
def test_quantize_along_m_writes_the_transposed_codes(shape, dtype):
    """The int8 backward's dW operands: ``quantize_int8(x.t(), axis=-1)``
    gives contiguous (K, M) codes and (K, 1) scales, bit for bit the
    transpose of ``quantize_int8(x, axis=0)`` and of jitted JAX's."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    x[:, 5] = 0.0          # an all-zero column: scale 1, codes 0
    jq, js = jax.jit(JQ.quantize_int8, static_argnames=("axis",))(
        jnp.asarray(x, dtype), axis=0)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pq, ps = PQ.quantize_int8(tx.t(), axis=-1)
    rq, rs = PQ.quantize_int8(tx, axis=0)
    assert pq.shape == shape[::-1] and ps.shape == (shape[1], 1)
    assert pq.is_contiguous()
    assert torch.equal(pq, rq.t()) and torch.equal(ps, rs.t())
    assert (_tbits(pq) == _bits(np.asarray(jq).T)).all()
    assert (_tbits(ps) == _bits(np.asarray(js).T)).all()


# ---- quantized_dense --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_fused"])
def test_quantized_dense_forward_is_bitwise_jitted_jax(impl, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    jfn = jax.jit(lambda x, w: JQ.quantized_dense(x, w, impl, True, False))
    ref = jfn(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    td = getattr(torch, dtype)
    got = PQ.quantized_dense(torch.from_numpy(x).to(td),
                             torch.from_numpy(w).to(td), impl)
    assert got.dtype == td and got.shape == (2, 8, 48)
    assert (_tbits(got) == _bits(ref)).all()


@pytest.mark.parametrize("name", ["int8", "int8_pallas", "int8_bwd",
                                  "int8_pallas_bwd"])
def test_quantized_dense_value_and_grads_match_jitted_jax(name):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    r = rng.standard_normal((2, 8, 48)).astype(np.float32)
    jdense = JQ.resolve_quantized_dense(name)

    def jloss(x, w):
        out = jdense(x, w)
        return jnp.sum(out * r), out

    (jl, jout), (jgx, jgw) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    px = torch.from_numpy(x).requires_grad_(True)
    pw = torch.from_numpy(w).requires_grad_(True)
    PQ.INT8_COUNTS.reset()
    PQ.INT8_FUSED_COUNTS.reset()
    out = PQ.resolve_quantized_dense(name)(px, pw)
    loss = (out * torch.from_numpy(r)).sum()
    loss.backward()
    fused, bwd = "pallas" in name, name.endswith("_bwd")
    assert (PQ.INT8_FUSED_COUNTS.plain_calls, PQ.INT8_COUNTS.plain_calls) \
        == (int(fused), int(not fused) + 2 * int(bwd))
    assert (_tbits(out) == _bits(jout)).all()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    if bwd:   # int8 products with the same codes: bit for bit
        assert (_tbits(px.grad) == _bits(jgx)).all()
        assert (_tbits(pw.grad) == _bits(jgw)).all()
    else:     # straight-through f32 products: summation order
        np.testing.assert_allclose(px.grad.numpy(), np.asarray(jgx), **TOL)
        np.testing.assert_allclose(pw.grad.numpy(), np.asarray(jgw), **TOL)



# TINY_LM's projections (K, N) and its token rows: 2 x 8, and 2 x 7 (a
# contraction over M that is not a multiple of 16)
TINY_PROJECTIONS = {"wq": (64, 64), "wk": (64, 32), "w_up": (64, 160),
                    "w_down": (160, 64)}


@pytest.mark.parametrize("rows", [(2, 8), (2, 7)], ids=["16", "14"])
@pytest.mark.parametrize("proj", list(TINY_PROJECTIONS))
@pytest.mark.parametrize("name", ["int8_bwd", "int8_pallas_bwd"])
def test_int8_backward_is_bitwise_jitted_jax_on_tiny_lm(name, proj, rows):
    """The int8 backward with dW's operands quantised along M straight
    into K-major codes: value, dX and dW bit for bit jitted JAX's at
    TINY_LM's projection shapes."""
    K, N = TINY_PROJECTIONS[proj]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((*rows, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    r = rng.standard_normal((*rows, N)).astype(np.float32)
    jdense = JQ.resolve_quantized_dense(name)
    (jl, jout), (jgx, jgw) = jax.jit(jax.value_and_grad(
        lambda x, w: (jnp.sum(jdense(x, w) * r), jdense(x, w)),
        argnums=(0, 1), has_aux=True))(jnp.asarray(x), jnp.asarray(w))
    px = torch.from_numpy(x).requires_grad_(True)
    pw = torch.from_numpy(w).requires_grad_(True)
    out = PQ.resolve_quantized_dense(name)(px, pw)
    (out * torch.from_numpy(r)).sum().backward()
    assert (_tbits(out) == _bits(jout)).all()
    assert (_tbits(px.grad) == _bits(jgx)).all()
    assert (_tbits(pw.grad) == _bits(jgw)).all()


def test_plain_int8_products_take_the_plain_versions():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    ref = PQ.quantized_dense(x, w, "pallas_fused")
    PQ.INT8_COUNTS.reset()
    PQ.INT8_FUSED_COUNTS.reset()
    with PQ.plain_int8_products():
        got = PQ.quantized_dense(x.clone().requires_grad_(True), w,
                                 "pallas_fused", True)
        got.sum().backward()
        PQ.prequantized_dense(x, PQ.quantize_weight(w))
    assert PQ.INT8_FUSED_COUNTS.plain_calls == 0
    assert PQ.INT8_COUNTS.plain_calls == 1 + 2 + 1
    assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="impl"):
        PQ.quantized_dense(x, w, "cutlass")


# ---- the model at each int8 precision ----------------------------------------

def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("precision", ["int8", "int8_pallas", "int8_bwd",
                                       "int8_pallas_bwd"])
def test_lm_loss_and_every_grad_leaf_match_jitted_jax(precision):
    jcfg = dataclasses.replace(JT.TINY_LM, matmul_precision=precision,
                               loss_vocab_chunk=96)
    pcfg = dataclasses.replace(PT.TINY_LM, matmul_precision=precision,
                               loss_vocab_chunk=96)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(6)
    w = rng.integers(0, PT.TINY_LM.vocab_size, size=(2, 17))
    ids, labels = w[:, :-1].astype(np.int32), w[:, 1:].astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, b, jcfg)))(
        jp, (jnp.asarray(ids), jnp.asarray(labels)))
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    leaves = [v.requires_grad_(True) for _, v in _flat(pp)]
    loss = PT.lm_loss(pp, (torch.from_numpy(ids), torch.from_numpy(labels)),
                      pcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    for (name, _), g in zip(_flat(pp), grads):
        ref = jflat[name]
        np.testing.assert_allclose(
            g.numpy(), ref, err_msg=name, rtol=1e-5,
            atol=TOL["atol"] * float(np.abs(ref).max()))


# ---- the int8 paged layer -------------------------------------------------

def _q8_pool_case(seed, S, cfg=PT.TINY_LM):
    """int8 pools from the reference's own quantiser on random K/V rows,
    a page table with null-page padding, ragged apos."""
    rng = np.random.default_rng(seed)
    B, page, P, n_pages = 3, 8, 6, 19
    nkv, hd = cfg.num_key_value_heads, cfg.resolved_head_dim
    raw = rng.standard_normal((2, n_pages, page, nkv, hd)).astype(np.float32)
    jq = jax.jit(JQ.quantize_int8, static_argnames=("axis",))
    (pk, pk_s), (pv, pv_s) = (jq(jnp.asarray(r)) for r in raw)
    last = rng.integers(S - 1, P * page, size=B)
    apos = (last[:, None] - (S - 1) + np.arange(S)).astype(np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((B, P), np.int32)
    used = 0
    for b in range(B):
        n = int(last[b]) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    x = rng.standard_normal((B, S, cfg.hidden_size)).astype(np.float32)
    pools = tuple(np.asarray(a) for a in (pk, pv, pk_s, pv_s))
    return x, pools, pages, apos


@pytest.mark.parametrize("paged_kernel", [False, True],
                         ids=["gather", "kernel_entry"])
@pytest.mark.parametrize("S", [1, 5])
def test_paged_layer_body_int8_matches_jitted_jax(int8_weights, S,
                                                  paged_kernel):
    """One layer of the int8 engine on an int8 pool, int8 weights;
    ``kernel_entry`` sends S == 1 through K2's wrapper (its plain
    version on the CPU).  The reference runs its gather path."""
    jpq, ppq = int8_weights
    cfg = PT.TINY_LM
    x, pools, pages, apos = _q8_pool_case(10 + S, S)
    valid = np.ones(apos.shape, bool)
    jcos, jsin = JE._ragged_rope_tables(jnp.asarray(apos),
                                        cfg.resolved_head_dim, cfg.rope_theta)
    jlayer = jax.tree.map(lambda p: p[1], jpq["layers"])

    @jax.jit
    def jbody(x, pk, pv, pk_s, pv_s):
        return JE._paged_layer_body(
            x, jlayer, cfg=JT.TINY_LM, cos=jcos, sin=jsin, use_rope=True,
            pk=pk, pv=pv, pk_s=pk_s, pv_s=pv_s, pages=jnp.asarray(pages),
            apos=jnp.asarray(apos), valid=jnp.asarray(valid))

    jx, jpools = jbody(jnp.asarray(x), *map(jnp.asarray, pools))
    pcos, psin = PE._ragged_rope_tables(torch.from_numpy(apos),
                                        cfg.resolved_head_dim, cfg.rope_theta)
    pk, pv, pk_s, pv_s = (torch.from_numpy(a.copy()) for a in pools)
    PPA.Q8_COUNTS.reset()
    got = PE._paged_layer_body(
        torch.from_numpy(x), PT.layer_params(ppq, 1), cfg=cfg, cos=pcos,
        sin=psin, use_rope=True, pk=pk, pv=pv, pages=torch.from_numpy(pages),
        apos=torch.from_numpy(apos), valid=torch.from_numpy(valid),
        paged_kernel=paged_kernel, pk_s=pk_s, pv_s=pv_s)
    assert PPA.Q8_COUNTS.plain_calls == int(S == 1)
    assert PPA.Q8_COUNTS.launches == 0
    # the written rows: the same codes; scales at f32 level
    for t, j in zip((pk, pv), jpools[:2]):
        assert (t.numpy() == np.asarray(j)).all()
    for t, j in zip((pk_s, pv_s), jpools[2:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), **TOL)


# the positions where K2's work splits, in a 2048-position view of pages
# of 16: apos 0 (one key); 7 and 8 (one position a block of the cluster
# of 8, then blocks with none); the first page's last row and the next
# page's first; a block's range edge ± 1 (256 = 8 · 32 visible
# positions); the edge ± 1 where a block's range becomes two sub-ranges
# at hd 128 (8 · PPA.rows_held_q8(2048, 128) = 1792); the view's last two
K2_VIEW, K2_PAGE = 2048, 16
K2_SPLITS = (0, 7, 8, 15, 16, 255, 256, 257, 1791, 1792, 1793, 2046, 2047)


def _q8_view_case(seed, last, cfg):
    """One slot per entry of ``last`` (its new row's absolute position)
    over a ``K2_VIEW``-position view: int8 pools from the reference's
    jitted quantiser on random K/V rows, each slot's table row padded
    with the null page 0, one input row a slot."""
    rng = np.random.default_rng(seed)
    nkv, hd = cfg.num_key_value_heads, cfg.resolved_head_dim
    B, P = len(last), K2_VIEW // K2_PAGE
    n_pages = sum(a // K2_PAGE + 1 for a in last) + 1
    raw = rng.standard_normal((2, n_pages, K2_PAGE, nkv, hd)) \
        .astype(np.float32)
    jq = jax.jit(JQ.quantize_int8, static_argnames=("axis",))
    (pk, pk_s), (pv, pv_s) = (jq(jnp.asarray(r)) for r in raw)
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((B, P), np.int32)
    used = 0
    for b, a in enumerate(last):
        n = a // K2_PAGE + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    x = rng.standard_normal((B, 1, cfg.hidden_size)).astype(np.float32)
    pools = tuple(np.asarray(a) for a in (pk, pv, pk_s, pv_s))
    return x, pools, pages, np.array(last, np.int32)[:, None]


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_k2_plain_matches_jitted_jax_where_the_kernel_splits(rep):
    """One int8 decode layer (TINY_LM's width, hd 16, 2 kv heads, rep
    query rows each) with S == 1 through K2's wrapper, which takes its
    plain version on the CPU, against the reference's jitted gather
    path, one slot at each of ``K2_SPLITS``.  Tolerance: ``TOL``, as in
    ``test_paged_layer_body_int8_matches_jitted_jax`` (no code of the
    requantised probabilities flips on these inputs)."""
    geom = dict(num_attention_heads=2 * rep, num_key_value_heads=2,
                head_dim=16, num_hidden_layers=1)
    jcfg = dataclasses.replace(JT.TINY_LM, **geom)
    cfg = dataclasses.replace(PT.TINY_LM, **geom)
    jpq = JG.quantize_decode_params(_jax_params(jcfg, seed=rep), jcfg)
    ppq = bridge.params_from_jax(jax.tree.map(np.asarray, jpq), cfg)
    x, pools, pages, apos = _q8_view_case(30 + rep, K2_SPLITS, cfg)
    valid = np.ones(apos.shape, bool)
    jcos, jsin = JE._ragged_rope_tables(jnp.asarray(apos),
                                        cfg.resolved_head_dim, cfg.rope_theta)
    jlayer = jax.tree.map(lambda p: p[0], jpq["layers"])

    @jax.jit
    def jbody(x, pk, pv, pk_s, pv_s):
        return JE._paged_layer_body(
            x, jlayer, cfg=jcfg, cos=jcos, sin=jsin, use_rope=True,
            pk=pk, pv=pv, pk_s=pk_s, pv_s=pv_s, pages=jnp.asarray(pages),
            apos=jnp.asarray(apos), valid=jnp.asarray(valid))

    jx, _ = jbody(jnp.asarray(x), *map(jnp.asarray, pools))
    pcos, psin = PE._ragged_rope_tables(torch.from_numpy(apos),
                                        cfg.resolved_head_dim, cfg.rope_theta)
    pk, pv, pk_s, pv_s = (torch.from_numpy(a.copy()) for a in pools)
    PPA.Q8_COUNTS.reset()
    got = PE._paged_layer_body(
        torch.from_numpy(x), PT.layer_params(ppq, 0), cfg=cfg, cos=pcos,
        sin=psin, use_rope=True, pk=pk, pv=pv, pages=torch.from_numpy(pages),
        apos=torch.from_numpy(apos), valid=torch.from_numpy(valid),
        paged_kernel=True, pk_s=pk_s, pv_s=pv_s)
    assert (PPA.Q8_COUNTS.launches, PPA.Q8_COUNTS.plain_calls) == (0, 1)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), **TOL)


def test_decode_wrapper_takes_k2_plain_version_on_the_cpu():
    x, (pk, pv, pk_s, pv_s), pages, apos = _q8_pool_case(3, 1)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((3, 1, 2, 2, 16))
                         .astype(np.float32))
    qq, qs = PQ.quantize_int8(q)
    args = [torch.from_numpy(np.array(a)) for a in (pk, pv, pk_s, pv_s)]
    PPA.Q8_COUNTS.reset()
    got = PPA.paged_attention_decode(qq, args[0], args[1],
                                     torch.from_numpy(pages),
                                     torch.from_numpy(apos), q_scale=qs,
                                     pk_s=args[2], pv_s=args[3])
    assert (PPA.Q8_COUNTS.launches, PPA.Q8_COUNTS.plain_calls) == (0, 1)
    ref = PPA.gather_attention_q8(qq, qs, *args, torch.from_numpy(pages),
                                  torch.from_numpy(apos))
    assert torch.equal(got, ref) and got.dtype == torch.float32
    with pytest.raises(ValueError, match="q_scale"):
        PPA.paged_attention_decode(qq, args[0], args[1],
                                   torch.from_numpy(pages),
                                   torch.from_numpy(apos))


# ---- generate and the engine ---------------------------------------------

ENGINE = dict(max_batch=3, page_size=8, max_seq_len=48, prefill_chunk=8,
              sync_every=4)


def _prompts(n, seed, lo=3, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, PT.TINY_LM.vocab_size,
                         size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def test_generate_kv_quant_tokens_equal_jax(int8_weights):
    jpq, ppq = int8_weights
    for prompt in _prompts(3, seed=21):
        ref = np.asarray(JG.generate(jpq, jnp.asarray(prompt[None]),
                                     JT.TINY_LM, max_new_tokens=10,
                                     kv_quant=True, cache_capacity=48))[0]
        got = PG.generate(ppq, prompt[None], PT.TINY_LM, max_new_tokens=10,
                          kv_quant=True, cache_capacity=48, device="cpu")[0]
        assert got.tolist() == ref.tolist()


def test_port_engine_kv_quant_emits_jax_engine_tokens(int8_weights):
    jpq, ppq = int8_weights
    prompts = _prompts(7, seed=5)
    jeng = JE.ServingEngine(jpq, JT.TINY_LM, kv_quant=True, **ENGINE)
    jreqs = [jeng.submit(p, max_new_tokens=10) for p in prompts]
    jeng.run()
    eng = PE.ServingEngine(ppq, PT.TINY_LM, kv_quant=True, paged_kernel=True,
                           device="cpu", **ENGINE)
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.run()
    assert eng.slo_report()["completed"] == len(prompts)
    for j, p in zip(jreqs, reqs):
        assert p.tokens == j.tokens, (p.rid, p.tokens, j.tokens)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_port_engine_kv_quant_equals_port_generate(int8_weights, kernels):
    _, ppq = int8_weights
    prompts = _prompts(6, seed=9)
    PPA.Q8_COUNTS.reset()
    PQ.INT8_COUNTS.reset()
    eng = PE.ServingEngine(ppq, PT.TINY_LM, kv_quant=True,
                           paged_kernel=kernels, device="cpu", **ENGINE)
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.run()
    L = PT.TINY_LM.num_hidden_layers
    steps, chunks = eng.stats["decode_steps"], eng.stats["prefill_chunks"]
    # CPU tensors take the plain versions: K2 on every decode step's
    # layers, K4 on every projection and the unembedding of every forward
    assert (PPA.Q8_COUNTS.launches, PPA.Q8_COUNTS.plain_calls) == (
        0, steps * L)
    assert (PQ.INT8_COUNTS.launches, PQ.INT8_COUNTS.plain_calls) == (
        0, (steps + chunks) * (7 * L + 1))
    assert eng.pool.bufs.k[0].dtype == torch.int8
    assert eng.slo_report()["kv_quant"] is True
    for r in reqs:
        ref = PG.generate(ppq, r.prompt[None], PT.TINY_LM, max_new_tokens=10,
                          cache_capacity=eng.view_capacity, kv_quant=True,
                          device="cpu")[0]
        assert r.tokens == ref.tolist(), (r.rid, r.tokens, ref.tolist())


def test_engine_refuses_kv_quant_with_flash_prefill(int8_weights):
    _, ppq = int8_weights
    with pytest.raises(ValueError, match="float-only"):
        PE.ServingEngine(ppq, PT.TINY_LM, kv_quant=True, flash_prefill=True,
                         device="cpu", **ENGINE)


def test_kv_quant_accounting_matches_jax():
    for kv_quant in (False, True):
        assert PA.page_bytes(PT.SMOLLM3_3B, 16, kv_quant=kv_quant) \
            == JA.page_bytes(JT.SMOLLM3_3B, 16, kv_quant=kv_quant)
        assert PA.kv_bytes_per_step(PT.SMOLLM3_3B, 8, 2048,
                                    kv_quant=kv_quant) \
            == JA.kv_bytes_per_step(JT.SMOLLM3_3B, 8, 2048, kv_quant)
        assert PA.serve_waterline_gb(PT.SMOLLM3_3B, 1025, 16,
                                     weight_bytes=123, kv_quant=kv_quant) \
            == JA.serve_waterline_gb(JT.SMOLLM3_3B, 1025, 16,
                                     weight_bytes=123, kv_quant=kv_quant)
    assert PA.weight_read_bytes(PT.SMOLLM3_3B, {"unembed_q": None}, 10 ** 10) \
        == JA.weight_read_bytes(JT.SMOLLM3_3B, {"unembed_q": None}, 10 ** 10)
