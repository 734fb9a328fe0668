"""The port's training slice against the JAX reference, on the CPU.

Same inputs, made from a seed with numpy (or by the reference's own
``init_params``, bridged leaf for leaf), go through the JAX function and
its counterpart in the port; they cross as numpy arrays.  On the CPU the
port's kernel wrappers take their plain versions.  The reference's fp8
Pallas kernel runs in interpret mode, as its own tests run it; its
splash attention cannot run on a CPU, so the port's attention is held
against ``_attention_xla``, which computes the same function.

Tolerances, each with its reason:
- fp8 quantisation, the data pipeline: bit for bit (the same
  arithmetic; torch's fp8 casts equal JAX's);
- the plain fp8 product: rtol 1e-6, atol 1e-6 (exact products, f32
  sums in another order);
- f32 model math, losses, grads, Adam: rtol = atol = 1e-5 (XLA and
  torch reduce in different orders); fp8 grad leaves: atol
  ``FP8_LEAF_ATOL`` of the leaf's max (one flipped fp8 rounding);
- bf16 Adam: two bf16 ulps over three steps (XLA fuses the moment update and rounds
  once, torch rounds after each operation);
- three train steps: rtol 2e-4 on losses, atol 1e-4 on params (Adam's
  first steps move each weight by about lr · sign(grad), which
  magnifies grad differences at f32 level); under fp8, relative L2
  ``FP8_PARAM_L2`` per param leaf;
- bf16 attention: atol = rtol = 1.6e-2 on values and 3e-2 on grads
  (the same operations rounding to bf16 at the same points, where a
  summation-order difference can move a value by one bf16 ulp, 2^-7
  relative at most, and the backward chains a few such roundings).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_training_sandbox_tpu.data import packing as JD
from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.ops import quant as JQ
from distributed_training_sandbox_tpu.parallel import fsdp as JF
from distributed_training_sandbox_tpu.parallel import optim as JO
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.data import packing as PD
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.ops import flash_attention as PFA
from distributed_training_sandbox_tpu_torch.ops import quant as PQ
from distributed_training_sandbox_tpu_torch.parallel import fsdp as PF
from distributed_training_sandbox_tpu_torch.parallel import optim as PO
from distributed_training_sandbox_tpu_torch.train import flagship
torch.set_num_threads(1)  # the suite's workers share the cores

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
# fp8 grad leaves: an f32 summation-order difference upstream can flip
# one e4m3 / e5m2 rounding (a step of 2^-3 relative), which moves the
# few products it feeds; atol is this fraction of the leaf's max |grad|
FP8_LEAF_ATOL = 5e-3
# fp8 params after three Adam steps: relative L2 error per leaf (a
# flipped fp8 rounding can turn one weight's lr·sign(grad) step)
FP8_PARAM_L2 = 1e-2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint16)


# ---- fp8 -------------------------------------------------------------------

@pytest.mark.parametrize("hist", [0, 16], ids=["dynamic", "delayed"])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_quantize_fp8_is_bitwise_jax(fmt, hist, in_dtype):
    """Held against the JITTED reference quantizer, the form its train
    step runs (XLA folds ``amax / fmax`` into ``amax * f32(1/fmax)``)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 48)) * 3).astype(np.float32)
    x[3, 5] = 900.0   # one outlier sets the scale
    jdt = {"e4m3": JQ.FP8_FWD_DTYPE, "e5m2": JQ.FP8_BWD_DTYPE}[fmt]
    pdt = {"e4m3": PQ.FP8_FWD_DTYPE, "e5m2": PQ.FP8_BWD_DTYPE}[fmt]
    jq, js = jax.jit(JQ.quantize_fp8, static_argnums=(1,),
                     static_argnames=("amax_history_len",))(
        jnp.asarray(x, dtype=in_dtype), jdt, amax_history_len=hist)
    pq, ps = PQ.quantize_fp8(torch.from_numpy(x).to(getattr(torch, in_dtype)),
                             pdt, amax_history_len=hist)
    assert PQ.fp8_max(pdt) == JQ.fp8_max(jdt)
    assert (pq.view(torch.uint8).numpy() == _bits(jq)).all()
    assert ps.dtype == torch.float32
    assert np.float32(ps.item()) == np.float32(js)


@pytest.mark.parametrize("shape", [(256, 512, 384), (200, 176, 136)],
                         ids=["aligned", "ragged"])
def test_plain_fp8_matmul_matches_jax_pallas_interpret(shape):
    M, K, N = shape
    rng = np.random.default_rng(1)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    aq, a_s = JQ.quantize_fp8(jnp.asarray(a))
    bq, b_s = JQ.quantize_fp8(jnp.asarray(b))
    ref = JQ.fp8_matmul_pallas(aq, a_s, bq, b_s, out_dtype=jnp.float32,
                               interpret=True)
    paq, pas = PQ.quantize_fp8(torch.from_numpy(a))
    # the kernel takes B K-major, as the training path quantises it
    pbt, pbs = PQ.quantize_fp8_kmajor(torch.from_numpy(b))
    PQ.COUNTS.reset()
    got = PQ.fp8_matmul_kernel(paq, pas, pbt, pbs, torch.float32)
    assert (PQ.COUNTS.launches, PQ.COUNTS.plain_calls) == (0, 1)
    # atol: a few f32 ulps of the partial sums (|out| ~ 0.5), where the
    # two sum orders cancel to near zero
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_fp8_dense_value_and_grads_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    r = rng.standard_normal((2, 8, 48)).astype(np.float32)

    def jloss(x, w):
        out = JQ.fp8_dense(x, w, "pallas", True, 0)
        return jnp.sum(out * r), out

    (_, jout), (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    px = torch.from_numpy(x).requires_grad_(True)
    pw = torch.from_numpy(w).requires_grad_(True)
    PQ.COUNTS.reset()
    PQ.BWD_COUNTS.reset()
    out = PQ.fp8_dense(px, pw, "kernel")
    (out * torch.from_numpy(r)).sum().backward()
    assert (PQ.COUNTS.plain_calls, PQ.BWD_COUNTS.plain_calls) == (1, 2)
    np.testing.assert_allclose(_np(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(_np(px.grad), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(_np(pw.grad), np.asarray(jgw), **TOL)


def test_resolve_quantized_dense_names():
    """Every name resolves to a matmul that also takes a
    ``QuantizedWeight`` (routed through ``prequantized_dense``, as the
    reference wraps even ``bf16``); an unknown name raises."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    qw = PQ.quantize_weight(w, eager=True)
    want = PQ.prequantized_dense(a, qw)
    for name in PT.PRECISIONS:
        dense = PQ.resolve_quantized_dense(name)
        assert dense is not torch.matmul and callable(dense)
        assert dense(a, w).shape == (3, 16)
        assert torch.equal(dense(a, qw), want), name
    torch.testing.assert_close(PQ.resolve_quantized_dense("bf16")(a, w),
                               a @ w, atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown"):
        PQ.resolve_quantized_dense("int4")


# ---- attention ---------------------------------------------------------------

@pytest.mark.parametrize("S", [128, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_and_grads_match_jax(dtype, S):
    rng = np.random.default_rng(3)
    B, nq, nkv, hd = 2, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (nq, nkv, nkv))
    do = rng.standard_normal((B, S, nq, hd)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)

    def jfn(q, k, v):
        out = JT._attention_xla(q, k, v, scale)
        return jnp.sum(out.astype(jnp.float32) * do), out

    jargs = [jnp.asarray(a, dtype=dtype) for a in (q, k, v)]
    (_, jout), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                       has_aux=True)(*jargs)
    pargs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
             for a in (q, k, v)]
    PFA.FWD_COUNTS.reset()
    PFA.BWD_COUNTS.reset()
    out = PFA.flash_attention(*pargs, scale)
    (out.float() * torch.from_numpy(do)).sum().backward()
    assert out.dtype == pargs[0].dtype and out.shape == (B, S, nq, hd)
    assert (PFA.FWD_COUNTS.plain_calls, PFA.BWD_COUNTS.plain_calls) == (1, 1)
    assert PFA.FWD_COUNTS.launches == PFA.BWD_COUNTS.launches == 0
    vtol = TOL if dtype == "float32" else dict(rtol=1.6e-2, atol=1.6e-2)
    gtol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(out), np.asarray(jout, np.float32), **vtol)
    for p, j in zip(pargs, jg):
        np.testing.assert_allclose(_np(p.grad), np.asarray(j, np.float32),
                                   **gtol)


def test_plain_lse_is_the_row_logsumexp():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 9, n, 16))
                                .astype(np.float32)) for n in (4, 2, 2))
    out, lse = PFA.attention_plain_lse(q, k, v, 0.25)
    s = torch.einsum("bqnh,bknh->bnqk", q,
                     torch.repeat_interleave(k, 2, dim=2)) * 0.25
    s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), **TOL)
    torch.testing.assert_close(out, PFA.attention_plain(q, k, v, 0.25),
                               atol=0, rtol=0)


# ---- loss --------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 16, 100], ids=["dense", "c16", "c100"])
def test_xent_value_and_grads_match_jax(chunk):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    w = (rng.standard_normal((100, 32)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 100, size=(2, 9)).astype(np.int32)
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda x, w: JT.xent_from_hidden(x, w, jnp.asarray(labels),
                                         chunk=chunk), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    px = torch.from_numpy(x).requires_grad_(True)
    pw = torch.from_numpy(w).requires_grad_(True)
    loss = PT.xent_from_hidden(px, pw, torch.from_numpy(labels), chunk=chunk)
    loss.backward()
    assert torch.isfinite(px.grad).all() and torch.isfinite(pw.grad).all()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(_np(px.grad), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(_np(pw.grad), np.asarray(jgw), **TOL)
    if chunk:
        jc = JT.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(labels), chunk)
        pc = PT.chunked_softmax_xent(px.detach(), pw.detach(),
                                     torch.from_numpy(labels), chunk)
        np.testing.assert_allclose(pc.item(), float(jc), **TOL)


def _tiny(precision, chunk, **kw):
    return (dataclasses.replace(JT.TINY_LM, matmul_precision=precision,
                                loss_vocab_chunk=chunk, **kw),
            dataclasses.replace(PT.TINY_LM, matmul_precision=precision,
                                loss_vocab_chunk=chunk, **kw))


def _tiny_batch(seed=6, B=2, S=16):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, PT.TINY_LM.vocab_size, size=(B, S + 1))
    return w[:, :-1].astype(np.int32), w[:, 1:].astype(np.int32)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _port_grads(pp, batch, cfg):
    leaves = [v.requires_grad_(True) for _, v in _flat(pp)]
    loss = PT.lm_loss(pp, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    for v in leaves:
        v.requires_grad_(False)
    return loss, [g.numpy() for g in grads]


@pytest.mark.parametrize("chunk", [None, 96], ids=["dense", "chunked"])
@pytest.mark.parametrize("precision", ["bf16", "fp8_pallas"])
def test_lm_loss_and_every_grad_leaf_match_jax(precision, chunk):
    jcfg, pcfg = _tiny(precision, chunk)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    ids, labels = _tiny_batch()
    jl, jg = jax.value_and_grad(JT.lm_loss)(
        jp, (jnp.asarray(ids), jnp.asarray(labels)), jcfg)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    batch = (torch.from_numpy(ids), torch.from_numpy(labels))
    loss, grads = _port_grads(pp, batch, pcfg)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    jflat = dict(_flat(jax.tree.map(np.asarray, jg)))
    names = [n for n, _ in _flat(pp)]
    assert sorted(names) == sorted(jflat)
    for name, g in zip(names, grads):
        tol = TOL if precision == "bf16" else dict(
            rtol=1e-5, atol=FP8_LEAF_ATOL * float(np.abs(jflat[name]).max()))
        np.testing.assert_allclose(g, jflat[name], err_msg=name, **tol)
    # remat (each layer under torch.utils.checkpoint) changes nothing
    rcfg = dataclasses.replace(pcfg, remat=True)
    rloss, rgrads = _port_grads(pp, batch, rcfg)
    assert rloss.item() == loss.item()
    for name, a, b in zip(names, grads, rgrads):
        assert (a == b).all(), name


def test_forward_logits_match_jax():
    jcfg, pcfg = _tiny("bf16", None)
    jp = JT.init_params(jax.random.PRNGKey(1), jcfg)
    ids, _ = _tiny_batch(seed=7)
    ref = JT.forward(jp, jnp.asarray(ids), jcfg)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    got = PT.forward(pp, torch.from_numpy(ids), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert PT.model_flops_per_token(PT.SMOLLM3_3B_L8, 8192) == \
        JT.model_flops_per_token(JT.SMOLLM3_3B_L8, 8192)


def test_unported_training_options_raise():
    # save_dots runs at every precision (at int8_pallas it keeps nothing
    # of the projections: tests/test_torch_remat_precisions.py)
    PT.resolve_remat_policy(dataclasses.replace(
        PT.TINY_LM, remat_policy="save_dots", matmul_precision="int8_pallas"))
    # ring attention is ported; a ring config without its sequence axis
    # is refused, as the reference's __post_init__ refuses it
    with pytest.raises(ValueError, match="needs sp_axis"):
        PT.check_supported(dataclasses.replace(PT.TINY_LM,
                                               attention_impl="ring"))
    pp = PT.init_params(PT.TINY_LM, torch.Generator().manual_seed(0), "cpu")
    for kw in ({"offload": "opt"}, {"offload": "opt_act"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PF.make_fsdp_train_step(pp, PT.TINY_LM, **kw)
    # the native engine and the corpus source are ported; the sources
    # that need a hub download stay refused
    with pytest.raises(NotImplementedError):
        PD.make_packed_dataset(8, 100, source="auto")
    with pytest.raises(NotImplementedError):
        PD.make_packed_dataset(8, 100, source="tinystories")


# ---- optimiser, schedule, data -----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_update_matches_jax(dtype):
    cfg = dataclasses.replace(PT.TINY_LM, dtype=getattr(torch, dtype))
    rng = np.random.default_rng(8)
    tree = {"a": rng.standard_normal((5, 7)), "b": {"c": rng.standard_normal(
        (3,))}}
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    grads = [jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, dtype), tree) for _ in range(3)]
    jstate = JO.adam_init(params)
    # one JAX step first; both optimisers then go on from its state
    params, jstate = JO.adam_update(grads[0], jstate, params, lr=1e-2,
                                    b2=0.95)
    pparams = bridge.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    pstate = bridge.adam_state_from_jax(
        jax.tree.map(np.asarray, jstate.mu),
        jax.tree.map(np.asarray, jstate.nu), int(jstate.count), cfg)
    for g in grads[1:]:
        params, jstate = JO.adam_update(g, jstate, params, lr=1e-2, b2=0.95)
        pg = bridge.params_from_jax(jax.tree.map(np.asarray, g), cfg)
        pparams, pstate = PO.adam_update(pg, pstate, pparams, lr=1e-2,
                                         b2=0.95)
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -6, atol=1e-6)
    for (n, a), (_, b) in zip(_flat(jax.tree.map(np.asarray, params)),
                              _flat(bridge.params_to_numpy(pparams))):
        np.testing.assert_allclose(np.float32(b), np.float32(a), err_msg=n,
                                   **tol)
    mu, nu, count = bridge.adam_state_to_numpy(pstate)
    assert count == int(jstate.count) == 3
    for (n, a), (_, b) in zip(_flat(jax.tree.map(np.asarray, jstate.nu)),
                              _flat(nu)):
        np.testing.assert_allclose(np.float32(b), np.float32(a), err_msg=n,
                                   **tol)


def test_warmup_cosine_schedule_matches_jax():
    js = JO.warmup_cosine_schedule(3e-4, 5, 40)
    ps = PO.warmup_cosine_schedule(3e-4, 5, 40)
    got = [ps(c) for c in range(45)]
    ref = [float(js(jnp.asarray(c))) for c in range(45)]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)   # f32 cos
    assert got[:5] == pytest.approx([3e-4 * (c + 1) / 5 for c in range(5)])


def test_sgd_update_with_momentum():
    p = {"w": torch.ones(3)}
    st = PO.sgd_init(p, momentum=0.9)
    for _ in range(2):
        p, st = PO.sgd_update({"w": torch.full((3,), 2.0)}, st, p, lr=0.1,
                              momentum=0.9)
    # buf 2 then 3.8: w = 1 - 0.2 - 0.38
    torch.testing.assert_close(p["w"], torch.full((3,), 0.42))


def test_data_pipeline_is_bitwise_jax():
    a = PD.synthetic_token_stream(5000, 777, seed=3)
    assert (a == JD.synthetic_token_stream(5000, 777, seed=3)).all()
    pi, pl = PD.make_packed_dataset(31, 777, num_tokens=5000, seed=3,
                                    source="synthetic")
    ji, jl = JD.make_packed_dataset(31, 777, num_tokens=5000, seed=3,
                                    source="synthetic", engine="numpy")
    assert (pi == ji).all() and (pl == jl).all() and pi.dtype == ji.dtype
    pb = list(PD.packed_batches(pi, pl, 4))
    jb = list(JD.packed_batches(ji, jl, 4))
    assert len(pb) == len(jb) == len(pi) // 4
    for (a, b), (c, d) in zip(pb, jb):
        assert (a == c).all() and (b == d).all()


# ---- the train step and the flagship --------------------------------------------

@pytest.mark.parametrize("precision,accum", [("bf16", 1), ("fp8_pallas", 1),
                                             ("bf16", 2)])
def test_three_fsdp_steps_match_jax_one_device_mesh(precision, accum):
    jcfg, pcfg = _tiny(precision, 96)
    jp = JT.init_params(jax.random.PRNGKey(2), jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    shards = JF.shard_params_fsdp(jp, mesh)
    sched = JO.warmup_cosine_schedule(1e-3, 2, 3)
    jstep = JF.make_fsdp_train_step(shards, jcfg, mesh, lr=1e-3,
                                    lr_schedule=sched, donate=False,
                                    accum_steps=accum)
    jopt = JF.init_fsdp_opt_state(shards)
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), pcfg)
    popt = PF.init_fsdp_opt_state(pp)
    pstep = PF.make_fsdp_train_step(pp, pcfg, lr=1e-3,
                                    lr_schedule=PO.warmup_cosine_schedule(
                                        1e-3, 2, 3), accum_steps=accum)
    for i in range(3):
        ids, labels = _tiny_batch(seed=10 + i)
        shards, jopt, jl = jstep(shards, jopt,
                                 (jnp.asarray(ids), jnp.asarray(labels)))
        pp, popt, pl = pstep(pp, popt, (torch.from_numpy(ids),
                                        torch.from_numpy(labels)))
        np.testing.assert_allclose(pl.item(), float(jl), rtol=2e-4)
    assert popt.count == int(jopt.count) == 3
    jflat = dict(_flat(jax.tree.map(np.asarray, shards)))
    for name, v in _flat(pp):
        if precision == "bf16":
            np.testing.assert_allclose(v.numpy(), jflat[name], err_msg=name,
                                       rtol=0, atol=1e-4)
        else:   # flipped fp8 roundings flip a few Adam steps: L2 instead
            err = np.linalg.norm(v.numpy() - jflat[name])
            assert err <= FP8_PARAM_L2 * np.linalg.norm(jflat[name]), name


def test_run_leg_raises_without_a_card_and_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        flagship.run_leg("tiny", "bf16", 16, 2, 3, 1, 1e-2)
    out = flagship.run_leg("tiny", "bf16", 16, 2, 3, 1, 1e-2, device="cpu")
    for key in ("losses", "lrs", "tokens_per_second", "loss_first",
                "loss_max_first20", "loss_final_mean20"):
        assert key in out
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["lrs"][0] == pytest.approx(1e-2)


def test_new_modules_import_without_jax():
    code = r"""
import sys
sys.modules["jax"] = None
import distributed_training_sandbox_tpu_torch.train.flagship
import distributed_training_sandbox_tpu_torch.parallel.fsdp
import distributed_training_sandbox_tpu_torch.ops.flash_attention
import distributed_training_sandbox_tpu_torch.ops.quant
import distributed_training_sandbox_tpu_torch.data.packing
import distributed_training_sandbox_tpu_torch.utils.flops
import distributed_training_sandbox_tpu_torch.utils.mesh
import distributed_training_sandbox_tpu_torch.ops.collectives
import distributed_training_sandbox_tpu_torch.train.train_fsdp
import chip_smoke, chip_gate_mutation
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m.startswith("distributed_training_sandbox_tpu.")
       or m == "distributed_training_sandbox_tpu"]
assert not [m for m in bad if sys.modules[m] is not None], bad
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
