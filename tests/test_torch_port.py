"""The PyTorch port against the JAX reference, on the CPU.

Same inputs, made from a seed with numpy (or by the reference's own
``init_params``), go through the JAX function and its counterpart in the
port; they cross between frameworks as numpy arrays.  Model config:
``TINY_LM`` in f32 with the reference's weights scaled ×3 (raw init
settles on a constant greedy token, which would hide drift).

Tolerances: module values at ``rtol = atol = 1e-5`` — XLA and torch
reduce in different orders, so f32 results agree to a few ulps, not
bit for bit.  Tokens must be equal exactly.  The reference's Pallas
kernels are never called here: the port's kernels are held against the
reference's plain gather-then-einsum path, which those kernels are
defined to equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.models.generate import (
    generate as jax_generate)
from distributed_training_sandbox_tpu.serving import accounting as JA
from distributed_training_sandbox_tpu.serving import engine as JE
from distributed_training_sandbox_tpu.serving import scheduler as JS
from distributed_training_sandbox_tpu.serving.kv_pool import (
    PageAllocator as JPageAllocator)
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.models.generate import (
    generate as port_generate)
from distributed_training_sandbox_tpu_torch.ops import (
    flash_prefill as PFP, paged_attention as PPA, paged_attention_decode,
    paged_flash_prefill)
from distributed_training_sandbox_tpu_torch.runtime import StepPump
from distributed_training_sandbox_tpu_torch.serving import accounting as PA
from distributed_training_sandbox_tpu_torch.serving import engine as PE
from distributed_training_sandbox_tpu_torch.serving import scheduler as PS
from distributed_training_sandbox_tpu_torch.serving.kv_pool import (
    PageAllocator as PPageAllocator)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_params(cfg=JT.TINY_LM, seed=0, scale=3.0):
    params = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(lambda x: (x * scale).astype(x.dtype), params)


@pytest.fixture(scope="module")
def weights():
    """(jax params, port params) holding the same values."""
    jp = _jax_params()
    pp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), PT.TINY_LM)
    return jp, pp


def _prompts(n, seed=7, lo=3, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, PT.TINY_LM.vocab_size,
                         size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


# ---- (a) bridge -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_leaf_for_leaf(dtype):
    import dataclasses
    jcfg = dataclasses.replace(JT.TINY_LM, dtype=jnp.dtype(dtype))
    pcfg = dataclasses.replace(PT.TINY_LM, dtype=getattr(torch, dtype))
    tree = jax.tree.map(np.asarray, _jax_params(jcfg))
    port = bridge.params_from_jax(tree, pcfg)
    assert port["layers"]["wq"].shape == (4, 64, 64)
    assert port["layers"]["wq"].dtype == pcfg.dtype
    back = bridge.params_to_numpy(port)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert (a.view(np.uint8) == b.view(np.uint8)).all(), path


def test_port_init_params_has_the_reference_tree():
    jtree = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                  JT.TINY_LM))
    port = PT.init_params(PT.TINY_LM, torch.Generator().manual_seed(0),
                          "cpu")
    js = {jax.tree_util.keystr(p): tuple(x.shape)
          for p, x in jax.tree_util.tree_leaves_with_path(jtree)}
    ps = {jax.tree_util.keystr(p): tuple(x.shape)
          for p, x in jax.tree_util.tree_leaves_with_path(
              bridge.params_to_numpy(port))}
    assert js == ps
    w = port["layers"]["wq"]
    assert float(w.abs().max()) <= 0.04 and 0.015 < float(w.std()) < 0.02


# ---- (b) building blocks --------------------------------------------------

def _rms(rng, weights):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = np.asarray(weights[0]["layers"]["ln1"][0]) * 1.3
    ref = JT.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = PT.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    return ref, got


def _rope(rng, weights):
    pos = rng.integers(0, 2048, size=(3, 4)).astype(np.int32)
    x = rng.standard_normal((3, 4, 2, 16)).astype(np.float32)
    jc, js = JE._ragged_rope_tables(jnp.asarray(pos), 16, 10_000.0)
    ref = JE._apply_rope_ragged(jnp.asarray(x), jc, js)
    pc, ps = PE._ragged_rope_tables(torch.from_numpy(pos), 16, 10_000.0)
    got = PE._apply_rope_ragged(torch.from_numpy(x), pc, ps)
    return ref, got


def _mlp(rng, weights):
    jp, pp = weights
    r = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jl = jax.tree.map(lambda p: p[1], jp["layers"])
    ref, _ = JT._mlp_block(jnp.asarray(r), jl, cfg=JT.TINY_LM)
    got = PT._mlp_block(torch.from_numpy(r), PT.layer_params(pp, 1),
                        cfg=PT.TINY_LM)
    return ref, got


@pytest.mark.parametrize("case", [_rms, _rope, _mlp],
                         ids=["rms_norm", "ragged_rope", "swiglu_mlp"])
def test_building_blocks_match_jax(case, weights):
    ref, got = case(np.random.default_rng(0), weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# ---- (c) attention: plain versions against the reference's gather path ----

@jax.jit
def _jax_gather_attention(qg, pk, pv, pages, apos):
    """The reference engine's gather+einsum attention (float pool) with
    f32 probabilities, as ``tests/test_decode_frontier._flash_reference``."""
    B, S = qg.shape[:2]
    V = pages.shape[1] * pk.shape[1]
    gk = pk[pages].reshape(B, V, *pk.shape[2:])
    gv = pv[pages].reshape(B, V, *pv.shape[2:])
    scores = jnp.einsum("bsgrh,bkgh->bgrsk", qg, gk,
                        preferred_element_type=jnp.float32) \
        / np.sqrt(qg.shape[-1])
    vis = jnp.arange(V)[None, None, :] <= apos[:, :, None]
    scores = jnp.where(vis[:, None, None], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bgrsk,bkgh->bsgrh", probs, gv,
                      preferred_element_type=jnp.float32)


def _attention_case(seed, S):
    """Seeded pool; slot b owns its first ceil((last+1)/page) table
    entries, the rest pad with the null page 0; ragged apos."""
    rng = np.random.default_rng(seed)
    B, nkv, rep, hd, page, P, n_pages = 3, 2, 2, 16, 8, 6, 19
    pk = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    qg = rng.standard_normal((B, S, nkv, rep, hd)).astype(np.float32)
    last = rng.integers(S - 1, P * page, size=B)
    apos = (last[:, None] - (S - 1) + np.arange(S)).astype(np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((B, P), np.int32)
    used = 0
    for b in range(B):
        n = int(last[b]) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    return qg, pk, pv, pages, apos


@pytest.mark.parametrize("kernel,S", [(paged_attention_decode, 1),
                                      (paged_flash_prefill, 5)],
                         ids=["decode", "prefill"])
def test_plain_paged_attention_matches_jax_gather_path(kernel, S):
    args = _attention_case(S, S)
    ref = np.asarray(_jax_gather_attention(*map(jnp.asarray, args)))
    got = kernel(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---- (d) one-shot generate ------------------------------------------------

@pytest.mark.parametrize("capacity", [None, 64])
def test_generate_tokens_equal_jax(weights, capacity):
    jp, pp = weights
    for prompt in _prompts(3, seed=11):
        ref = np.asarray(jax_generate(jp, jnp.asarray(prompt[None]),
                                      JT.TINY_LM, max_new_tokens=12,
                                      cache_capacity=capacity))[0]
        got = port_generate(pp, prompt[None], PT.TINY_LM, max_new_tokens=12,
                            cache_capacity=capacity, device="cpu")[0]
        assert (got.numpy() == ref).all(), (got.tolist(), ref.tolist())


def test_generate_samples_with_an_explicit_generator(weights):
    _, pp = weights
    prompt = _prompts(1)[0][None]
    with pytest.raises(ValueError, match="generator"):
        port_generate(pp, prompt, PT.TINY_LM, temperature=1.0, device="cpu")
    runs = [port_generate(pp, prompt, PT.TINY_LM, max_new_tokens=8,
                          temperature=1.0, device="cpu",
                          generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert (runs[0] == runs[1]).all()


# ---- (e) + (f) the serving engine -----------------------------------------

ENGINE = dict(max_batch=3, page_size=8, max_seq_len=48, prefill_chunk=8,
              sync_every=4)


def _serve_port(pp, prompts, **flags):
    eng = PE.ServingEngine(pp, PT.TINY_LM, device="cpu", **ENGINE, **flags)
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.run()
    return eng, reqs


def test_port_engine_with_kernels_equals_jax_gather_engine(weights):
    jp, pp = weights
    prompts = _prompts(7, seed=5)
    jeng = JE.ServingEngine(jp, JT.TINY_LM, **ENGINE)
    jreqs = [jeng.submit(p, max_new_tokens=10) for p in prompts]
    jeng.run()
    eng, reqs = _serve_port(pp, prompts, paged_kernel=True,
                            flash_prefill=True)
    assert eng.slo_report()["completed"] == len(prompts)
    for j, p in zip(jreqs, reqs):
        assert p.tokens == j.tokens, (p.rid, p.tokens, j.tokens)


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_port_engine_equals_port_generate(weights, kernels):
    _, pp = weights
    prompts = _prompts(6, seed=9)
    PPA.COUNTS.reset()
    PFP.COUNTS.reset()
    eng, reqs = _serve_port(pp, prompts, paged_kernel=kernels,
                            flash_prefill=kernels)
    # with or without the kernel flags, CPU tensors take the plain
    # versions, and every such attention is counted as a plain call
    L = PT.TINY_LM.num_hidden_layers
    assert (PPA.COUNTS.launches, PPA.COUNTS.plain_calls) == (
        0, eng.stats["decode_steps"] * L)
    assert (PFP.COUNTS.launches, PFP.COUNTS.plain_calls) == (
        0, eng.stats["prefill_chunks"] * L)
    for r in reqs:
        ref = port_generate(pp, r.prompt[None], PT.TINY_LM,
                            max_new_tokens=10,
                            cache_capacity=eng.view_capacity,
                            device="cpu")[0]
        assert r.tokens == ref.tolist(), (r.rid, r.tokens, ref.tolist())
    rep = eng.slo_report()
    assert rep["completed"] == 6 and rep["tokens_total"] == 60
    assert "recompiles_after_warmup" not in rep


def test_engine_serves_staggered_arrivals_and_one_token_requests(weights):
    """Requests that arrive later, and ones that finish at prefill
    (max_new_tokens == 1), through the per-request prefill path."""
    _, pp = weights
    prompts = _prompts(4, seed=13)
    eng = PE.ServingEngine(pp, PT.TINY_LM, device="cpu", **ENGINE)
    news = [1, 5, 1, 7]
    reqs = [eng.submit(p, max_new_tokens=n, arrival_s=0.01 * i)
            for i, (p, n) in enumerate(zip(prompts, news))]
    done = eng.run()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    for r, n in zip(reqs, news):
        ref = port_generate(pp, r.prompt[None], PT.TINY_LM,
                            max_new_tokens=n,
                            cache_capacity=eng.view_capacity,
                            device="cpu")[0]
        assert r.tokens == ref.tolist()
        assert r.t_submit == pytest.approx(0.01 * r.rid)
        assert r.ttft_s >= 0 and r.t_done >= r.t_first
    assert eng.pool.allocator.pages_in_use == 0
    with pytest.raises(ValueError, match="view capacity"):
        eng.submit(np.ones(40, np.int32), max_new_tokens=9)


# ---- (g) the scheduler ------------------------------------------------------

def _batcher_trace(S, alloc_cls, seed=4):
    """Drive a batcher through a seeded arrival/retire stream and log
    every admission as (round, rid, slot, pages)."""
    rng = np.random.default_rng(seed)
    cb = S.ContinuousBatcher(max_batch=3, allocator=alloc_cls(20),
                             page_size=4)
    log, rid = [], 0
    for rnd in range(40):
        for _ in range(int(rng.poisson(0.8))):
            prompt = np.arange(int(rng.integers(1, 20)), dtype=np.int32)
            cb.submit(S.Request(rid=rid, prompt=prompt,
                                max_new_tokens=int(rng.integers(1, 12))),
                      now=float(rnd))
            rid += 1
        for r in cb.admit(now=float(rnd)):
            log.append((rnd, r.rid, r.slot, list(r.pages)))
        for r in [r for r in cb.slots if r is not None]:
            if rng.random() < 0.3:
                cb.retire(r, now=float(rnd))
    return log, cb.admitted_total, cb.completed_total


def test_batcher_admission_and_page_grants_equal_jax():
    ref = _batcher_trace(JS, JPageAllocator)
    got = _batcher_trace(PS, PPageAllocator)
    assert len(ref[0]) > 20
    assert got == ref


def test_batcher_release_all_resets_for_replay():
    cb = PS.ContinuousBatcher(2, PPageAllocator(9), page_size=4)
    reqs = [PS.Request(rid=i, prompt=np.arange(6, dtype=np.int32),
                       max_new_tokens=4, arrival_s=0.0) for i in range(3)]
    for r in reqs:
        cb.submit(r, now=1.0)
    cb.admit(now=1.0)
    reqs[0].tokens.append(5)
    orphans = cb.release_all()
    assert [r.rid for r in orphans] == [0, 1, 2]
    assert cb.allocator.free_pages == 8 and not cb.has_work()
    assert all(r.state == PS.WAITING and r.tokens == [] and r.pages is None
               for r in orphans)
    assert reqs[0].t_submit == 0.0
    with pytest.raises(ValueError, match="not resident"):
        cb.retire(reqs[0], now=2.0)


# ---- accounting and the pump ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accounting_matches_jax(dtype):
    import dataclasses
    jcfg = dataclasses.replace(JT.SMOLLM3_3B, dtype=jnp.dtype(dtype))
    pcfg = dataclasses.replace(PT.SMOLLM3_3B, dtype=getattr(torch, dtype))
    assert PA.page_bytes(pcfg, 16) == JA.page_bytes(jcfg, 16)
    assert PA.serve_waterline_gb(pcfg, 1025, 16, weight_bytes=123) \
        == JA.serve_waterline_gb(jcfg, 1025, 16, weight_bytes=123)
    if dtype == "bfloat16":
        assert PA.kv_bytes_per_step(pcfg, 8, 2048) \
            == JA.kv_bytes_per_step(jcfg, 8, 2048, kv_quant=False)
        for params in ({}, {"lm_head": None}):
            assert PA.weight_read_bytes(pcfg, params, 10 ** 10) \
                == JA.weight_read_bytes(jcfg, params, 10 ** 10)


def test_pump_syncs_on_policy():
    pump = StepPump(sync_every=4, max_in_flight=3)
    flags = [pump.emit(torch.tensor(i)) for i in range(10)]
    assert flags == [False, False, False, True] * 2 + [False, False]
    pump.close()
    assert pump.resolved == [(i, float(i)) for i in range(10)]
    assert pump.sync_breakdown == {"sync_every": 2, "exit": 1}
    tight = StepPump(sync_every=0, max_in_flight=1)
    for i in range(3):
        tight.emit(torch.tensor(i))
    assert tight.sync_breakdown == {"throttle": 2}


# ---- (h) + (i) isolation and device choice --------------------------------

def test_port_and_chip_smoke_import_without_jax():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import distributed_training_sandbox_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_gate_mutation
import chip_smoke
bad = [m for m, mod in sys.modules.items() if mod is not None and (
       m == "distributed_training_sandbox_tpu"
       or m.startswith("distributed_training_sandbox_tpu.")
       or m == "jax" or m.startswith("jax."))]
assert not bad, bad
print(len(names))
"""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_entry_points_raise_without_a_card(weights, monkeypatch):
    _, pp = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prompt = _prompts(1)[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.ServingEngine(pp, PT.TINY_LM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.serve(pp, PT.TINY_LM, [prompt])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_generate(pp, prompt[None], PT.TINY_LM)
    out = PE.serve(pp, PT.TINY_LM, [prompt], max_new_tokens=3, device="cpu")
    assert out[0].shape == (3,)


def test_unported_configurations_raise():
    import dataclasses
    for cfg in (dataclasses.replace(PT.TINY_LM, n_experts=4),
                dataclasses.replace(PT.TINY_LM, attention_impl="ring")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PT.init_params(cfg, torch.Generator(), "cpu")
