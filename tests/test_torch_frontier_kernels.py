"""The serving frontier's new kernel shapes and paths on the card: K3 at
the speculative verify's (B, k+1) block, K4's ``mma.sync`` design at
the verify's M = B · (k+1) rows, and the engine with the prefix cache
and speculation going through K1, K3 (and K2, K4 on int8) with exact
launch counts and no plain call.

Imports torch, numpy and the port only — no JAX — so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_frontier_kernels.py

The ``gpu_port`` tests skip where no card is present; the others check,
on the CPU, that the same calls take the plain versions.  Tolerances
are the kernel modules' own (``flash_prefill.TOLERANCE``; K4 bit for
bit).
"""

import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.models.generate import (
    quantize_decode_params)
from distributed_training_sandbox_tpu_torch.ops import flash_prefill as FP
from distributed_training_sandbox_tpu_torch.ops import paged_attention as PA
from distributed_training_sandbox_tpu_torch.ops import quant as Q
from distributed_training_sandbox_tpu_torch.serving import engine as E
torch.set_num_threads(1)  # the suite's workers share the cores


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _verify_case(seed, B, k, nkv, rep, hd, page, P, dtype, device):
    """A verify block: S = k + 1 rows at apos = lengths + i, each slot's
    pages drawn from a shuffled pool, null-page padding after them."""
    rng = np.random.default_rng(seed)
    S, n_pages = k + 1, B * P + 1
    lengths = rng.integers(0, P * page - S, size=B)
    apos = lengths[:, None] + np.arange(S)[None, :]
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((B, P), np.int32)
    used = 0
    for b in range(B):
        n = int(apos[b, -1]) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
    f = lambda *s: t(rng.standard_normal(s).astype(np.float32), dtype)
    return (f(B, S, nkv, rep, hd), f(n_pages, page, nkv, hd),
            f(n_pages, page, nkv, hd), t(pages, torch.int32),
            t(apos, torch.int32))


@pytest.mark.gpu_port
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_k3_at_the_verify_block(cuda, dtype, k, rep):
    args = _verify_case(k * 10 + rep, 8, k, 4, rep, 128, 16, 24, dtype,
                        cuda)
    got = FP.paged_flash_prefill(*args)
    again = FP.paged_flash_prefill(*args)
    torch.cuda.synchronize()
    ref = FP.paged_flash_prefill_plain(*args)
    atol, rtol = FP.TOLERANCE[dtype]
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)


@pytest.mark.gpu_port
@pytest.mark.parametrize("M", [17, 24, 32, 40])
@pytest.mark.parametrize("KN", [(2048, 2048), (2048, 512), (2048, 11008),
                                (11008, 2048), (2048, 4096)])
def test_k4_mma_at_the_verify_rows(cuda, M, KN):
    K, N = KN
    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    xq, xs = Q.quantize_int8(torch.randn((M, K), generator=g, device="cuda"))
    wq = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                       dtype=torch.int8)
    ws = torch.rand((1, N), generator=g, device="cuda") * 1e-3
    assert Q.k4_design(M, N, K, False) == "mma"
    got = Q.int8_matmul_kernel(xq, xs, wq, ws)
    ref = Q.int8_matmul(xq, xs, wq, ws, torch.bfloat16)
    assert torch.equal(got, ref)


def _tiny(dtype):
    import dataclasses
    cfg = dataclasses.replace(T.TINY_LM, dtype=dtype)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for leaf in [params["embed"], params["final_norm"],
                 *params["layers"].values()]:
        leaf.mul_(3.0)
    return cfg, params


def _frontier_serve(cfg, params, device, **kw):
    rng = np.random.default_rng(1)
    head = rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(
        1, cfg.vocab_size, size=int(rng.integers(4, 20))).astype(np.int32)])
        for _ in range(5)]
    eng = E.ServingEngine(params, cfg, max_batch=4, page_size=8,
                          max_seq_len=64, prefill_chunk=16, sync_every=4,
                          prefix_cache=True, spec_k=3, draft_layers=2,
                          paged_kernel=True, device=device, **kw)
    for c in (PA.COUNTS, PA.Q8_COUNTS, FP.COUNTS, Q.INT8_COUNTS):
        c.reset()
    reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    eng.run()
    return eng, reqs


def _expected_counts(eng, cfg, int8_pool):
    L, Ld = cfg.num_hidden_layers, eng.draft_cfg.num_hidden_layers
    st = eng.stats
    if int8_pool:
        return {"k2": st["draft_steps"] * Ld, "k1": 0, "k3": 0}
    return {"k1": st["draft_steps"] * Ld, "k2": 0,
            "k3": st["prefill_chunks"] * (L + Ld) + st["decode_steps"] * L}


@pytest.mark.gpu_port
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_frontier_goes_through_k1_and_k3(cuda, dtype):
    cfg, params = _tiny(dtype)
    eng, reqs = _frontier_serve(cfg, params, cuda, flash_prefill=True)
    want = _expected_counts(eng, cfg, False)
    assert (PA.COUNTS.launches, PA.COUNTS.plain_calls) == (want["k1"], 0)
    assert (FP.COUNTS.launches, FP.COUNTS.plain_calls) == (want["k3"], 0)
    assert eng.prefix_cache.hit_pages > 0
    assert all(len(r.tokens) == 10 for r in reqs)


@pytest.mark.gpu_port
def test_engine_int8_frontier_goes_through_k2_and_k4(cuda):
    cfg, params = _tiny(torch.bfloat16)
    q8 = quantize_decode_params(params, cfg)
    eng, reqs = _frontier_serve(cfg, q8, cuda, kv_quant=True)
    want = _expected_counts(eng, cfg, True)
    assert (PA.Q8_COUNTS.launches, PA.Q8_COUNTS.plain_calls) == (
        want["k2"], 0)
    assert Q.INT8_COUNTS.launches > 0 and Q.INT8_COUNTS.plain_calls == 0
    assert PA.COUNTS.launches == FP.COUNTS.launches == 0
    assert all(len(r.tokens) == 10 for r in reqs)


@pytest.mark.parametrize("int8_pool", [False, True], ids=["float", "int8"])
def test_engine_frontier_takes_the_plain_versions_on_the_cpu(int8_pool):
    """The same engine on the CPU: every attention the card would send
    to a kernel is a counted plain call, in the same numbers."""
    cfg, params = _tiny(torch.float32)
    kw = dict(kv_quant=True) if int8_pool else dict(flash_prefill=True)
    if int8_pool:
        params = quantize_decode_params(params, cfg)
    eng, reqs = _frontier_serve(cfg, params, "cpu", **kw)
    want = _expected_counts(eng, cfg, int8_pool)
    assert (PA.COUNTS.launches, PA.COUNTS.plain_calls) == (0, want["k1"])
    assert (PA.Q8_COUNTS.launches, PA.Q8_COUNTS.plain_calls) == (
        0, want["k2"])
    assert (FP.COUNTS.launches, FP.COUNTS.plain_calls) == (0, want["k3"])
    assert eng.prefix_cache.hit_pages > 0
    assert all(len(r.tokens) == 10 for r in reqs)


def test_k3_on_a_cpu_verify_block_is_the_plain_version():
    args = _verify_case(0, 3, 3, 2, 4, 16, 8, 6, torch.float32, "cpu")
    FP.COUNTS.reset()
    got = FP.paged_flash_prefill(*args)
    assert (FP.COUNTS.launches, FP.COUNTS.plain_calls) == (0, 1)
    assert torch.equal(got, FP.paged_flash_prefill_plain(*args))
