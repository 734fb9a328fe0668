"""CPU checks of what surrounds the Hopper redesigns of K6 and the flash
attention backward, and of K3's accuracy gates: the f64 oracle of K3's
reference arithmetic against numpy, the multi-draw count, K6's K-major
weight codes against ``quantize_fp8`` transposed, and the K6 wrapper's
validation, which runs before the wrapper dispatches on the device.

Imports torch, numpy and the port only (no JAX).
"""

import math

import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu_torch.ops import flash_prefill as FP
from distributed_training_sandbox_tpu_torch.ops import quant as Q
torch.set_num_threads(1)  # the suite's workers share the cores


def _paged_case(seed, B=2, S=5, nkv=2, rep=2, hd=16, page=4, P=5):
    """A small bf16 paged case: null page 0, each slot's pages distinct,
    its chunk of S rows ending somewhere in its view."""
    rng = np.random.default_rng(seed)
    n_pages = B * P + 1
    pk = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    qg = rng.standard_normal((B, S, nkv, rep, hd)).astype(np.float32)
    last = rng.integers(S - 1, P * page, size=B)
    apos = (last[:, None] - (S - 1) + np.arange(S)[None, :]).astype(np.int32)
    pages = np.zeros((B, P), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    used = 0
    for b in range(B):
        n = int(last[b]) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    return bf(qg), bf(pk), bf(pv), torch.as_tensor(pages), \
        torch.as_tensor(apos)


def _bf16_round(x32):
    """float32 → nearest-even bf16, kept as float32 (numpy has no bf16)."""
    u = x32.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _numpy_oracle(qg, pk, pv, pages, apos):
    q = qg.float().numpy().astype(np.float64)
    k = pk.float().numpy().astype(np.float64)
    v = pv.float().numpy().astype(np.float64)
    pages, apos = pages.numpy(), apos.numpy()
    B, S, nkv, rep, hd = q.shape
    page = k.shape[1]
    V = pages.shape[1] * page
    out = np.zeros(q.shape, np.float64)
    inv = float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    for b in range(B):
        gk = k[pages[b]].reshape(V, nkv, hd)
        gv = v[pages[b]].reshape(V, nkv, hd)
        for s in range(S):
            vis = np.arange(V) <= apos[b, s]
            for g in range(nkv):
                for r in range(rep):
                    sc = (gk[:, g] @ q[b, s, g, r]) * inv
                    sc = np.where(vis, sc, -np.inf)
                    p = np.exp(sc - sc.max())
                    p = _bf16_round((p / p.sum()).astype(np.float32))
                    out[b, s, g, r] = p.astype(np.float64) @ gv[:, g]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k3_oracle_matches_numpy_float64(seed):
    args = _paged_case(seed)
    got = FP.paged_flash_prefill_oracle(*args)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _numpy_oracle(*args),
                               rtol=1e-12, atol=1e-12)


def test_k3_oracle_is_uncounted_and_near_the_plain_path():
    args = _paged_case(3)
    FP.COUNTS.reset()
    orc = FP.paged_flash_prefill_oracle(*args)
    assert (FP.COUNTS.launches, FP.COUNTS.plain_calls) == (0, 0)
    plain = FP.paged_flash_prefill_plain(*args)
    # the plain path's f32 probabilities round to the oracle's bf16
    # values except where one sits on a rounding boundary
    assert float((plain.double() - orc).abs().max()) <= \
        FP.TOLERANCE[torch.bfloat16][0]


def test_off_count_counts_a_one_ulp_flip_and_not_an_exact_match():
    ref = torch.full((4, 8), 0.75, dtype=torch.float32)
    assert FP.off_count(ref.clone(), ref, 0.0) == 0
    got = ref.clone()
    # one bf16 ulp of a probability near 1 (2^-8) times a value of 1
    got[1, 3] += 2.0 ** -8
    atol = FP.TOLERANCE[torch.bfloat16][0]
    assert FP.off_count(got, ref, atol / 4) == 1
    assert FP.off_count(got, ref, 2.0 ** -8) == 0   # strictly greater
    got[2, 5] -= 2.0 ** -9
    assert FP.off_count(got, ref, atol / 4) == 2
    assert FP.off_count(got.double(), ref, atol / 4) == 2


@pytest.mark.parametrize("shape", [(48, 40), (176, 136), (64, 512)])
@pytest.mark.parametrize("hist", [0, 16])
def test_kmajor_fp8_codes_are_quantize_fp8_transposed(shape, hist):
    gen = torch.Generator().manual_seed(sum(shape) + hist)
    w = (torch.randn(shape, generator=gen) * 0.05).to(torch.bfloat16)
    q, s = Q.quantize_fp8(w, amax_history_len=hist)
    qt, st = Q.quantize_fp8_kmajor(w, amax_history_len=hist)
    assert qt.shape == (shape[1], shape[0]) and qt.is_contiguous()
    assert qt.dtype == Q.FP8_FWD_DTYPE
    assert torch.equal(qt.view(torch.uint8),
                       q.t().contiguous().view(torch.uint8))
    assert torch.equal(st, s)


def test_fp8_kernel_wrapper_takes_the_kmajor_weight_on_the_cpu():
    """The wrapper's CPU dispatch on the K-major codes is the plain
    product on the reference's (K, N) codes, bit for bit."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((70, 48), generator=gen).to(torch.bfloat16)
    w = (torch.randn((48, 40), generator=gen) * 0.05).to(torch.bfloat16)
    xq, xs = Q.quantize_fp8(x)
    wq, ws = Q.quantize_fp8(w)
    wt, _ = Q.quantize_fp8_kmajor(w)
    Q.COUNTS.reset()
    got = Q.fp8_matmul_kernel(xq, xs, wt, ws)
    assert (Q.COUNTS.launches, Q.COUNTS.plain_calls) == (0, 1)
    want = Q.fp8_matmul(xq, xs, wq, ws, torch.bfloat16)
    assert torch.equal(got, want) and got.shape == (70, 40)


def test_fp8_kernel_wrapper_validates_before_it_dispatches():
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((64, 40), generator=gen)
    w = torch.randn((40, 32), generator=gen) * 0.05
    xq, xs = Q.quantize_fp8(x)
    wt, ws = Q.quantize_fp8_kmajor(w)
    Q.COUNTS.reset()
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.fp8_matmul_kernel(xq, xs, wt, ws)
    xq, xs = Q.quantize_fp8(torch.randn((64, 48), generator=gen))
    with pytest.raises(ValueError, match="inner dims"):
        Q.fp8_matmul_kernel(xq, xs, wt, ws)
    wt, _ = Q.quantize_fp8_kmajor(torch.randn((48, 32), generator=gen))
    # the reference's (K, N) layout is refused: B is (N, K)
    with pytest.raises(ValueError, match="inner dims"):
        Q.fp8_matmul_kernel(xq, xs, wt.t().contiguous(), ws)
    e5, s5 = Q.quantize_fp8_kmajor(torch.randn((48, 32), generator=gen),
                                   Q.FP8_BWD_DTYPE)
    with pytest.raises(ValueError, match="e4m3"):
        Q.fp8_matmul_kernel(xq, xs, e5, s5)
    assert (Q.COUNTS.launches, Q.COUNTS.plain_calls) == (0, 0)
