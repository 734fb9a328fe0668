"""The port's CUDA kernels against their plain PyTorch versions: K1
paged decode, K2 int8 paged decode, K3 flash prefill, K4 int8 GEMM, K5
fused quantise-matmul, K6 fp8 GEMM, the flash attention forward and
backward and K7 (the FSDP ring's chunk product), at tiny, ragged and
the main paths' shapes.

Imports torch, numpy and the port only — no JAX — so that it also runs
on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py

The ``gpu_port`` tests launch the kernels and skip where no card is
present; the rest check dispatch and validation on the CPU.  Tolerances
are the ones each kernel module states (``TOLERANCE``): the kernels do
the plain version's operations in another summation order, so f32 pools
agree to f32 rounding, and bf16 pools where no probability lands on the
other side of a bf16 rounding boundary; K6 to one bf16 ulp of the plain
f32 sum; the flash attention to bf16 level in O and the grads and f32
level in the logsumexp; K4 and K5 bit for bit (exact integer sums, the
same epilogue); K2 at ``TOLERANCE_Q8`` (a code of the requantised
probabilities can flip where the softmax sums in another order); K7 at
``collectives.TOLERANCE`` (one bf16 ulp where the f32 sums, taken in
another order, straddle a rounding boundary).
"""

import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu_torch.ops import (
    flash_prefill as FP, paged_attention as PA)


def _case(seed, B, S, nkv, rep, hd, page, P, n_pages, dtype, device):
    """Seeded pools and a page table with null-page padding: slot b
    holds ceil((max apos + 1) / page) distinct pages, the rest of its
    row points at page 0; apos is ragged across slots."""
    rng = np.random.default_rng(seed)
    V = P * page
    pk = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    qg = rng.standard_normal((B, S, nkv, rep, hd)).astype(np.float32)
    last = rng.integers(S - 1, V, size=B)
    apos = last[:, None] - (S - 1) + np.arange(S)[None, :]
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((B, P), np.int32)
    used = 0
    for b in range(B):
        n = int(last[b]) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    assert used < n_pages
    t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
    return (t(qg, dtype), t(pk, dtype), t(pv, dtype),
            t(pages, torch.int32), t(apos, torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


SHAPES = {
    # name: (B, nkv, rep, hd, page, P); S chosen per kernel
    "tiny": (3, 2, 2, 16, 8, 6),
    "smollm3": (8, 4, 4, 128, 16, 128),
}


@pytest.mark.gpu_port
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_decode_kernel_matches_plain(cuda, shape, dtype):
    B, nkv, rep, hd, page, P = SHAPES[shape]
    args = _case(0, B, 1, nkv, rep, hd, page, P, B * P + 1, dtype, cuda)
    PA.COUNTS.reset()
    got = PA.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert (PA.COUNTS.launches, PA.COUNTS.plain_calls) == (1, 0)
    ref = PA.paged_attention_plain(*args)
    atol, rtol = PA.TOLERANCE[dtype]
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)


def _decode_case(seed, last, nkv, rep, hd, page, P, dtype, device):
    """One slot per entry of ``last`` (its query's absolute position) over
    a view of P pages, each slot's table row padded with the null page
    0; every pool page (the null page too) holds random rows."""
    rng = np.random.default_rng(seed)
    B = len(last)
    n_pages = sum(a // page + 1 for a in last) + 1
    pk = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    qg = rng.standard_normal((B, 1, nkv, rep, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((B, P), np.int32)
    used = 0
    for b, a in enumerate(last):
        n = a // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
    return (t(qg, dtype), t(pk, dtype), t(pv, dtype),
            t(pages, torch.int32),
            t(np.array(last)[:, None], torch.int32))


@pytest.mark.gpu_port
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_decode_kernel_boundaries_match_plain_and_repeat(cuda, rep, hd, page,
                                                         dtype):
    """K1 over a 2048-position view, its cluster of 8 blocks splitting
    each slot's visible positions: apos 0 (one key, seven blocks with
    none), 5, the last row of the first page and the first of the next,
    the edge where a block's range becomes two sub-ranges (8 · H - 1,
    8 · H and 8 · H + 1 visible positions, H the rows a block holds:
    ``PA.rows_held``) and the view's last two positions; bit-equal on a
    second launch."""
    V = 2048
    held = PA.rows_held(V, hd, torch.tensor([], dtype=dtype).element_size())
    assert 8 * held + 1 < V - 1
    last = sorted({0, 5, page - 1, page, 8 * held - 2, 8 * held - 1,
                   8 * held, V - 2, V - 1})
    args = _decode_case(20 + rep, last, 2, rep, hd, page, V // page, dtype,
                        cuda)
    PA.COUNTS.reset()
    got = PA.paged_attention_decode(*args)
    again = PA.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert (PA.COUNTS.launches, PA.COUNTS.plain_calls) == (2, 0)
    ref = PA.paged_attention_plain(*args)
    atol, rtol = PA.TOLERANCE[dtype]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    assert torch.equal(got, again)


@pytest.mark.gpu_port
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_decode_kernel_long_view_matches_plain_and_repeat(cuda, rep, dtype):
    """K1 over a view longer than its blocks keep scores for in shared
    memory (8 · 2048 positions), where they keep them in the wrapper's
    scratch: slots at apos 0, at the shared-memory edge ± 1 and at the
    view's end; bit-equal on a second launch."""
    page, V = 16, 8 * 2048 + 8 * 16
    last = [0, 8 * 2048 - 1, 8 * 2048, V - 1]
    args = _decode_case(40 + rep, last, 2, rep, 128, page, V // page, dtype,
                        cuda)
    PA.COUNTS.reset()
    got = PA.paged_attention_decode(*args)
    again = PA.paged_attention_decode(*args)
    torch.cuda.synchronize()
    assert (PA.COUNTS.launches, PA.COUNTS.plain_calls) == (2, 0)
    ref = PA.paged_attention_plain(*args)
    atol, rtol = PA.TOLERANCE[dtype]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("source, name, value", [
    pytest.param("paged_decode.cu", "kCluster", PA.CLUSTER,
                 id=f"kCluster-{PA.CLUSTER}"),
    pytest.param("paged_decode.cu", "kRowBytes", PA.ROW_BYTES,
                 id=f"kRowBytes-{PA.ROW_BYTES}"),
    pytest.param("paged_decode_q8.cu", "kCluster", PA.Q8_CLUSTER,
                 id=f"q8-kCluster-{PA.Q8_CLUSTER}"),
    pytest.param("paged_decode_q8.cu", "kRowBytes", PA.Q8_ROW_BYTES,
                 id=f"q8-kRowBytes-{PA.Q8_ROW_BYTES}")])
def test_decode_constants_match_the_kernel_source(source, name, value):
    """``PA.rows_held`` and ``PA.rows_held_q8`` read K1's and K2's block
    count and row budget from the module's constants; they must be the
    kernels'."""
    from pathlib import Path
    src = (Path(PA.__file__).parents[1] / "csrc" / source).read_text()
    assert f"constexpr int {name} = {value};" in src


@pytest.mark.gpu_port
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prefill_kernel_matches_plain(cuda, shape, dtype):
    B, nkv, rep, hd, page, P = SHAPES[shape]
    S = 5 if shape == "tiny" else 256
    args = _case(1, B, S, nkv, rep, hd, page, P, B * P + 1, dtype, cuda)
    FP.COUNTS.reset()
    got = FP.paged_flash_prefill(*args)
    torch.cuda.synchronize()
    assert (FP.COUNTS.launches, FP.COUNTS.plain_calls) == (1, 0)
    ref = FP.paged_flash_prefill_plain(*args)
    atol, rtol = FP.TOLERANCE[dtype]
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)


def _ragged_case(seed, S, nkv, rep, hd, page, dtype, device):
    """Three slots over a view V a little past S: slot 0's chunk starts
    at position 0, slot 1's ends at V - 1, slot 2's lies in between;
    each slot's row of the page table is padded with the null page 0,
    and every pool page (the null page too) holds random rows."""
    rng = np.random.default_rng(seed)
    P = -(-(S + 70) // page)
    V, B = P * page, 3
    n_pages = B * P + 1
    pk = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    pv = rng.standard_normal((n_pages, page, nkv, hd)).astype(np.float32)
    qg = rng.standard_normal((B, S, nkv, rep, hd)).astype(np.float32)
    last = np.array([S - 1, V - 1, int(rng.integers(S, V - 1))])
    apos = last[:, None] - (S - 1) + np.arange(S)[None, :]
    perm = rng.permutation(np.arange(1, n_pages))
    pages = np.zeros((B, P), np.int32)
    used = 0
    for b in range(B):
        n = int(last[b]) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    t = lambda a, dt: torch.as_tensor(a).to(device=device, dtype=dt)
    return (t(qg, dtype), t(pk, dtype), t(pv, dtype),
            t(pages, torch.int32), t(apos, torch.int32))


@pytest.mark.gpu_port
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_prefill_kernel_ragged_shapes_match_plain(cuda, rep, hd, page,
                                                  dtype):
    """S = 2·(64 / rep) + 3 chunk rows: the last block of vectors is
    partly past S, and the key tiles of 64 span pages of 8 or 16."""
    S = 2 * (64 // rep) + 3
    args = _ragged_case(10 + rep, S, 2, rep, hd, page, dtype, cuda)
    FP.COUNTS.reset()
    got = FP.paged_flash_prefill(*args)
    torch.cuda.synchronize()
    assert (FP.COUNTS.launches, FP.COUNTS.plain_calls) == (1, 0)
    ref = FP.paged_flash_prefill_plain(*args)
    atol, rtol = FP.TOLERANCE[dtype]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    assert torch.equal(got, FP.paged_flash_prefill(*args))


@pytest.mark.gpu_port
def test_kernels_reject_what_they_do_not_take(cuda):
    qg, pk, pv, pages, apos = _case(2, 2, 1, 2, 2, 16, 8, 4, 9,
                                    torch.float32, cuda)
    with pytest.raises(ValueError, match="int32"):
        PA.paged_attention_decode(qg, pk, pv, pages.long(), apos)
    with pytest.raises(ValueError, match="dtype"):
        PA.paged_attention_decode(qg, pk.half(), pv.half(), pages, apos)
    with pytest.raises(ValueError, match="CUDA"):
        FP.paged_flash_prefill(qg, pk, pv, pages.cpu(), apos)
    with pytest.raises(ValueError, match="contiguous"):
        FP.paged_flash_prefill(qg, pk.transpose(0, 1), pv, pages, apos)


def test_cpu_tensors_take_the_plain_version_and_count_it():
    args = _case(3, 2, 1, 2, 2, 16, 8, 4, 9, torch.float32, "cpu")
    PA.COUNTS.reset()
    FP.COUNTS.reset()
    dec = PA.paged_attention_decode(*args)
    pre = FP.paged_flash_prefill(*args)
    assert (PA.COUNTS.launches, PA.COUNTS.plain_calls) == (0, 1)
    assert (FP.COUNTS.launches, FP.COUNTS.plain_calls) == (0, 1)
    torch.testing.assert_close(dec, pre, atol=0, rtol=0)
    assert dec.dtype == torch.float32 and dec.shape == (2, 1, 2, 2, 16)
    # each plain version counts in its own kernel's counter, whoever calls it
    PA.paged_attention_plain(*args)
    FP.paged_flash_prefill_plain(*args)
    assert (PA.COUNTS.launches, PA.COUNTS.plain_calls) == (0, 2)
    assert (FP.COUNTS.launches, FP.COUNTS.plain_calls) == (0, 2)


def test_wrappers_reject_bad_shapes_and_int8_pools():
    qg, pk, pv, pages, apos = _case(4, 2, 3, 2, 2, 16, 8, 4, 9,
                                    torch.float32, "cpu")
    with pytest.raises(ValueError, match="S==1"):
        PA.paged_attention_decode(qg, pk, pv, pages, apos)
    with pytest.raises(ValueError, match="float-pool"):
        FP.paged_flash_prefill(qg, pk.to(torch.int8), pv.to(torch.int8),
                               pages, apos)


def test_masked_positions_and_null_page_contribute_nothing():
    """Rewriting every position past apos — the null page and the unused
    tail of a slot's own pages — leaves the plain output unchanged."""
    qg, pk, pv, pages, apos = _case(5, 2, 4, 2, 2, 16, 8, 4, 9,
                                    torch.float32, "cpu")
    ref = PA.gather_attention(qg, pk, pv, pages, apos)
    pk2, pv2 = pk.clone(), pv.clone()
    pk2[0] += 1e3
    pv2[0] -= 1e3
    for b in range(2):
        last = int(apos[b].max())
        pg, off = int(pages[b, last // 8]), last % 8
        pk2[pg, off + 1:] = 7.0
        pv2[pg, off + 1:] = -7.0
    got = PA.gather_attention(qg, pk2, pv2, pages, apos)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


# ---- K6 fp8 GEMM and the flash attention (training slice) -----------------

from distributed_training_sandbox_tpu_torch.ops import (  # noqa: E402
    flash_attention as FA, quant as Q)

FP8_SHAPES = {
    # name: (M, K, N)
    "tiny_ragged": (70, 48, 40),
    "ragged": (333, 1040, 200),
    "wq_wo": (8192, 2048, 2048),
    "wk_wv": (8192, 2048, 512),
    "w_gate_up": (8192, 2048, 11008),
    "w_down": (8192, 11008, 2048),
    # M off the 128-row tile, N a third of one
    "m_off_tile_n40": (1000, 2048, 40),
}
ATTN_SHAPES = {
    # name: (B, S, nq, nkv, hd)
    "tiny_ragged": (2, 37, 4, 2, 128),
    "gqa_ragged": (1, 200, 8, 2, 128),
    "mha": (2, 128, 2, 2, 128),
    # S a multiple of 64 and not of 128 (half of the backward's last
    # 128-row tiles), and a group of 8 query heads
    "s320_rep8": (1, 320, 16, 2, 128),
    "smollm3_train": (1, 8192, 16, 4, 128),
    # a pipeline stage's microbatch at scripts/_pp_driver.py's shapes
    # (batch 64 in 4 microbatches, seq 256)
    "pipeline_stage": (16, 256, 16, 4, 128),
}


def fp8_weight(seed, M, K, N, device):
    """bf16 activations ~ N(0, 1) and a (K, N) weight ~ N(0, 0.02²)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device) * 0.02).to(
        torch.bfloat16)
    return x, w


def fp8_case(seed, M, K, N, device):
    """:func:`fp8_weight` quantised to e4m3 as the training path's
    forward does: (aq, a_s, bt, b_s), the weight's codes K-major (N, K)."""
    x, w = fp8_weight(seed, M, K, N, device)
    return (*Q.quantize_fp8(x), *Q.quantize_fp8_kmajor(w))


def attn_case(seed, B, S, nq, nkv, hd, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, n, hd), generator=gen,
                               device=device).to(torch.bfloat16)
                   for n in (nq, nkv, nkv, nq))
    return q, k, v, do


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(FP8_SHAPES))
def test_fp8_kernel_matches_plain(cuda, shape):
    aq, a_s, bt, b_s = fp8_case(0, *FP8_SHAPES[shape], cuda)
    Q.COUNTS.reset()
    got = Q.fp8_matmul_kernel(aq, a_s, bt, b_s)
    torch.cuda.synchronize()
    assert (Q.COUNTS.launches, Q.COUNTS.plain_calls) == (1, 0)
    ref = Q.fp8_matmul(aq, a_s, bt.t(), b_s, torch.bfloat16)
    atol, rtol = Q.TOLERANCE[torch.bfloat16]
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(FP8_SHAPES))
def test_fp8_kernel_takes_the_kmajor_weight_and_repeats(cuda, shape):
    """The training path's layout: the weight's codes quantised K-major
    on the card are the reference's (K, N) codes transposed, and the
    kernel on them is bit for bit the same on a second launch."""
    M, K, N = FP8_SHAPES[shape]
    aq, a_s, bt, bt_s = fp8_case(0, M, K, N, cuda)
    bq, b_s = Q.quantize_fp8(fp8_weight(0, M, K, N, cuda)[1])
    assert torch.equal(bt.view(torch.uint8),
                       bq.t().contiguous().view(torch.uint8))
    assert torch.equal(bt_s, b_s)
    Q.COUNTS.reset()
    got = Q.fp8_matmul_kernel(aq, a_s, bt, bt_s)
    again = Q.fp8_matmul_kernel(aq, a_s, bt, bt_s)
    torch.cuda.synchronize()
    assert (Q.COUNTS.launches, Q.COUNTS.plain_calls) == (2, 0)
    assert torch.equal(got, again)


@pytest.mark.gpu_port
def test_fp8_kernel_reproduces_every_e4m3_code(cuda):
    """Row i of A holds e4m3 code i (0 for the two NaN codes) in column
    0 and B picks column 0 with a 1: each output is its code's value,
    exactly, subnormal codes included (the kernel's exact e4m3 → bf16
    conversion)."""
    codes = torch.arange(256, dtype=torch.int32)
    codes[(codes & 0x7F) == 0x7F] = 0
    a = torch.zeros((256, 32), dtype=torch.uint8)
    a[:, 0] = codes.to(torch.uint8)
    a = a.view(torch.float8_e4m3fn).to(cuda)
    bt = torch.zeros((16, 32), dtype=torch.float8_e4m3fn)
    bt[:, 0] = 1.0
    one = torch.ones((), device=cuda)
    got = Q.fp8_matmul_kernel(a, one, bt.to(cuda), one)
    want = a[:, 0].float().to(torch.bfloat16)
    assert torch.equal(got[:, 0], want)
    assert torch.equal(got, want[:, None].expand(256, 16))


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
def test_flash_attention_backward_repeats_bit_for_bit(cuda, shape):
    B, S, nq, nkv, hd = ATTN_SHAPES[shape]
    q, k, v, do = attn_case(5, B, S, nq, nkv, hd, cuda)
    o, lse = FA.flash_attention_fwd(q, k, v, hd ** -0.5)
    a = FA.flash_attention_bwd(q, k, v, o, lse, do, hd ** -0.5)
    b = FA.flash_attention_bwd(q, k, v, o, lse, do, hd ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
def test_flash_attention_kernels_match_plain(cuda, shape):
    B, S, nq, nkv, hd = ATTN_SHAPES[shape]
    q, k, v, do = attn_case(1, B, S, nq, nkv, hd, cuda)
    scale = hd ** -0.5
    FA.FWD_COUNTS.reset()
    FA.BWD_COUNTS.reset()
    o, lse = FA.flash_attention_fwd(q, k, v, scale)
    grads = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (FA.FWD_COUNTS.launches, FA.BWD_COUNTS.launches) == (1, 1)
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    atol, rtol = FA.TOLERANCE["fwd"]
    torch.testing.assert_close(o, ref_o, atol=atol, rtol=rtol)
    assert FA.block_rel_l2(o, ref_o) <= FA.BLOCK_REL_L2
    torch.testing.assert_close(lse, ref_lse, atol=FA.LSE_ATOL, rtol=0)
    assert_bwd_matches(shape, grads, q, k, v, do, scale)


def assert_bwd_matches(shape, grads, q, k, v, do, scale):
    """The backward kernel's grads against the plain version: each
    within the module's block relative L2, and elementwise within its
    tolerance, set at B 1, S 8192; at a pipeline stage's microbatch,
    where the plain path strays from the exact gradient as far as the
    kernel does (the module docstring), each within
    ``BWD_ORACLE_L2_RATIO`` of the plain path's L2 distance from the
    exact gradient instead."""
    ref = FA.flash_attention_bwd_plain(q, k, v, do, scale)
    exact = (FA.attention_bwd_oracle(q, k, v, do, scale)
             if shape == "pipeline_stage" else (None,) * 3)
    atol, rtol = FA.TOLERANCE["bwd"]
    for name, g, r, e in zip("qkv", grads, ref, exact):
        if e is None:
            torch.testing.assert_close(g, r, atol=atol, rtol=rtol,
                                       msg=lambda m, n=name: f"d{n}: {m}")
        else:
            ratio = FA.oracle_l2_ratio(g, r, e)
            assert ratio <= FA.BWD_ORACLE_L2_RATIO, f"d{name}: {ratio}"
        assert FA.block_rel_l2(g, r) <= FA.BLOCK_REL_L2, f"d{name}"


@pytest.mark.gpu_port
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [1, 63, 65, 127, 129, 1000])
def test_flash_attention_forward_edges_match_plain_and_repeat(cuda, S, rep):
    """The forward at S on either side of its 64-row tiles, with nq / nkv
    = rep over 2 kv heads; bit-equal on a second launch."""
    q, k, v, _ = attn_case(7, 1, S, 2 * rep, 2, 128, cuda)
    scale = 128 ** -0.5
    FA.FWD_COUNTS.reset()
    o, lse = FA.flash_attention_fwd(q, k, v, scale)
    o2, lse2 = FA.flash_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert (FA.FWD_COUNTS.launches, FA.FWD_COUNTS.plain_calls) == (2, 0)
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    atol, rtol = FA.TOLERANCE["fwd"]
    torch.testing.assert_close(o, ref_o, atol=atol, rtol=rtol)
    assert FA.block_rel_l2(o, ref_o) <= FA.BLOCK_REL_L2
    torch.testing.assert_close(lse, ref_lse, atol=FA.LSE_ATOL, rtol=0)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.gpu_port
def test_flash_attention_autograd_goes_through_the_kernels(cuda):
    q, k, v, do = attn_case(2, *ATTN_SHAPES["gqa_ragged"], cuda)
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FA.FWD_COUNTS.reset()
    FA.BWD_COUNTS.reset()
    out = FA.flash_attention(*args, 128 ** -0.5)
    out.backward(do)
    torch.cuda.synchronize()
    assert (FA.FWD_COUNTS.launches, FA.BWD_COUNTS.launches) == (1, 1)
    assert (FA.FWD_COUNTS.plain_calls, FA.BWD_COUNTS.plain_calls) == (0, 0)
    assert all(torch.isfinite(a.grad).all() for a in args)


@pytest.mark.gpu_port
def test_flash_attention_on_a_second_card_matches_plain(cuda):
    """The forward and backward kernels on ``cuda:1`` with ``cuda:0`` the
    current device, as a one-process pipeline's stage launches them: the
    launch helper makes the operands' card current, so both land there,
    reproduce the launches on ``cuda:0`` bit for bit, and match the plain
    version as ``test_flash_attention_kernels_match_plain`` holds them at
    this shape, on another draw."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", 1)
    B, S, nq, nkv, hd = ATTN_SHAPES["pipeline_stage"]
    q0, k0, v0, do0 = attn_case(6, B, S, nq, nkv, hd, cuda)
    o0, lse0 = FA.flash_attention_fwd(q0, k0, v0, hd ** -0.5)
    grads0 = FA.flash_attention_bwd(q0, k0, v0, o0, lse0, do0, hd ** -0.5)
    q, k, v, do = (t.to(dev) for t in (q0, k0, v0, do0))
    scale = hd ** -0.5
    FA.FWD_COUNTS.reset()
    FA.BWD_COUNTS.reset()
    with torch.cuda.device(0):
        o, lse = FA.flash_attention_fwd(q, k, v, scale)
        grads = FA.flash_attention_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize(dev)
    assert (FA.FWD_COUNTS.launches, FA.BWD_COUNTS.launches) == (1, 1)
    assert o.device == dev and all(g.device == dev for g in grads)
    assert torch.equal(o.cpu(), o0.cpu()) and torch.equal(lse.cpu(),
                                                          lse0.cpu())
    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(grads, grads0))
    ref_o, ref_lse = FA.attention_plain_lse(q, k, v, scale)
    atol, rtol = FA.TOLERANCE["fwd"]
    torch.testing.assert_close(o, ref_o, atol=atol, rtol=rtol)
    assert FA.block_rel_l2(o, ref_o) <= FA.BLOCK_REL_L2
    torch.testing.assert_close(lse, ref_lse, atol=FA.LSE_ATOL, rtol=0)
    assert_bwd_matches("pipeline_stage", grads, q, k, v, do, scale)


@pytest.mark.gpu_port
def test_training_kernels_reject_what_they_do_not_take(cuda):
    aq, a_s, bt, b_s = fp8_case(3, 64, 40, 32, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.fp8_matmul_kernel(aq, a_s, bt, b_s)
    q, k, v, _ = attn_case(4, 1, 16, 4, 2, 64, cuda)
    with pytest.raises(ValueError, match="hd"):
        FA.flash_attention_fwd(q, k, v, 0.1)
    q, k, v, _ = attn_case(4, 1, 16, 4, 2, 128, cuda)
    with pytest.raises(ValueError, match="bf16"):
        FA.flash_attention_fwd(q.float(), k.float(), v.float(), 0.1)
    with pytest.raises(ValueError, match="divide"):
        FA.flash_attention_fwd(q, k[:, :, :1].expand(1, 16, 3, 128)
                               .contiguous(), v[:, :, :1].expand(
                                   1, 16, 3, 128).contiguous(), 0.1)


def test_attention_bwd_oracle_is_the_exact_gradient():
    """On f32 inputs the plain backward rounds nothing to bf16, so it
    lands on the f64 oracle within f32 rounding; a distance ratio of the
    plain path to itself is 1."""
    q, k, v, do = (t.float() for t in attn_case(8, 2, 37, 4, 2, 16, "cpu"))
    scale = 16 ** -0.5
    plain = FA.flash_attention_bwd_plain(q, k, v, do, scale)
    exact = FA.attention_bwd_oracle(q, k, v, do, scale)
    for g, e in zip(plain, exact, strict=True):
        assert e.dtype == torch.float64
        torch.testing.assert_close(g.double(), e, rtol=1e-5, atol=1e-6)
    bf = [g.to(torch.bfloat16) for g in plain]
    assert FA.oracle_l2_ratio(bf[0], bf[0], exact[0]) == 1.0
    assert FA.oracle_l2_ratio(plain[2], bf[2], exact[2]) < 0.01


def test_block_rel_l2_holds_each_block_to_its_own_scale():
    gen = torch.Generator().manual_seed(7)
    ref = torch.randn((1, 150, 2, 128), generator=gen)
    ref[:, 64:] *= 1e-3                 # small late rows
    got = ref.clone()
    assert FA.block_rel_l2(got, ref) == 0.0
    got[0, 140, 1] *= 1.5               # the ragged last block, head 1
    err = float((got - ref).abs().max())
    want = float(0.5 * ref[0, 140, 1].norm() / ref[0, 128:, 1].norm())
    # an error far below any elementwise atol, far above the block limit
    assert err < 2e-3 and want > 5 * FA.BLOCK_REL_L2
    assert FA.block_rel_l2(got, ref) == pytest.approx(want, rel=1e-5)


def test_training_wrappers_take_the_plain_versions_on_the_cpu():
    aq, a_s, bt, b_s = fp8_case(5, 24, 32, 16, "cpu")
    Q.COUNTS.reset()
    out = Q.fp8_matmul_kernel(aq, a_s, bt, b_s)
    assert (Q.COUNTS.launches, Q.COUNTS.plain_calls) == (0, 1)
    assert out.dtype == torch.bfloat16 and out.shape == (24, 16)
    q, k, v, do = attn_case(6, 1, 9, 4, 2, 16, "cpu")
    FA.FWD_COUNTS.reset()
    FA.BWD_COUNTS.reset()
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    FA.flash_attention(*args, 0.25).backward(do)
    assert (FA.FWD_COUNTS.launches, FA.FWD_COUNTS.plain_calls) == (0, 1)
    assert (FA.BWD_COUNTS.launches, FA.BWD_COUNTS.plain_calls) == (0, 1)


# ---- K4, K5 int8 GEMMs and K2 int8 paged decode (int8 slice) ---------------

INT8_SHAPES = {
    # name: (M, K, N)
    "tiny_ragged": (70, 48, 48),
    "ragged": (333, 1040, 208),
    "decode": (8, 2048, 2048),
    "wq_wo": (8192, 2048, 2048),
    "w_gate_up": (8192, 2048, 11008),
    "w_down": (8192, 11008, 2048),
}


def int8_case(seed, M, K, N, device):
    """A bf16 activation ~ N(0, 1) and a weight ~ N(0, 0.02²), quantised
    as the int8 training path does (rows of x, columns of w)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device) * 0.02).to(
        torch.bfloat16)
    return (x, *Q.quantize_int8(x), *Q.quantize_int8(w, axis=0))


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(INT8_SHAPES))
def test_int8_kernels_are_bitwise_their_plain_versions(cuda, shape):
    x, xq, xs, wq, ws = int8_case(0, *INT8_SHAPES[shape], cuda)
    Q.INT8_COUNTS.reset()
    Q.INT8_FUSED_COUNTS.reset()
    k4 = Q.int8_matmul_kernel(xq, xs, wq, ws)
    k5 = Q.int8_matmul_fused_kernel(x, wq, ws)
    torch.cuda.synchronize()
    assert (Q.INT8_COUNTS.launches, Q.INT8_FUSED_COUNTS.launches) == (1, 1)
    assert (Q.INT8_COUNTS.plain_calls, Q.INT8_FUSED_COUNTS.plain_calls) \
        == (0, 0)
    assert torch.equal(k4, Q.int8_matmul(xq, xs, wq, ws, torch.bfloat16))
    assert torch.equal(k5, Q.int8_matmul_fused(x, wq, ws, torch.bfloat16))
    assert torch.equal(k4, k5)   # the same codes: K5 quantises in-kernel
    assert torch.equal(k5, Q.int8_matmul_fused_kernel(x, wq, ws))


K5_RAGGED = {
    # name: (M, K, N), K = 16 x an odd number, M and N off the 128 x 256
    # output tile, K off the 128-byte k-block
    "odd_n": (200, 16 * 13, 301),
    "one_k_block": (129, 16 * 7, 257),
    "few_rows": (7, 16 * 3, 5),
    "long_k": (300, 16 * 173, 520),
}


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(K5_RAGGED))
def test_k5_ragged_shapes_are_bitwise_in_both_layouts(cuda, shape):
    """K5 with the weight K-major (the training path's layout) and in
    the reference's (K, N) layout, which the wrapper transposes."""
    x, _, _, wq, ws = int8_case(7, *K5_RAGGED[shape], cuda)
    ref = Q.int8_matmul_fused(x, wq, ws, torch.bfloat16)
    Q.INT8_FUSED_COUNTS.reset()
    kn = Q.int8_matmul_fused_kernel(x, wq, ws)
    km = Q.int8_matmul_fused_kernel(x, wq.t().contiguous(), ws.t(),
                                    b_kmajor=True)
    torch.cuda.synchronize()
    assert (Q.INT8_FUSED_COUNTS.launches,
            Q.INT8_FUSED_COUNTS.plain_calls) == (2, 0)
    assert torch.equal(kn, ref)
    assert torch.equal(km, ref)


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", ["tiny_ragged", "wq_wo"])
def test_int8_backward_layouts_are_bitwise(cuda, shape):
    """dX = g · Wᵀ (B read K-major) and dW = Xᵀ · g (A transposed, B
    read (K, N)) through K4 against the plain products."""
    M, K, N = INT8_SHAPES[shape]
    x, _, _, _, _ = int8_case(1, M, K, N, cuda)
    g, _, _, w, _ = int8_case(2, M, N, K, cuda)
    w = w.t().contiguous()                                     # (K, N)
    gq, gs = Q.quantize_int8(g, axis=-1)
    wq_n, ws_n = Q.quantize_int8(w, axis=1)
    xq_m, xs_m = Q.quantize_int8(x, axis=0)
    gq_m, gs_m = Q.quantize_int8(g, axis=0)
    for args in ((gq, gs, wq_n, ws_n.T, (1, 1)),
                 (xq_m, xs_m.T, gq_m, gs_m, (0, 0))):
        got = Q._int8_dot(*args, torch.bfloat16, plain=False)
        ref = Q._int8_dot(*args, torch.bfloat16, plain=True)
        assert torch.equal(got, ref)



# K4's three designs at every row count the decode GEMV takes, just
# past it, and the training rows; K and N off every tile and split
K4_ROWS = list(range(1, 17)) + [17, 255, 8192]


@pytest.mark.gpu_port
@pytest.mark.parametrize("M", K4_ROWS)
@pytest.mark.parametrize("b_kmajor", [False, True], ids=["kn", "kmajor"])
def test_k4_designs_are_bitwise_at_every_row_count(cuda, M, b_kmajor):
    """K4 in both B layouts (the GEMV at M <= 16 and mma.sync above for
    a (K, N) B, the wgmma GEMM for a K-major one): bit-equal to the plain
    version and on a second launch."""
    K, N = 16 * 37, 16 * 13
    _, xq, xs, wq, ws = int8_case(8, M, K, N, cuda)
    want = "wgmma" if b_kmajor else ("gemv" if M <= 16 else "mma")
    assert Q.k4_design(M, N, K, b_kmajor) == want
    ref = Q.int8_matmul(xq, xs, wq, ws, torch.bfloat16)
    Q.INT8_COUNTS.reset()
    if b_kmajor:
        got = Q._int8_dot(xq, xs, wq.t().contiguous(), ws, (1, 1),
                          torch.bfloat16, plain=False)
        again = Q._int8_dot(xq, xs, wq.t().contiguous(), ws, (1, 1),
                            torch.bfloat16, plain=False)
    else:
        got = Q.int8_matmul_kernel(xq, xs, wq, ws)
        again = Q.int8_matmul_kernel(xq, xs, wq, ws)
    torch.cuda.synchronize()
    assert (Q.INT8_COUNTS.launches, Q.INT8_COUNTS.plain_calls) == (2, 0)
    assert torch.equal(got, ref)
    assert torch.equal(got, again)


K4_GEMV_SHAPES = {
    # name: (M, K, N): one split (the unembedding), ragged last splits,
    # a ragged last strip, the fewest rows
    "unembed": (8, 2048, 128256),
    "w_down": (16, 11008, 2048),
    "ragged_split": (3, 16 * 131, 512),
    "ragged_strip": (1, 1040, 16 * 257),
    "wk": (8, 2048, 512),
}


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(K4_GEMV_SHAPES))
def test_k4_gemv_splits_are_bitwise_and_repeat(cuda, shape):
    """The split-K GEMV at decode shapes and ragged ones: bit-equal to
    the plain version, and again on a second and third launch (the
    scratch it adds into is left zero)."""
    M, K, N = K4_GEMV_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(9)
    xq, xs = Q.quantize_int8(torch.randn((M, K), generator=gen,
                                         device=cuda))
    wq = torch.randint(-127, 128, (K, N), generator=gen, device=cuda,
                       dtype=torch.int8)
    ws = torch.rand((1, N), generator=gen, device=cuda) * 1e-3
    assert Q.k4_design(M, N, K, False) == "gemv"
    ref = Q.int8_matmul(xq, xs, wq, ws, torch.bfloat16)
    outs = [Q.int8_matmul_kernel(xq, xs, wq, ws) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, ref) for o in outs)


def test_k4_design_follows_rows_and_layout_and_rejects_bad_shapes():
    """The wrapper's choice of K4's design, and the shapes it refuses
    before any launch (checked on the CPU: no card needed)."""
    assert Q.k4_design(8, 2048, 2048, False) == "gemv"
    assert Q.k4_design(16, 128256, 2048, False) == "gemv"
    assert Q.k4_design(17, 2048, 2048, False) == "mma"
    assert Q.k4_design(256, 2048, 2048, False) == "mma"
    assert Q.k4_design(8192, 2048, 8192, True) == "wgmma"
    assert Q.k4_design(8, 2048, 2048, True) == "wgmma"
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.k4_design(8, 2048, 2040, False)      # ragged K at decode
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.k4_design(8192, 2048, 8200, True)
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.k4_design(8, 2040, 2048, False)      # ragged N, (K, N) weight
    with pytest.raises(ValueError, match="empty"):
        Q.k4_design(0, 2048, 2048, False)


def q8_case(seed, B, nkv, rep, hd, page, P, n_pages, device):
    """An int8 pool quantised from random bf16 K/V rows, int8 query rows,
    and the page table of ``_case``."""
    qg, pk, pv, pages, apos = _case(seed, B, 1, nkv, rep, hd, page, P,
                                    n_pages, torch.bfloat16, device)
    (qq, qs), (kq, ks), (vq, vs) = (Q.quantize_int8(t) for t in (qg, pk, pv))
    return qq, qs, kq, vq, ks, vs, pages, apos


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_decode_q8_kernel_matches_plain(cuda, shape):
    B, nkv, rep, hd, page, P = SHAPES[shape]
    qq, qs, kq, vq, ks, vs, pages, apos = q8_case(
        6, B, nkv, rep, hd, page, P, B * P + 1, cuda)
    PA.Q8_COUNTS.reset()
    got = PA.paged_attention_decode(qq, kq, vq, pages, apos, q_scale=qs,
                                    pk_s=ks, pv_s=vs)
    torch.cuda.synchronize()
    assert (PA.Q8_COUNTS.launches, PA.Q8_COUNTS.plain_calls) == (1, 0)
    ref = PA.paged_attention_plain_q8(qq, qs, kq, vq, ks, vs, pages, apos)
    atol, rtol = PA.TOLERANCE_Q8
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    again = PA.paged_attention_decode(qq, kq, vq, pages, apos, q_scale=qs,
                                      pk_s=ks, pv_s=vs)
    assert torch.equal(got, again)


def q8_decode_case(seed, last, nkv, rep, hd, page, P, device):
    """``_decode_case``'s slots, table and pools, the bf16 rows quantised
    to int8 codes with f32 row scales, as the engine writes them."""
    qg, pk, pv, pages, apos = _decode_case(seed, last, nkv, rep, hd, page, P,
                                           torch.bfloat16, device)
    (qq, qs), (kq, ks), (vq, vs) = (Q.quantize_int8(t) for t in (qg, pk, pv))
    return qq, qs, kq, vq, ks, vs, pages, apos


def _q8_launch_twice_against_plain(args):
    """K2 launched twice on ``args``: finite, within ``TOLERANCE_Q8`` of
    the plain version, bit-equal on the second launch, two launches and
    no plain call counted."""
    qq, qs, kq, vq, ks, vs, pages, apos = args
    PA.Q8_COUNTS.reset()
    got, again = (PA.paged_attention_decode(qq, kq, vq, pages, apos,
                                            q_scale=qs, pk_s=ks, pv_s=vs)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert (PA.Q8_COUNTS.launches, PA.Q8_COUNTS.plain_calls) == (2, 0)
    ref = PA.paged_attention_plain_q8(qq, qs, kq, vq, ks, vs, pages, apos)
    atol, rtol = PA.TOLERANCE_Q8
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    assert torch.equal(got, again)


@pytest.mark.gpu_port
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_decode_q8_kernel_boundaries_match_plain_and_repeat(cuda, rep, hd,
                                                            page):
    """K2 over a 2048-position view, its cluster of 8 blocks splitting
    each slot's visible positions: apos 0 (one key, seven blocks with
    none), 5, 7 and 8 (one position a block, then blocks with none
    again), the last row of the first page and the first of the next,
    the edge where a block's range becomes two sub-ranges (8 · H - 1,
    8 · H and 8 · H + 1 visible positions, H = ``PA.rows_held_q8``,
    where that lies inside the view) and the view's last two
    positions; bit-equal on a second launch."""
    V = 2048
    held = PA.rows_held_q8(V, hd)
    last = sorted(a for a in {0, 5, 7, 8, page - 1, page, 8 * held - 2,
                              8 * held - 1, 8 * held, V - 2, V - 1}
                  if a < V)
    _q8_launch_twice_against_plain(q8_decode_case(
        60 + rep, last, 2, rep, hd, page, V // page, cuda))


@pytest.mark.gpu_port
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_decode_q8_kernel_long_view_matches_plain_and_repeat(cuda, rep):
    """K2 over a view longer than its blocks keep scores for in shared
    memory (8 · 2048 positions), where they keep them, with each
    position's V scale, in the wrapper's scratch: slots at apos 0, at
    the shared-memory edge ± 1 and at the view's end; bit-equal on a
    second launch."""
    from distributed_training_sandbox_tpu_torch.kernels import loader
    page, V = 16, 8 * 2048 + 8 * 16
    last = [0, 8 * 2048 - 1, 8 * 2048, V - 1]
    args = q8_decode_case(80 + rep, last, 2, rep, 128, page, V // page, cuda)
    lib = loader.load("paged_decode_q8")
    assert lib.paged_decode_q8_scratch_floats(4, V // page, page, 2, rep,
                                              128) > 0
    assert lib.paged_decode_q8_scratch_floats(4, 2048 // page, page, 2, rep,
                                              128) == 0
    _q8_launch_twice_against_plain(args)


@pytest.mark.gpu_port
def test_int8_kernels_reject_what_they_do_not_take(cuda):
    x, xq, xs, wq, ws = int8_case(3, 64, 40, 32, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.int8_matmul_kernel(xq, xs, wq, ws)
    with pytest.raises(ValueError, match="multiple of 16"):
        Q.int8_matmul_fused_kernel(x, wq, ws)
    x, xq, xs, wq, ws = int8_case(3, 64, 48, 32, cuda)
    with pytest.raises(ValueError, match="bf16"):
        Q.int8_matmul_kernel(xq, xs, wq, ws, torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        Q.int8_matmul_fused_kernel(x.float(), wq, ws)
    qq, qs, kq, vq, ks, vs, pages, apos = q8_case(7, 2, 2, 2, 16, 8, 4, 9,
                                                  cuda)
    with pytest.raises(ValueError, match="int8"):
        PA.paged_attention_decode(qq.float(), kq, vq, pages, apos,
                                  q_scale=qs, pk_s=ks, pv_s=vs)
    with pytest.raises(ValueError, match="int32"):
        PA.paged_attention_decode(qq, kq, vq, pages.long(), apos,
                                  q_scale=qs, pk_s=ks, pv_s=vs)
    qq, qs, kq, vq, ks, vs, pages, apos = q8_case(7, 2, 2, 2, 8, 8, 4, 9,
                                                  cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        PA.paged_attention_decode(qq, kq, vq, pages, apos,
                                  q_scale=qs, pk_s=ks, pv_s=vs)


def test_int8_wrappers_take_the_plain_versions_on_the_cpu():
    x, xq, xs, wq, ws = int8_case(4, 24, 32, 16, "cpu")
    Q.INT8_COUNTS.reset()
    Q.INT8_FUSED_COUNTS.reset()
    k4 = Q.int8_matmul_kernel(xq, xs, wq, ws)
    k5 = Q.int8_matmul_fused_kernel(x, wq, ws)
    assert (Q.INT8_COUNTS.launches, Q.INT8_COUNTS.plain_calls) == (0, 1)
    assert (Q.INT8_FUSED_COUNTS.launches,
            Q.INT8_FUSED_COUNTS.plain_calls) == (0, 1)
    assert k4.dtype == torch.bfloat16 and k4.shape == (24, 16)
    assert torch.equal(k4, k5)
    qq, qs, kq, vq, ks, vs, pages, apos = q8_case(5, 2, 2, 2, 16, 8, 4, 9,
                                                  "cpu")
    PA.Q8_COUNTS.reset()
    got = PA.paged_attention_decode(qq, kq, vq, pages, apos, q_scale=qs,
                                    pk_s=ks, pv_s=vs)
    assert (PA.Q8_COUNTS.launches, PA.Q8_COUNTS.plain_calls) == (0, 1)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 2, 2, 16)


def test_k5_wrapper_takes_either_weight_layout_on_the_cpu():
    """On the CPU both layouts take the plain version, bit for bit the
    same; the inner dimension is checked in either layout before the
    dispatch."""
    x, _, _, wq, ws = int8_case(5, 40, 48, 24, "cpu")
    Q.INT8_FUSED_COUNTS.reset()
    kn = Q.int8_matmul_fused_kernel(x, wq, ws)
    km = Q.int8_matmul_fused_kernel(x, wq.t().contiguous(), ws.t(),
                                    b_kmajor=True)
    assert (Q.INT8_FUSED_COUNTS.launches,
            Q.INT8_FUSED_COUNTS.plain_calls) == (0, 2)
    assert kn.shape == km.shape == (40, 24)
    assert torch.equal(kn, km)
    with pytest.raises(ValueError, match="inner dims"):
        Q.int8_matmul_fused_kernel(x, wq[:32], ws)
    with pytest.raises(ValueError, match="inner dims"):
        Q.int8_matmul_fused_kernel(x, wq.t().contiguous()[:, :32], ws.t(),
                                   b_kmajor=True)


# ---- K7 chunk product of the FSDP all-gather matmul (FSDP slice) -----------

from distributed_training_sandbox_tpu_torch.ops import (  # noqa: E402
    collectives as C)

AG_SHAPES = {
    # name: (M, K of the activation, Kc, N, first column of a's K-chunk):
    # the one-rank products of SMOLLM3_3B_L8 (Kc = K) and a rank's chunk
    # at four ranks (Kc = K / 4, a strided view of the activation)
    "tiny_ragged": (70, 48, 48, 40, 0),
    "wq_wo": (8192, 2048, 2048, 2048, 0),
    "wk_wv": (8192, 2048, 2048, 512, 0),
    "w_gate_up": (8192, 2048, 2048, 11008, 0),
    "w_down": (8192, 11008, 11008, 2048, 0),
    "chunk_512": (8192, 2048, 512, 2048, 1024),
    "chunk_2752": (8192, 11008, 2752, 2048, 3 * 2752),
    "chunk_ragged": (333, 96, 24, 40, 48),
}


def ag_case(seed, M, K, Kc, N, c0, device, dtype=torch.bfloat16):
    """An activation ~ N(0, 1) and a weight shard ~ N(0, 0.02²); the
    activation's K-chunk is the strided view ``a[:, c0:c0 + Kc]``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((M, K), generator=gen, device=device).to(dtype)
    w = (torch.randn((Kc, N), generator=gen, device=device) * 0.02).to(dtype)
    return a[:, c0:c0 + Kc], w


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(AG_SHAPES))
def test_ag_matmul_kernel_matches_plain(cuda, shape):
    a2, w = ag_case(0, *AG_SHAPES[shape], cuda)
    C.COUNTS.reset()
    got = C.ag_matmul_kernel(a2, w)
    torch.cuda.synchronize()
    assert (C.COUNTS.launches, C.COUNTS.plain_calls) == (1, 0)
    assert got.dtype == torch.bfloat16 and got.shape == (a2.shape[0],
                                                          w.shape[1])
    atol, rtol = C.TOLERANCE[torch.bfloat16]
    torch.testing.assert_close(got, C.ag_matmul_plain(a2, w), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, C.ag_matmul_kernel(a2, w))   # no atomics



AG_RAGGED = {
    # name: (M, K, Kc, N, c0): rows, chunk depth and columns off the 128
    # x 256 tile and the 64-deep k-block, the last column tile a single
    # 64-wide box, a chunk at a ragged offset of a long activation
    "rows_cols": (129, 136, 136, 264, 0),
    "one_box": (300, 64, 64, 8, 0),
    "deep_chunk": (200, 11008, 2752, 520, 2752),
    "offset_chunk": (1000, 2048, 520, 72, 1024 + 8),
    "one_row": (1, 512, 512, 256, 0),
}


@pytest.mark.gpu_port
@pytest.mark.parametrize("shape", list(AG_RAGGED))
def test_ag_matmul_ragged_shapes_match_plain_and_repeat(cuda, shape):
    """K7 at ragged M, Kc and N and at strided chunks: within
    ``collectives.TOLERANCE`` of the plain version, bit for bit on a
    second launch."""
    a2, w = ag_case(4, *AG_RAGGED[shape], cuda)
    got = C.ag_matmul_kernel(a2, w)
    again = C.ag_matmul_kernel(a2, w)
    torch.cuda.synchronize()
    atol, rtol = C.TOLERANCE[torch.bfloat16]
    torch.testing.assert_close(got, C.ag_matmul_plain(a2, w), atol=atol,
                               rtol=rtol)
    assert torch.equal(got, again)


def test_ag_matmul_layout_rejects_what_k7_does_not_take():
    """K7's operand rules, checked on the CPU (the wrapper applies them
    to CUDA operands before a launch): a strided chunk at an offset that
    breaks 16-byte alignment, a depth or row stride off a multiple of 8,
    a column-strided view, a non-bf16 operand, mismatched inner dims."""
    a = torch.zeros((64, 2048), dtype=torch.bfloat16)
    w = torch.zeros((512, 256), dtype=torch.bfloat16)
    assert C.ag_matmul_layout(a[:, 1024:1536], w) == 2048
    with pytest.raises(ValueError, match="aligned"):
        C.ag_matmul_layout(a[:, 1028:1540], w)          # 8 bytes off
    with pytest.raises(ValueError, match="multiples of 8"):
        C.ag_matmul_layout(a[:, 1024:1524], w[:500])     # Kc 500
    with pytest.raises(ValueError, match="multiples of 8"):
        C.ag_matmul_layout(torch.zeros((64, 2052), dtype=torch.bfloat16)
                           [:, :512], w)                 # row stride 2052
    with pytest.raises(ValueError, match="row-strided"):
        C.ag_matmul_layout(a.t()[:512], w[:64])
    with pytest.raises(ValueError, match="bf16"):
        C.ag_matmul_layout(a[:, :512].float(), w.float())
    with pytest.raises(ValueError, match="inner dims"):
        C.ag_matmul_layout(a[:, :512], w[:256])


@pytest.mark.gpu_port
def test_all_gather_matmul_pallas_goes_through_k7_at_one_rank(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((2, 64, 256), generator=gen, device=cuda).to(
        torch.bfloat16).requires_grad_(True)
    w = (torch.randn((256, 128), generator=gen, device=cuda) * 0.02).to(
        torch.bfloat16).requires_grad_(True)
    C.COUNTS.reset()
    out = C.all_gather_matmul_pallas(a, w)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (C.COUNTS.launches, C.COUNTS.plain_calls) == (1, 0)
    ref = C.ag_matmul_plain(a.detach().reshape(-1, 256), w.detach())
    atol, rtol = C.TOLERANCE[torch.bfloat16]
    torch.testing.assert_close(out.detach().reshape(-1, 128), ref,
                               atol=atol, rtol=rtol)
    # the backward is the plain products g @ wᵀ and aᵀ @ g
    g = 2 * out.detach().float()
    torch.testing.assert_close(a.grad.float(), (g.to(torch.bfloat16) @
                                                w.detach().t()).float())
    assert torch.isfinite(w.grad).all()


@pytest.mark.gpu_port
def test_ag_matmul_kernel_rejects_what_it_does_not_take(cuda):
    a2, w = ag_case(2, 64, 64, 64, 32, 0, cuda)
    with pytest.raises(ValueError, match="bf16"):
        C.ag_matmul_kernel(a2.float(), w.float())
    with pytest.raises(ValueError, match="multiples of 8"):
        C.ag_matmul_kernel(a2[:, :60], w[:60])
    with pytest.raises(ValueError, match="aligned"):
        C.ag_matmul_kernel(a2[:, 4:12], w[:8])
    with pytest.raises(ValueError, match="row-strided"):
        C.ag_matmul_kernel(a2.t()[:, :64], w)
    with pytest.raises(ValueError, match="cpu"):
        C.ag_matmul_kernel(a2, w.cpu())
    with pytest.raises(ValueError, match="inner dims"):
        C.ag_matmul_kernel(a2, w[:32])


def test_ag_matmul_takes_the_plain_version_on_the_cpu():
    a2, w = ag_case(3, 24, 96, 32, 16, 32, "cpu", torch.float32)
    C.COUNTS.reset()
    out = C.ag_matmul_kernel(a2, w)
    assert (C.COUNTS.launches, C.COUNTS.plain_calls) == (0, 1)
    assert out.dtype == torch.float32 and torch.equal(out, a2 @ w)
    a2, w = ag_case(3, 24, 96, 32, 16, 32, "cpu")
    out = C.ag_matmul_kernel(a2, w)
    assert (C.COUNTS.launches, C.COUNTS.plain_calls) == (0, 2)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, (a2.float() @ w.float()).to(torch.bfloat16))
