"""The port's CUDA kernels against their plain PyTorch versions.

Imports torch, numpy and the port only — no JAX — so that it also runs
on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py

The ``gpu_port`` tests launch the kernels and skip where no card is
present; the rest check dispatch and validation on the CPU.  Tolerances
are the ones each kernel module states (``TOLERANCE``): the kernels do
the plain version's operations in another summation order, so f32 pools
agree to f32 rounding, and bf16 pools where no probability lands on the
other side of a bf16 rounding boundary.
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
