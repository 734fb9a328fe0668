"""The port's radix prefix cache against the JAX reference, on the CPU.

``RadixPrefixCache`` and the prefix-aware admission are host Python,
ported line for line, so their decisions are held against the
reference's bit for bit: one scripted sequence of trie operations with
every node, refcount, LRU stamp, counter and the allocator's free list
equal after each step, and the batcher's admission log (grants,
``prefill_pos``, evictions) over a seeded arrival stream.  The engine
with ``prefix_cache=True`` emits the JAX engine's tokens, token for
token, on the reference's weights bridged (TINY_LM in f32, scaled ×3),
with equal trie stats; and the reference's copy-on-write and
pool-pressure laws hold on the port's pool (``tests/
test_decode_frontier.py``: aliased pages' bytes never change, the
allocator's ledger closes over the usable pages).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_training_sandbox_tpu.models import transformer as JT
from distributed_training_sandbox_tpu.serving import engine as JE
from distributed_training_sandbox_tpu.serving import kv_pool as JK
from distributed_training_sandbox_tpu.serving import scheduler as JS
from distributed_training_sandbox_tpu_torch import bridge
from distributed_training_sandbox_tpu_torch.models import transformer as PT
from distributed_training_sandbox_tpu_torch.models.generate import (
    generate as port_generate)
from distributed_training_sandbox_tpu_torch.serving import engine as PE
from distributed_training_sandbox_tpu_torch.serving import kv_pool as PK
from distributed_training_sandbox_tpu_torch.serving import scheduler as PS
torch.set_num_threads(1)  # the suite's workers share the cores

ENGINE = dict(max_batch=2, page_size=8, max_seq_len=48, prefill_chunk=8)


def _bridged(seed=1, scale=3.0):
    """(the reference's TINY_LM weights scaled, the port's copy)."""
    jp = JT.init_params(jax.random.PRNGKey(seed), JT.TINY_LM)
    jp = jax.tree.map(lambda x: (x * scale).astype(x.dtype), jp)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                      PT.TINY_LM)


@pytest.fixture(scope="module")
def weights():
    return _bridged()


def _prompts_with_shared_prefix(n, sys_len=17, seed=7):
    """The reference suite's prompts: one shared head, private tails."""
    rng = np.random.default_rng(seed)
    vocab = PT.TINY_LM.vocab_size
    head = rng.integers(1, vocab, size=sys_len).astype(np.int32)
    return [np.concatenate([head, rng.integers(
        1, vocab, size=int(rng.integers(3, 12))).astype(np.int32)])
        for _ in range(n)]


def _generate_ref(pp, req, capacity, kv_quant=False):
    return port_generate(pp, req.prompt[None], PT.TINY_LM,
                         max_new_tokens=req.max_new_tokens,
                         cache_capacity=capacity, kv_quant=kv_quant,
                         device="cpu")[0].tolist()


# ---- the trie, step for step ----------------------------------------------

def _trie_state(cache):
    """Everything the trie decides: each node (path of keys, page, refs,
    LRU stamp) in creation order, the counters, and the free list."""
    def path(n):
        keys = []
        while n is not None:
            keys.append(n.key)
            n = n.parent
        return tuple(reversed(keys))

    nodes = [(path(n), n.page, n.refs, n.last_used, n.depth,
              sorted(n.children)) for n in cache._nodes]
    return (nodes, sorted(cache._root), cache.stats(), cache._clock,
            cache.cached_pages, cache.reclaimable_pages,
            list(cache.allocator._free))


def _script(K):
    """A scripted trie session on package ``K``; yields after each step.
    A holds 17 tokens (4 full pages), B shares A's first two chunks, C is
    A's concurrent twin, D diverges in its first chunk."""
    alloc = K.PageAllocator(32)
    cache = K.RadixPrefixCache(alloc, page_size=4)
    A = np.arange(100, 117, dtype=np.int32)
    B = np.concatenate([A[:8], np.arange(300, 311, dtype=np.int32)])
    D = np.arange(500, 513, dtype=np.int32)
    pa = alloc.alloc(5)
    na, sa = cache.insert(A, pa, [])
    yield "insert A", (len(na), sa)
    mb = cache.match(B)
    cache.note_lookup(len(mb), (len(B) - 1) // 4)
    cache.acquire(mb)
    pb = [n.page for n in mb] + alloc.alloc(3)
    nb, sb = cache.insert(B, pb, mb)
    yield "admit + insert B", ([n.page for n in mb], len(nb), sb)
    pc = alloc.alloc(5)           # C prefilled beside A: a twin
    nc, sc = cache.insert(A, pc, [])
    yield "insert twin C", ([n.page for n in nc], sc)
    cache.release(na)
    cache.release(nc)
    yield "release A and C", cache.reclaimable_pages
    yield "evict 2", cache.evict(2)
    md = cache.match(D)
    cache.note_lookup(len(md), (len(D) - 1) // 4)
    nd, sd = cache.insert(D, alloc.alloc(4), md)
    yield "insert D", (len(md), len(nd), sd)
    cache.release(nb)
    yield "release B", cache.reclaimable_pages
    try:
        cache.release(nb)
        yield "double release", None
    except ValueError as e:
        yield "double release", str(e)
    yield "evict 3 (LRU, deepest first)", cache.evict(3)
    cache.release(nd)
    yield "evict all", cache.evict(100)
    yield "hit rate", cache.hit_rate
    yield "state", _trie_state(cache)


def test_trie_script_equals_jax_step_for_step():
    ref, got = _script(JK), _script(PK)
    steps = 0
    for (n1, v1), (n2, v2) in zip(ref, got):
        assert n1 == n2
        assert v1 == v2, (n1, v1, v2)
        steps += 1
    assert steps == 12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trie_random_sessions_equal_jax(seed):
    """Random match / acquire / insert / release / evict over prompts
    drawn from a few shared heads, both packages fed the same stream."""
    def session(K):
        rng = np.random.default_rng(seed)
        alloc = K.PageAllocator(40)
        cache = K.RadixPrefixCache(alloc, page_size=4)
        heads = [rng.integers(1, 50, size=12).astype(np.int32)
                 for _ in range(3)]
        held, log = [], []
        for _ in range(60):
            op = rng.integers(0, 4)
            if op < 2:
                h = heads[int(rng.integers(0, 3))]
                toks = np.concatenate([h, rng.integers(
                    1, 50, size=int(rng.integers(1, 9))).astype(np.int32)])
                m = cache.match(toks)
                need = (len(toks) - 1) // 4 - len(m) + 1
                if alloc.free_pages < need:
                    log.append(("evict", cache.evict(need)))
                pages = alloc.alloc(need)
                if pages is None:
                    log.append(("full",))
                    continue
                cache.acquire(m)
                nodes, swaps = cache.insert(
                    toks, [n.page for n in m] + pages, m)
                held.append(nodes)
                log.append(("insert", len(m), len(nodes), swaps))
            elif op == 2 and held:
                cache.release(held.pop(int(rng.integers(0, len(held)))))
                log.append(("release", cache.reclaimable_pages))
            else:
                log.append(("evict", cache.evict(int(rng.integers(1, 4)))))
            log.append(_trie_state(cache))
        return log

    assert session(PK) == session(JK)


# ---- prefix-aware admission -------------------------------------------------

def _admission_log(S, K, seed=4):
    """A batcher with a prefix cache over a small pool, driven by a
    seeded stream of requests on two shared heads; each admission's
    (round, rid, slot, pages, cached pages, prefill_pos), each finished
    prefill's swaps, and the counters."""
    rng = np.random.default_rng(seed)
    alloc = K.PageAllocator(24)
    cb = S.ContinuousBatcher(max_batch=3, allocator=alloc, page_size=4)
    cache = K.RadixPrefixCache(alloc, page_size=4)
    cb.prefix_cache = cache
    heads = [rng.integers(1, 90, size=9).astype(np.int32) for _ in range(2)]
    log, rid = [], 0
    for rnd in range(50):
        for _ in range(int(rng.poisson(0.9))):
            h = heads[int(rng.integers(0, 2))]
            prompt = np.concatenate([h, rng.integers(
                1, 90, size=int(rng.integers(1, 12))).astype(np.int32)])
            cb.submit(S.Request(rid=rid, prompt=prompt,
                                max_new_tokens=int(rng.integers(1, 6))),
                      now=float(rnd))
            rid += 1
        for r in cb.admit(now=float(rnd)):
            log.append((rnd, r.rid, r.slot, list(r.pages),
                        [n.page for n in r.cache_nodes], r.prefill_pos))
        for r in [r for r in cb.slots if r is not None]:
            if r.state == S.PREFILL and rng.random() < 0.6:
                nodes, swaps = cache.insert(r.prompt, r.pages,
                                            r.cache_nodes)
                r.cache_nodes = nodes
                for i, pg in swaps.items():
                    r.pages[i] = pg
                r.state = S.DECODE
                log.append(("swaps", r.rid, swaps))
            elif r.state == S.DECODE and rng.random() < 0.4:
                cb.retire(r, now=float(rnd))
    return (log, cache.stats(), cb.admitted_total, cb.completed_total,
            alloc.free_pages)


def test_prefix_admission_equals_jax():
    ref = _admission_log(JS, JK)
    got = _admission_log(PS, PK)
    assert got == ref
    st = ref[1]
    # the stream exercised hits, evictions under pressure and twins
    assert st["hit_pages"] > 0 and st["evictions"] > 0
    assert any(e[0] == "swaps" and e[2] for e in ref[0])


def test_release_all_returns_trie_refs_and_resets_requests():
    alloc = PK.PageAllocator(20)
    cb = PS.ContinuousBatcher(2, alloc, page_size=4)
    cache = PK.RadixPrefixCache(alloc, page_size=4)
    cb.prefix_cache = cache
    head = np.arange(1, 10, dtype=np.int32)
    first = PS.Request(rid=0, prompt=head, max_new_tokens=2)
    cb.submit(first, 0.0)
    cb.admit(0.0)
    first.cache_nodes, _ = cache.insert(first.prompt, first.pages, [])
    cb.retire(first, 1.0)
    reqs = [PS.Request(rid=i, prompt=np.concatenate([head, [50 + i]]),
                       max_new_tokens=3, trace_id=f"tr-{i}")
            for i in (1, 2, 3)]
    for r in reqs:
        cb.submit(r, 2.0)
    cb.admit(2.0)
    assert [len(r.cache_nodes) for r in reqs[:2]] == [2, 2]
    assert cache.reclaimable_pages == 0
    orphans = cb.release_all()
    assert [r.rid for r in orphans] == [1, 2, 3]
    assert all(r.cache_nodes == [] and r.pages is None and r.prefill_pos == 0
               for r in orphans)
    assert [r.trace_id for r in orphans] == ["tr-1", "tr-2", "tr-3"]
    # every ref handed back: the cached pages are idle, the rest free
    assert cache.reclaimable_pages == cache.cached_pages == 2
    assert alloc.free_pages + cache.cached_pages == 19


# ---- the engine against the JAX engine --------------------------------------

@pytest.mark.parametrize("n_prompts,max_new", [(4, 6), (6, 9)])
def test_prefix_engine_tokens_and_stats_equal_jax(weights, n_prompts,
                                                  max_new):
    jp, pp = weights
    prompts = _prompts_with_shared_prefix(n_prompts)
    jeng = JE.ServingEngine(jp, JT.TINY_LM, prefix_cache=True, **ENGINE)
    jreqs = [jeng.submit(p, max_new_tokens=max_new) for p in prompts]
    jeng.run()
    eng = PE.ServingEngine(pp, PT.TINY_LM, prefix_cache=True, device="cpu",
                           **ENGINE)
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    for j, p in zip(jreqs, reqs):
        assert p.tokens == j.tokens, (p.rid, p.tokens, j.tokens)
        assert p.trace_id == j.trace_id
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    assert eng.prefix_cache.hit_pages > 0
    assert eng.slo_report()["prefix_cache"] == \
        jeng.slo_report()["prefix_cache"]
    assert eng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_prefix_engine_equals_port_generate(weights, kernels):
    """With or without the kernel flags (on the CPU both take the plain
    versions), every request's tokens are one-shot ``generate``'s."""
    _, pp = weights
    eng = PE.ServingEngine(pp, PT.TINY_LM, prefix_cache=True, device="cpu",
                           paged_kernel=kernels, flash_prefill=kernels,
                           **ENGINE)
    reqs = [eng.submit(p, max_new_tokens=6)
            for p in _prompts_with_shared_prefix(5, seed=11)]
    eng.run()
    assert eng.prefix_cache.hit_pages > 0
    for r in reqs:
        assert r.tokens == _generate_ref(pp, r, eng.view_capacity)


def _cow_run(pp, kv_quant):
    """The reference's CoW scenario: a request caches a 2-page prefix,
    a second diverges right at the aliased boundary."""
    cfg = PT.TINY_LM
    eng = PE.ServingEngine(pp, cfg, max_batch=2, page_size=8,
                           max_seq_len=48, prefill_chunk=8,
                           prefix_cache=True, kv_quant=kv_quant,
                           device="cpu")
    rng = np.random.default_rng(3)
    head = rng.integers(1, cfg.vocab_size, size=17).astype(np.int32)
    p1 = np.concatenate([head, rng.integers(
        1, cfg.vocab_size, size=5).astype(np.int32)])
    r1 = eng.submit(p1, max_new_tokens=6)
    eng.run()
    cached = sorted(n.page for n in eng.prefix_cache._nodes)
    b = eng.pool.bufs
    pools = [*b.k, *b.v, *(b.k_scale or ()), *(b.v_scale or ())]
    snap = [t[cached].clone() for t in pools]
    p2 = np.concatenate([head, rng.integers(
        1, cfg.vocab_size, size=9).astype(np.int32)])
    r2 = eng.submit(p2, max_new_tokens=6)
    eng.run()
    return eng, cached, pools, snap, (r1, r2)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
def test_cow_aliased_pages_stay_byte_identical(weights, kv_quant):
    _, pp = weights
    eng, cached, pools, snap, reqs = _cow_run(pp, kv_quant)
    assert len(cached) == 2               # (22 - 1) // 8 full pages
    assert eng.prefix_cache.hit_pages == 2
    for t, s in zip(pools, snap):
        assert torch.equal(t[cached], s), "an aliased page was written"
    for r in reqs:
        assert r.tokens == _generate_ref(pp, r, eng.view_capacity,
                                         kv_quant=kv_quant)


def test_eviction_under_pool_pressure_end_to_end():
    """A pool sized for about two resident requests: the trie keeps
    retired prefixes until admission pressure evicts them; the ledger
    closes over the usable pages, and the tokens stay the JAX engine's
    and ``generate``'s."""
    jp, pp = _bridged(seed=2)
    cfg = PT.TINY_LM
    rng = np.random.default_rng(5)
    prompts = []
    for _ in range(4):                  # 4 distinct 2-page prefixes
        head = rng.integers(1, cfg.vocab_size, size=17).astype(np.int32)
        prompts.append(np.concatenate([head, rng.integers(
            1, cfg.vocab_size, size=4).astype(np.int32)]))
    kw = dict(max_batch=2, page_size=8, max_seq_len=40, n_pages=11,
              prefill_chunk=8, prefix_cache=True)
    eng = PE.ServingEngine(pp, cfg, device="cpu", **kw)
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    jeng = JE.ServingEngine(jp, JT.TINY_LM, **kw)
    jreqs = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.run()
    st = eng.prefix_cache.stats()
    assert st["evictions"] > 0
    assert st == jeng.prefix_cache.stats()
    assert eng.pool.allocator.pages_in_use == eng.prefix_cache.cached_pages
    assert eng.pool.allocator.free_pages \
        + eng.prefix_cache.cached_pages == 10
    for r, j in zip(reqs, jreqs):
        assert r.tokens == j.tokens
        assert r.tokens == _generate_ref(pp, r, eng.view_capacity)


def test_can_accept_credits_reclaimable_pages():
    _, pp = _bridged(seed=2)
    cfg = PT.TINY_LM
    eng = PE.ServingEngine(pp, cfg, max_batch=2, page_size=8,
                           max_seq_len=40, n_pages=11, prefill_chunk=8,
                           prefix_cache=True, device="cpu")
    rng = np.random.default_rng(9)
    for _ in range(2):
        eng.submit(rng.integers(1, cfg.vocab_size, size=30).astype(np.int32),
                   max_new_tokens=4)
    eng.run()
    probe = PS.Request(rid=99, prompt=np.arange(1, 31, dtype=np.int32),
                       max_new_tokens=4)
    need = eng.batcher.pages_needed(probe)
    free = eng.pool.allocator.free_pages
    assert free < need <= free + eng.prefix_cache.reclaimable_pages
    assert eng.can_accept(probe) and eng.in_flight() == 0
    eng.enqueue(probe, now=0.0)
    assert not eng.can_accept(probe) and eng.in_flight() == 1
