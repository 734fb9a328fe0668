#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the paged serving engine on
SmolLM3-3B with the hand-written Hopper kernels.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels build for sm_90a) and nvcc.
Phases, each of which fails the run:

1. card and build — print the card's name and power limit, build every
   kernel from ``csrc/`` (one nvcc per source, in parallel);
2. kernels — each kernel against its plain PyTorch version at the shapes
   the serve phase gives it, at the tolerance its module states; then
   CUDA-event times of the kernel, the plain version and a library
   yardstick (SDPA over a pre-gathered view), beside the card's bound;
3. serve — ``ServingEngine`` with both kernels on SMOLLM3_3B (full width,
   all 36 layers, seeded random weights scaled ×3) answers 8 requests;
   launch counts must equal the steps × layers, plain counts must be 0;
4. parity — against the port's one-shot ``generate`` at the engine's
   view capacity: first tokens equal, and one decode step's logits
   through the kernels and through the plain path from one pool state
   allclose.

After the gates, a second serve run of the same shape under
``torch.profiler`` reports the device's busy share and its top kernels.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no card or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from distributed_training_sandbox_tpu_torch.kernels import loader
from distributed_training_sandbox_tpu_torch.models import transformer as T
from distributed_training_sandbox_tpu_torch.models.generate import (
    _forward_cached, generate, init_cache)
from distributed_training_sandbox_tpu_torch.ops import flash_prefill as FP
from distributed_training_sandbox_tpu_torch.ops import paged_attention as PA
from distributed_training_sandbox_tpu_torch.serving import engine as E
from distributed_training_sandbox_tpu_torch.serving.accounting import (
    kv_bytes_per_step, tree_bytes, weight_read_bytes)
from distributed_training_sandbox_tpu_torch.serving.kv_pool import PagedKVPool

SEED = 0
CFG = T.SMOLLM3_3B
PARAM_SCALE = 3.0
N_REQUESTS, NEW_TOKENS = 8, 64
PROMPT_LEN = (256, 1536)
ENGINE = dict(paged_kernel=True, flash_prefill=True, max_batch=8,
              page_size=16, max_seq_len=2048, prefill_chunk=256,
              sync_every=8)
# H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# One decode step's logits through the kernels vs the plain path, from
# one pool state: max |difference| <= LOGIT_ATOL.  The kernels do the
# plain path's operations in another summation order, so a few bf16
# roundings per layer land one ulp apart, and 36 layers of x3 weights
# amplify that.  On an H100 the kernels read 0.89 at max |logit| 35
# (argmax unchanged); a decode kernel that skips the probabilities' bf16
# rounding read 2.81 (one-pass) and 2.13 (``chip_gate_mutation.py``).
# The limit lies between them.
LOGIT_ATOL = 1.5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ kernel phase

def _pools(gen, n_pages, page, nkv, hd, copies):
    """``copies`` independent K/V pools: timing cycles through them so
    that no launch finds the previous one's pages in the 50 MB L2."""
    def one():
        return torch.randn((n_pages, page, nkv, hd), generator=gen,
                           device="cuda", dtype=CFG.dtype)
    return [(one(), one()) for _ in range(copies)]


def _page_table(rng, last, page, P, n_pages):
    pages = np.zeros((len(last), P), np.int32)
    perm = rng.permutation(np.arange(1, n_pages))
    used = 0
    for b, a in enumerate(last):
        n = int(a) // page + 1
        pages[b, :n] = perm[used:used + n]
        used += n
    return torch.as_tensor(pages, device="cuda")


def _sdpa_inputs(qg, pk, pv, pages, apos):
    """SDPA operands for the same attention over a gathered view (the
    gather is done here, outside the timed call)."""
    B, S, nkv, rep, hd = qg.shape
    V = pages.shape[1] * pk.shape[1]
    gk = pk[pages.long()].reshape(B, V, nkv, hd).transpose(1, 2)
    gv = pv[pages.long()].reshape(B, V, nkv, hd).transpose(1, 2)
    q = qg.reshape(B, S, nkv * rep, hd).transpose(1, 2)
    mask = (torch.arange(V, device="cuda")[None, None, :]
            <= apos[:, :, None])[:, None]
    return q, gk.contiguous(), gv.contiguous(), mask


def kernel_phase(rng, gen) -> list[dict]:
    """Both kernels at the serve phase's shapes: B = 8 slots, pages of
    16 rows, a 2048-position view, 4 kv heads × 4 query rows, hd 128,
    bf16; apos drawn like the serve phase's prompts."""
    B, page = ENGINE["max_batch"], ENGINE["page_size"]
    P = ENGINE["max_seq_len"] // page
    nkv, hd = CFG.num_key_value_heads, CFG.resolved_head_dim
    rep = CFG.num_attention_heads // nkv
    n_pages, V = B * P + 1, P * page
    plen = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=B)
    copies = 4
    pools = _pools(gen, n_pages, page, nkv, hd, copies)
    results = []

    # K1 decode: one row per slot somewhere in its 64 decode steps
    dec_apos = plen + rng.integers(0, NEW_TOKENS, size=B)
    # K3 prefill: each slot's final 256-row chunk
    chunk = ENGINE["prefill_chunk"]
    pos = (plen - 1) // chunk * chunk
    pre_apos = pos[:, None] + np.arange(chunk)[None, :]
    specs = [
        ("paged_decode", PA.paged_attention_decode, PA.paged_attention_plain,
         PA, 1, dec_apos[:, None], "distributed_training_sandbox_tpu/ops/"
         "paged_attention.py:104 (paged_attention_decode, _decode_kernel)"),
        ("flash_prefill", FP.paged_flash_prefill,
         FP.paged_flash_prefill_plain, FP, chunk, pre_apos,
         "distributed_training_sandbox_tpu/ops/flash_prefill.py:126 "
         "(paged_flash_prefill, _prefill_kernel)"),
    ]
    for name, fn, plain, mod, S, apos_np, replaces in specs:
        apos = torch.as_tensor(apos_np.astype(np.int32), device="cuda")
        pages = _page_table(rng, apos_np.max(axis=1), page, P, n_pages)
        qg = torch.randn((B, S, nkv, rep, hd), generator=gen, device="cuda",
                         dtype=CFG.dtype)
        pk, pv = pools[0]
        got = fn(qg, pk, pv, pages, apos)
        torch.cuda.synchronize()
        ref = plain(qg, pk, pv, pages, apos)
        err = float((got - ref).abs().max())
        atol, rtol = mod.TOLERANCE[CFG.dtype]
        check(torch.isfinite(got).all(), f"{name}: non-finite output")
        check(torch.allclose(got, ref, atol=atol, rtol=rtol),
              f"{name}: max |kernel - plain| = {err} over atol {atol} "
              f"rtol {rtol}")

        it = iter(range(10 ** 9))

        def cyc():
            return pools[next(it) % copies]

        k_ms = time_ms(lambda: fn(qg, *cyc(), pages, apos))
        p_ms = time_ms(lambda: plain(qg, *cyc(), pages, apos), iters=5)
        sd = [_sdpa_inputs(qg, k_, v_, pages, apos) for k_, v_ in pools]
        l_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            *sd[next(it) % copies][:3], attn_mask=sd[0][3], enable_gqa=True))

        # work this run's data needs: every visible key row read once,
        # QK and PV over the visible positions of every query row
        vis_rows = np.minimum(apos_np, V - 1) + 1                # (B, S)
        kv_rows = vis_rows.max(axis=1).sum()
        item = qg.element_size()
        nbytes = (qg.numel() * item + kv_rows * nkv * hd * item * 2
                  + got.numel() * 4 + pages.numel() * 4 + apos.numel() * 4)
        flops = float(vis_rows.sum()) * nkv * rep * hd * 4
        b_ms, b_by = bound(nbytes, flops)
        log(f"{name}: max_abs_err {err:.3e} (atol {atol}, rtol {rtol}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, SDPA {l_ms:.4f} "
            f"ms, bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        results.append({
            "name": name, "route": "cuda",
            "source": f"distributed_training_sandbox_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
            "max_err": err, "kernel_ms": k_ms})
        del sd
    del pools
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------- serve phase

def build_params():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = T.init_params(CFG, gen, "cuda")
    for leaf in [params["embed"], params["final_norm"],
                 *params["layers"].values()]:
        leaf.mul_(PARAM_SCALE)
    return params


def serve_phase(params, rng, card: str):
    prompts = [rng.integers(1, CFG.vocab_size,
                            size=int(rng.integers(PROMPT_LEN[0],
                                                  PROMPT_LEN[1] + 1))
                            ).astype(np.int32) for _ in range(N_REQUESTS)]
    eng = E.ServingEngine(params, CFG, **ENGINE)
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    PA.COUNTS.reset()
    FP.COUNTS.reset()
    eng.run()
    torch.cuda.synchronize()
    counts = {"paged_decode": (PA.COUNTS.launches, PA.COUNTS.plain_calls),
              "flash_prefill": (FP.COUNTS.launches, FP.COUNTS.plain_calls)}
    L = CFG.num_hidden_layers
    steps, chunks = eng.stats["decode_steps"], eng.stats["prefill_chunks"]
    for r in reqs:
        check(len(r.tokens) == NEW_TOKENS,
              f"request {r.rid}: {len(r.tokens)} tokens, not {NEW_TOKENS}")
        check(all(0 <= t < CFG.vocab_size for t in r.tokens),
              f"request {r.rid}: token out of the vocabulary")
    check(counts["paged_decode"] == (steps * L, 0),
          f"paged_decode (launches, plain) {counts['paged_decode']} != "
          f"({steps} decode steps x {L} layers, 0)")
    check(counts["flash_prefill"] == (chunks * L, 0),
          f"flash_prefill (launches, plain) {counts['flash_prefill']} != "
          f"({chunks} prefill chunks x {L} layers, 0)")
    slo = eng.slo_report()
    log(f"serve on {card}: {slo['completed']}/{N_REQUESTS} requests, "
        f"{steps} decode steps, {chunks} prefill chunks; TTFT p50 "
        f"{slo['ttft_ms']['p50']} ms p99 {slo['ttft_ms']['p99']} ms, "
        f"per-token p50 {slo['per_token_ms']['p50']} ms, "
        f"{slo['tokens_per_s']} tok/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"serve scheduler: {json.dumps(slo['scheduler'])}")
    # the least a decode step could take: every weight byte and the KV
    # rows of the active slots read once (the mean context of the run)
    ctx = np.mean([r.n_prompt + NEW_TOKENS / 2 for r in reqs])
    step_bytes = (weight_read_bytes(CFG, params, tree_bytes(params))
                  + kv_bytes_per_step(CFG, N_REQUESTS, int(ctx)))
    log(f"decode step: {slo['scheduler']['decode_ms_total'] / steps:.3f} ms"
        f" on the host clock, bound {step_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms by bytes ({step_bytes / 1e9:.3f} GB: weights + KV of "
        f"{N_REQUESTS} slots at mean context {ctx:.0f})")
    return eng, reqs, {k: v[0] for k, v in counts.items()}


# ------------------------------------------------------------ parity phase

def _prefill(reqs, eng, flash: bool):
    """Chunked prefill of ``reqs`` (one row each) into a fresh pool, the
    engine's way; returns the pool, the page table and each row's f32
    logits at its last prompt position (B, vocab)."""
    page, P, Ck = eng.page_size, eng.pages_per_request, eng.prefill_chunk
    B = len(reqs)
    pool = PagedKVPool(eng.cfg, B * P + 1, page, device="cuda")
    pages = torch.arange(1, B * P + 1, dtype=torch.int32,
                         device="cuda").reshape(B, P)
    plen = np.array([r.n_prompt for r in reqs], np.int32)
    plen_d = torch.as_tensor(plen, device="cuda")
    logits = None
    for pos in range(0, int(plen.max()), Ck):
        ids = np.zeros((B, Ck), np.int32)
        for i, r in enumerate(reqs):
            ids[i, :len(r.prompt[pos:pos + Ck])] = r.prompt[pos:pos + Ck]
        apos = pos + torch.arange(Ck, dtype=torch.int32,
                                  device="cuda")[None, :].repeat(B, 1)
        with torch.no_grad():
            x = E._paged_forward(eng._params,
                                 torch.as_tensor(ids, device="cuda"),
                                 eng.cfg, pool.bufs, pages, apos,
                                 apos < plen_d[:, None],
                                 flash_prefill=flash)
            last = torch.as_tensor(np.clip(plen - 1 - pos, 0, Ck - 1),
                                   device="cuda").long()
            lg = E._last_logits(eng._params,
                                x[torch.arange(B, device="cuda"), last][:, None],
                                eng.cfg)
        # a row's logits count only in the chunk holding its last position
        ends = torch.as_tensor((pos < plen) & (plen <= pos + Ck),
                               device="cuda")[:, None]
        logits = lg if logits is None else torch.where(ends, lg, logits)
    return pool, pages, logits


def _decode_step_logits(eng, pool, pages, toks, lengths, kernel: bool):
    """One decode step from the pool's current state, restored after."""
    snapshot = [t.clone() for t in pool.bufs.k + pool.bufs.v]
    with torch.no_grad():
        x = E._paged_forward(eng._params, toks[:, None], eng.cfg, pool.bufs,
                             pages, lengths[:, None],
                             torch.ones_like(toks[:, None], dtype=torch.bool),
                             paged_kernel=kernel)
        out = E._last_logits(eng._params, x, eng.cfg)
    for t, s in zip(pool.bufs.k + pool.bufs.v, snapshot):
        t.copy_(s)
    return out


def _gap(logits):
    top = torch.topk(logits, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).tolist()


def parity_phase(params, reqs, eng):
    """One-shot ``generate`` against the engine, and the kernels against
    the plain path from one state.  Everything is logged first; the
    gates follow."""
    pair = reqs[:2]
    failures = []
    gen_first = []
    for r in pair:
        ref = generate(params, r.prompt[None], CFG,
                       max_new_tokens=NEW_TOKENS,
                       cache_capacity=eng.view_capacity)[0].tolist()
        gen_first.append(ref[0])
        same = sum(a == b for a, b in zip(r.tokens, ref))
        prefix = next((i for i, (a, b) in enumerate(zip(r.tokens, ref))
                       if a != b), len(ref))
        log(f"parity rid {r.rid}: {same}/{len(ref)} tokens agree with "
            f"one-shot generate, first {prefix} in a row")
        if r.tokens[0] != ref[0]:
            failures.append(f"request {r.rid}: first token {r.tokens[0]} "
                            f"!= one-shot generate's {ref[0]}")
    cache_logits = []
    for r in pair:
        cache = init_cache(CFG, 1, eng.view_capacity, device="cuda")
        with torch.no_grad():
            lg, _ = _forward_cached(params, torch.as_tensor(
                r.prompt[None], device="cuda").long(), CFG, cache, 0)
        cache_logits.append(lg[0])
    lg_gen = torch.stack(cache_logits)
    pool, pages, lg_k = _prefill(pair, eng, flash=True)
    _, _, lg_p = _prefill(pair, eng, flash=False)
    d = lambda a, b: float((a - b).abs().max())
    log(f"parity prefill logits: |kernel - plain| {d(lg_k, lg_p):.4f}, "
        f"|kernel - generate| {d(lg_k, lg_gen):.4f}, |plain - generate| "
        f"{d(lg_p, lg_gen):.4f}; max |logit| {float(lg_p.abs().max()):.2f}"
        f"; top1-top2 gap (generate) {_gap(lg_gen)}; argmax kernel "
        f"{lg_k.argmax(-1).tolist()} plain {lg_p.argmax(-1).tolist()} "
        f"generate {lg_gen.argmax(-1).tolist()} engine "
        f"{[r.tokens[0] for r in pair]}")
    toks = lg_k.argmax(-1).to(torch.int32)
    lengths = torch.as_tensor([r.n_prompt for r in pair], dtype=torch.int32,
                              device="cuda")
    lk = _decode_step_logits(eng, pool, pages, toks, lengths, True)
    lp = _decode_step_logits(eng, pool, pages, toks, lengths, False)
    err, scale = d(lk, lp), float(lp.abs().max())
    log(f"parity decode logits kernel vs plain: max abs diff {err:.4f}, "
        f"max |logit| {scale:.2f}, atol {LOGIT_ATOL}, argmax equal "
        f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}, top1-top2 gap "
        f"(plain) {_gap(lp)}")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        failures.append("non-finite decode logits")
    if not torch.allclose(lk, lp, atol=LOGIT_ATOL, rtol=0.0):
        failures.append(f"decode logits kernel vs plain: max abs diff "
                        f"{err} over atol {LOGIT_ATOL}")
    check(not failures, "; ".join(failures))


def profile_phase(params, rng) -> None:
    """A second serve run of the same shape under ``torch.profiler``:
    the device's busy share of the run's wall time and the kernels that
    take it.  It comes after every gate, so profiler overhead touches
    none of the gated numbers; it reports and gates nothing."""
    from torch.profiler import ProfilerActivity, profile
    eng = E.ServingEngine(params, CFG, **ENGINE)
    for _ in range(N_REQUESTS):
        n = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
        eng.submit(rng.integers(1, CFG.vocab_size, size=n).astype(np.int32),
                   max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    # device activity only: tracing every CPU operator as well doubles
    # the run's wall time and takes minutes to post-process
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(d for _, _, d in dev)
    if not dev:
        log("profile: torch.profiler recorded no device time (not "
            "measured)")
        return
    log(f"profile (serve run under torch.profiler): device busy "
        f"{busy_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall = "
        f"{busy_us / wall_us:.3f}; idle share {1 - busy_us / wall_us:.3f}")
    for key, count, d in sorted(dev, key=lambda e: -e[2])[:8]:
        log(f"profile: {d / busy_us:.3f} of device time, {count} calls, "
            f"{d / 1e3:.1f} ms: {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: the smoke runs on the card",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    t = time.perf_counter()
    loader.build_all()
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    for name, text in loader.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    try:
        kernels = kernel_phase(rng, gen)
        t = time.perf_counter()
        params = build_params()
        torch.cuda.synchronize()
        log(f"SMOLLM3_3B params built in {time.perf_counter() - t:.1f} s")
        eng, reqs, launches = serve_phase(params, rng, card)
        parity_phase(params, reqs, eng)
        profile_phase(params, rng)
    except SmokeFailure as e:
        print(f"[smoke] FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
