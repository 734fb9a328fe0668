"""Continuous-batching decode engine over the paged KV pool — the port of
the JAX package's ``serving/engine.py`` (single device, float pool).

Same layer math as ``models/generate.py``, different cache substrate and
driver:

**Parity with one-shot decode.**  Every per-row op (rms_norm,
projections, per-query-row attention, logits) is independent of which
other rows share its batch, and the engine's attention always contracts
over the FIXED pool view (``pages_per_request × page_size`` positions,
masked tails contributing exact zeros) — the extent ``generate`` pins
with ``cache_capacity``.  So with matched capacity a request's tokens
are ``generate``'s tokens for its prompt; the test suite asserts it per
request.

**Host blocks only at sync points.**  Decode bursts chain
``sync_every`` steps through :class:`..runtime.StepPump`'s bounded
in-flight dispatch; the host resolves tokens, retires finished requests
and admits new ones once per burst.  Prefill is synchronous at admission
(TTFT is stamped at first-token resolution) and chunked, so a long
prompt shares rounds with decode instead of stalling it.

Kernels: ``paged_kernel=True`` sends S == 1 decode attention to the
paged-decode CUDA kernel (``ops/paged_attention.py``), and
``flash_prefill=True`` sends batched chunked prefill to the flash-prefill
CUDA kernel (``ops/flash_prefill.py``); both read the pages in place
through the page table.  Without them attention gathers the slot's pages
into a contiguous view and runs the reference's einsums — the kernels'
plain versions, each counted in its kernel's ``COUNTS.plain_calls``.  On
CPU tensors the kernel entry points take those plain versions too.

What does not carry over from JAX: the reference's steps were jitted
with donated pool buffers and held a zero-retrace contract
(``recompiles_after_warmup`` in its SLO report).  PyTorch runs eagerly,
so there is nothing to retrace and the report leaves that key out; the
pool is updated in place where JAX donated and returned new buffers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import transformer as T
from ..models.generate import _decode_cfg
from ..ops.flash_prefill import paged_flash_prefill, paged_flash_prefill_plain
from ..ops.paged_attention import paged_attention_decode, paged_attention_plain
from ..runtime.pump import StepPump
from .accounting import serve_waterline_gb, tree_bytes
from .kv_pool import PagedKVPool, PoolBuffers
from .scheduler import DECODE, PREFILL, ContinuousBatcher, Request

__all__ = ["ServingEngine", "serve"]


# ---------------------------------------------------------------- layer math

def _ragged_rope_tables(positions, head_dim: int, theta: float):
    """Per-BATCH rope tables: ``positions`` (B, S) int → cos/sin
    (B, S, hd/2) f32, by ``transformer._rope_tables``' formula."""
    inv_freq = T._inv_freq(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def _apply_rope_ragged(x, cos, sin):
    """``transformer.apply_rope`` with per-batch tables: x (B, S, n, hd),
    cos/sin (B, S, hd/2)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def _paged_layer_body(x, layer, *, cfg, cos, sin, use_rope, pk, pv, pages,
                      apos, valid, paged_kernel=False, flash_prefill=False):
    """One decoder layer against the PAGED pool.  New K/V rows are
    written token by token into their page-table slots (rows with
    ``valid`` False divert to the null page 0); attention then reads the
    slot's pages — through a kernel, or by gathering them into the
    contiguous view whose position ``t`` is absolute position ``t``.

    x (B, S, H); pages (B, P) int32; apos (B, S) int32 absolute
    positions of x's rows; valid (B, S) bool."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    dense = T._dense(cfg)
    page = pk.shape[1]
    P = pages.shape[1]

    r = T.rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q = dense(r, layer["wq"]).reshape(B, S, nq, hd)
    k = dense(r, layer["wk"]).reshape(B, S, nkv, hd)
    v = dense(r, layer["wv"]).reshape(B, S, nkv, hd)
    if use_rope:
        q = _apply_rope_ragged(q, cos, sin)
        k = _apply_rope_ragged(k, cos, sin)

    # in-place write of the new rows (the reference donated the pool and
    # got a new one back); invalid rows all land on the null page, where
    # duplicate targets do not matter
    pi = (apos // page).clamp(0, P - 1).long()
    pg = torch.where(valid, torch.gather(pages, 1, pi), 0).long()
    off = (apos % page).long()
    pk[pg, off] = k
    pv[pg, off] = v

    qg = q.reshape(B, S, nkv, nq // nkv, hd)
    if S == 1:
        attend = paged_attention_decode if paged_kernel \
            else paged_attention_plain
    else:
        attend = paged_flash_prefill if flash_prefill \
            else paged_flash_prefill_plain
    attn = attend(qg, pk, pv, pages, apos)
    attn = attn.to(x.dtype).reshape(B, S, nq * hd)
    x = x + dense(attn, layer["wo"])
    r = T.rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    return x + T._mlp_block(r, layer, cfg=cfg)


def _paged_forward(params, ids, cfg, bufs: PoolBuffers, pages, apos, valid,
                   paged_kernel=False, flash_prefill=False):
    """ids (B, S) → hidden x (B, S, H), writing every layer's new K/V
    rows into ``bufs``."""
    x = params["embed"].to(cfg.dtype)[ids.long()]
    cos, sin = _ragged_rope_tables(apos, cfg.resolved_head_dim,
                                   cfg.rope_theta)
    for li, use_rope in enumerate(T.rope_flags(cfg)):
        x = _paged_layer_body(
            x, T.layer_params(params, li), cfg=cfg, cos=cos, sin=sin,
            use_rope=use_rope, pk=bufs.k[li], pv=bufs.v[li], pages=pages,
            apos=apos, valid=valid, paged_kernel=paged_kernel,
            flash_prefill=flash_prefill)
    return x


def _all_logits(params, x, cfg):
    """(B, S, H) hidden → (B, S, vocab) f32 logits."""
    x = T.rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x @ T._output_embedding(params, cfg).T).float()


def _last_logits(params, x_last, cfg):
    """(B, 1, H) hidden → (B, vocab) f32 logits."""
    return _all_logits(params, x_last, cfg)[:, 0]


@torch.no_grad()
def _decode_core(bufs, params, pages, toks, lengths, stop_at, active, *,
                 cfg, paged_kernel=False):
    """One fixed-shape decode step over every slot.  toks/lengths/
    stop_at (B,) int32, active (B,) bool.  Emits the next greedy token
    per ACTIVE slot (inactive slots freeze); a slot retires ON DEVICE
    when its length reaches ``stop_at``, so it can never write past its
    page grant mid-burst."""
    x = _paged_forward(params, toks[:, None], cfg, bufs, pages,
                       lengths[:, None], active[:, None],
                       paged_kernel=paged_kernel)
    logits = _last_logits(params, x[:, -1:], cfg)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt = torch.where(active, nxt, toks)
    new_len = lengths + active.to(torch.int32)
    new_active = active & (new_len < stop_at)
    return nxt, new_len, new_active, active.sum()


@torch.no_grad()
def _prefill_core(bufs, params, pages_row, ids, pos: int, plen: int, *,
                  cfg):
    """One prefill CHUNK for one request: ids (1, C) padded with zeros,
    ``pos`` the chunk start, ``plen`` the prompt length.  Rows past the
    prompt divert to the null page.  Returns the greedy token at the
    prompt's last position — meaningful on the final chunk only."""
    Ck = ids.shape[1]
    apos = pos + torch.arange(Ck, dtype=torch.int32,
                              device=ids.device)[None, :]
    x = _paged_forward(params, ids, cfg, bufs, pages_row, apos, apos < plen)
    last = min(max(plen - 1 - pos, 0), Ck - 1)
    logits = _last_logits(params, x[:, last:last + 1], cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def _prefill_batch_core(bufs, params, pages, ids, pos, plen, *, cfg,
                        flash_prefill=False):
    """One prefill chunk for a BATCH of requests: ids (Bp, C), pages
    (Bp, P), pos/plen (Bp,) int32.  Pad rows carry ``plen == 0``: every
    position is invalid and their token is never read.  Returns each
    row's greedy token at its final prompt position."""
    Bp, Ck = ids.shape
    apos = pos[:, None] + torch.arange(Ck, dtype=torch.int32,
                                       device=ids.device)[None, :]
    x = _paged_forward(params, ids, cfg, bufs, pages, apos,
                       apos < plen[:, None], flash_prefill=flash_prefill)
    last = (plen - 1 - pos).clamp(0, Ck - 1).long()
    xl = x[torch.arange(Bp, device=x.device), last][:, None]
    logits = _last_logits(params, xl, cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


# ------------------------------------------------------------------- engine

class ServingEngine:
    """Continuous-batching server over the paged pool.

    ``submit()`` requests (with optional virtual ``arrival_s`` offsets),
    then ``run()`` drives the round loop to completion and returns the
    finished :class:`.scheduler.Request` records; ``slo_report()``
    aggregates them into TTFT / per-token percentiles and throughput.
    Runs on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``)."""

    def __init__(self, params, cfg, *, max_batch: int = 4,
                 page_size: int = 8, max_seq_len: int = 64,
                 n_pages: int | None = None, prefill_chunk: int = 16,
                 prefill_chunks_per_round: int = 2, sync_every: int = 4,
                 max_in_flight: int = 8, paged_kernel: bool = False,
                 flash_prefill: bool = False, device=None):
        self.device = resolve_device(device)
        self.cfg = _decode_cfg(cfg)
        T.check_supported(self.cfg)
        self.max_batch = int(max_batch)
        self.page_size = int(page_size)
        self.pages_per_request = -(-int(max_seq_len) // self.page_size)
        # the fixed contraction extent: generate()'s cache_capacity for
        # a token-for-token comparison
        self.view_capacity = self.pages_per_request * self.page_size
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_chunks_per_round = int(prefill_chunks_per_round)
        self.sync_every = max(int(sync_every), 1)
        self.max_in_flight = int(max_in_flight)
        self.paged_kernel = bool(paged_kernel)
        self.flash_prefill = bool(flash_prefill)

        if n_pages is None:
            n_pages = self.max_batch * self.pages_per_request + 1
        if n_pages < self.pages_per_request + 1:
            raise ValueError(
                f"pool of {n_pages} pages cannot hold one request "
                f"({self.pages_per_request} pages + null); shrink "
                f"max_seq_len")
        self.n_pages = int(n_pages)
        self._params = _to_device(params, self.device)
        self.pool = PagedKVPool(self.cfg, self.n_pages, self.page_size,
                                device=self.device)
        self._mem_prediction_gb = serve_waterline_gb(
            self.cfg, self.n_pages, self.page_size,
            weight_bytes=tree_bytes(self._params))

        B, P = self.max_batch, self.pages_per_request
        self._h_tokens = np.zeros(B, np.int32)
        self._h_lengths = np.zeros(B, np.int32)
        self._h_stop = np.zeros(B, np.int32)
        self._h_active = np.zeros(B, np.bool_)
        self._h_pages = np.zeros((B, P), np.int32)

        self.batcher = ContinuousBatcher(self.max_batch,
                                         self.pool.allocator,
                                         self.page_size)
        self._pending: list[Request] = []
        self.completed: list[Request] = []
        self._rid = 0
        self._pump = None
        self._t0: float | None = None
        self.stats = {"rounds": 0, "decode_steps": 0, "prefill_chunks": 0,
                      "admit_s": 0.0, "bookkeep_s": 0.0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "occupancy_sum": 0, "peak_pool_util": 0.0,
                      "wall_s": 0.0, "host_sync_count": 0}

    # ---- request intake ----------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               arrival_s: float | None = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1 or max_new_tokens < 1:
            raise ValueError("need >= 1 prompt token and >= 1 new token")
        if prompt.size + max_new_tokens > self.view_capacity:
            raise ValueError(
                f"prompt {prompt.size} + new {max_new_tokens} exceeds "
                f"the engine's view capacity {self.view_capacity} "
                f"(raise max_seq_len)")
        req = Request(rid=self._rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      arrival_s=(None if arrival_s is None
                                 else float(arrival_s)))
        self._rid += 1
        self._pending.append(req)
        return req

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ---- prefill ------------------------------------------------------
    def _prefill_one_chunk(self, req: Request, t0: float) -> None:
        Ck = self.prefill_chunk
        pos = req.prefill_pos
        chunk = req.prompt[pos:pos + Ck]
        ids = np.zeros((1, Ck), np.int32)
        ids[0, :chunk.shape[0]] = chunk
        row = np.zeros((1, self.pages_per_request), np.int32)
        row[0, :len(req.pages)] = req.pages
        t_chunk = time.perf_counter()
        tok_d = _prefill_core(self.pool.bufs, self._params, self._put(row),
                              self._put(ids), pos, req.n_prompt,
                              cfg=self.cfg)
        req.prefill_pos = min(pos + Ck, req.n_prompt)
        self.stats["prefill_chunks"] += 1
        if req.prefill_pos < req.n_prompt:
            self.stats["prefill_s"] += time.perf_counter() - t_chunk
            return
        first = int(tok_d.cpu()[0])     # sync: TTFT resolution
        self.stats["host_sync_count"] += 1
        self._finish_prefill(req, first, t0)
        self.stats["prefill_s"] += time.perf_counter() - t_chunk

    def _finish_prefill(self, req: Request, first: int, t0: float) -> None:
        """Final-chunk bookkeeping: stamp TTFT and flip the slot into
        DECODE (or retire it when ``max_new == 1``)."""
        now = time.perf_counter() - t0
        req.tokens.append(first)
        req.t_first = now
        b = req.slot
        stop = req.n_prompt + req.max_new_tokens - 1
        req.state = DECODE
        if req.n_prompt >= stop:      # max_new == 1: done at prefill
            self.batcher.retire(req, now)
            self.completed.append(req)
            self._h_active[b] = False
            self._h_pages[b] = 0
            return
        self._h_tokens[b] = first
        self._h_lengths[b] = req.n_prompt
        self._h_stop[b] = stop
        self._h_active[b] = True

    def _prefill_batch_chunk(self, reqs: list[Request], t0: float) -> None:
        """One BATCHED prefill chunk: every PREFILL resident advances one
        chunk through a single (max_batch, C) step; requests whose final
        chunk this is resolve their first token in ONE host sync."""
        B, Ck = self.max_batch, self.prefill_chunk
        ids = np.zeros((B, Ck), np.int32)
        pages = np.zeros((B, self.pages_per_request), np.int32)
        pos = np.zeros(B, np.int32)
        plen = np.zeros(B, np.int32)
        for i, req in enumerate(reqs):
            chunk = req.prompt[req.prefill_pos:req.prefill_pos + Ck]
            ids[i, :chunk.shape[0]] = chunk
            pages[i, :len(req.pages)] = req.pages
            pos[i] = req.prefill_pos
            plen[i] = req.n_prompt
        t_chunk = time.perf_counter()
        tok_d = _prefill_batch_core(
            self.pool.bufs, self._params, self._put(pages), self._put(ids),
            self._put(pos), self._put(plen), cfg=self.cfg,
            flash_prefill=self.flash_prefill)
        self.stats["prefill_chunks"] += 1
        finishing = []
        for i, req in enumerate(reqs):
            req.prefill_pos = min(req.prefill_pos + Ck, req.n_prompt)
            if req.prefill_pos >= req.n_prompt:
                finishing.append((i, req))
        if finishing:
            toks = tok_d.cpu().numpy()   # sync: TTFT resolution for all
            self.stats["host_sync_count"] += 1
            for i, req in finishing:
                self._finish_prefill(req, int(toks[i]), t0)
        self.stats["prefill_s"] += time.perf_counter() - t_chunk

    # ---- decode -------------------------------------------------------
    def _decode_burst(self, pump: StepPump, t0: float) -> None:
        sync = self.sync_every
        L0 = self._h_lengths.copy()
        A0 = self._h_active.copy()
        toks_d = self._put(self._h_tokens)
        len_d = self._put(self._h_lengths)
        stop_d = self._put(self._h_stop)
        act_d = self._put(self._h_active)
        pages_d = self._put(self._h_pages)
        t_burst = time.perf_counter()
        step_tokens = []
        for _ in range(sync):
            toks_d, len_d, act_d, occ = _decode_core(
                self.pool.bufs, self._params, pages_d, toks_d, len_d,
                stop_d, act_d, cfg=self.cfg, paged_kernel=self.paged_kernel)
            pump.emit(occ)
            step_tokens.append(toks_d)
        self.stats["decode_steps"] += sync
        # sync point: resolve the burst's tokens and replay the device's
        # deterministic active chain on the host
        mats = torch.stack(step_tokens).cpu().numpy()
        self.stats["host_sync_count"] += 1
        self.stats["decode_s"] += time.perf_counter() - t_burst
        t_book = time.perf_counter()
        active, lengths = A0.copy(), L0.copy()
        for j in range(sync):
            for b in np.nonzero(active)[0]:
                self.batcher.slot_request(int(b)).tokens.append(
                    int(mats[j][b]))
            lengths = lengths + active
            active = active & (lengths < self._h_stop)
        self._h_tokens = mats[-1].copy()
        self._h_lengths = lengths.astype(np.int32)
        self._h_active = active
        now = time.perf_counter() - t0
        for b in range(self.max_batch):
            req = self.batcher.slot_request(b)
            if req is not None and req.state == DECODE and not active[b]:
                self.batcher.retire(req, now)
                self._h_pages[b] = 0     # slot back to the null page
                self.completed.append(req)
        self.stats["bookkeep_s"] += time.perf_counter() - t_book

    # ---- round loop ---------------------------------------------------
    def start(self) -> None:
        """Arm the engine clock and the pump."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        if self._pump is None:
            self._pump = StepPump(sync_every=self.sync_every,
                                  max_in_flight=self.max_in_flight)

    def close_pump(self) -> None:
        """Drain and drop the pump."""
        if self._pump is not None:
            pump, self._pump = self._pump, None
            pump.close()
            self.stats["host_sync_count"] += pump.host_sync_count

    def step_round(self, now: float) -> list[Request]:
        """One scheduler round at elapsed time ``now``: admit, run up to
        ``prefill_chunks_per_round`` prefill chunks, then one decode
        burst if any slot is active.  Returns the requests that finished
        this round."""
        self.start()
        t0 = self._t0
        done_base = len(self.completed)
        t_admit = time.perf_counter()
        for req in self.batcher.admit(now):
            self._h_pages[req.slot] = 0
            self._h_pages[req.slot, :len(req.pages)] = req.pages
        self.stats["admit_s"] += time.perf_counter() - t_admit
        for _ in range(self.prefill_chunks_per_round):
            if self.flash_prefill:
                # batched multi-request prefill: every PREFILL resident
                # advances together
                reqs = sorted((r for r in self.batcher.slots
                               if r is not None and r.state == PREFILL),
                              key=lambda r: r.t_admit)
                if not reqs:
                    break
                self._prefill_batch_chunk(reqs, t0)
            else:
                req = self.batcher.next_prefill()
                if req is None:
                    break
                self._prefill_one_chunk(req, t0)
        if self._h_active.any():
            self._decode_burst(self._pump, t0)
        self.stats["rounds"] += 1
        self.stats["occupancy_sum"] += int(self._h_active.sum())
        self.stats["peak_pool_util"] = max(self.stats["peak_pool_util"],
                                           self.pool.utilization)
        return self.completed[done_base:]

    def run(self) -> list[Request]:
        def vt(r):
            return r.arrival_s if r.arrival_s is not None else 0.0

        pending = sorted(self._pending, key=vt)
        self._pending = []
        self.start()
        t0 = self._t0
        base = len(self.completed)
        try:
            while pending or self.batcher.has_work():
                now = time.perf_counter() - t0
                while pending and vt(pending[0]) <= now:
                    self.batcher.submit(pending.pop(0), now)
                if not self.batcher.has_work():
                    # idle until the next virtual arrival
                    time.sleep(min(max(vt(pending[0]) - now, 0.0), 0.05))
                    continue
                self.step_round(now)
        finally:
            self.close_pump()
        self.stats["wall_s"] += time.perf_counter() - t0
        return self.completed[base:]

    # ---- reporting ----------------------------------------------------
    def slo_report(self) -> dict:
        """TTFT / per-token percentiles + throughput + pool/scheduler
        health for the finished requests.  Times are host-clock seconds
        around work that ends in a host sync."""
        done = [r for r in self.completed if r.t_done is not None]
        ttft = np.array([r.ttft_s for r in done
                         if r.ttft_s is not None]) * 1e3
        ptl = np.array([r.per_token_s for r in done
                        if r.per_token_s is not None]) * 1e3

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else None

        toks = int(sum(len(r.tokens) for r in done))
        wall = self.stats["wall_s"] or 1e-9
        dec_toks = max(toks - len(done), 1)
        return {
            "requests": self.batcher.admitted_total,
            "completed": len(done),
            "ttft_ms": {"p50": pct(ttft, 50), "p99": pct(ttft, 99),
                        "mean": float(ttft.mean()) if ttft.size else None},
            "per_token_ms": {"p50": pct(ptl, 50), "p99": pct(ptl, 99)},
            "tokens_total": toks,
            "tokens_per_s": toks / wall,
            "device": str(self.device),
            "pool": {"n_pages": self.n_pages, "page_size": self.page_size,
                     "peak_util": self.stats["peak_pool_util"],
                     "predicted_gb": self._mem_prediction_gb},
            "scheduler": {
                "rounds": self.stats["rounds"],
                "decode_steps": self.stats["decode_steps"],
                "prefill_chunks": self.stats["prefill_chunks"],
                "admit_ms_total": 1e3 * self.stats["admit_s"],
                "bookkeep_ms_total": 1e3 * self.stats["bookkeep_s"],
                "prefill_ms_total": 1e3 * self.stats["prefill_s"],
                "decode_ms_total": 1e3 * self.stats["decode_s"],
                "mean_occupancy": (self.stats["occupancy_sum"]
                                   / max(self.stats["rounds"], 1)),
                "host_syncs": self.stats["host_sync_count"],
                "decode_steps_per_token": (self.stats["decode_steps"]
                                           / dec_toks),
            },
            "paged_kernel": self.paged_kernel,
            "flash_prefill": self.flash_prefill,
        }


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    return params.to(device)


def serve(params, cfg, prompts, *, max_new_tokens: int = 16,
          **engine_kwargs) -> list[np.ndarray]:
    """One-call convenience: build an engine, run every prompt to
    completion, return each continuation as an int32 array (in prompt
    order)."""
    eng = ServingEngine(params, cfg, **engine_kwargs)
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    eng.run()
    return [np.asarray(r.tokens, np.int32) for r in reqs]
