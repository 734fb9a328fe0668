"""Continuous-batching decode engine over the paged KV pool — the port of
the JAX package's ``serving/engine.py``: float or int8 pool, the radix
prefix cache and speculative decoding, on one device, over a
tensor-parallel group, or with prefill and decode disaggregated.

Same layer math as ``models/generate.py``, different cache substrate and
driver:

**Parity with one-shot decode.**  Every per-row op (rms_norm,
projections, per-query-row attention, logits) is independent of which
other rows share its batch, and the engine's attention always contracts
over the FIXED pool view (``pages_per_request × page_size`` positions,
masked tails contributing exact zeros) — the extent ``generate`` pins
with ``cache_capacity``.  So with matched capacity a request's tokens
are ``generate``'s tokens for its prompt; the test suite asserts it per
request, with the prefix cache and speculation on too.

**Host blocks only at sync points.**  Decode bursts chain
``sync_every`` steps through :class:`..runtime.StepPump`'s bounded
in-flight dispatch; the host resolves tokens, retires finished requests
and admits new ones once per burst.  Prefill is synchronous at admission
(TTFT is stamped at first-token resolution) and chunked, so a long
prompt shares rounds with decode instead of stalling it.

**The decode-speed frontier.**  ``prefix_cache=True`` keeps committed
full prompt pages in a radix trie (``kv_pool.RadixPrefixCache``):
admission aliases a request's longest cached page prefix and prefill
starts at its boundary, so aliased pages are never written.
``spec_k=k`` decodes speculatively: a draft model (``draft_params`` /
``draft_cfg``, or the target's first ``draft_layers`` layers) proposes
``k`` tokens per slot with its own pool addressed by the target's page
tables, one ``(B, k+1)`` target verify scores them, and a device-side
accept keeps the longest verified prefix — the whole macro-step chain
dispatches without a host sync.  At temperature 0 the emitted stream is
the target's greedy stream whatever the draft proposes.

Kernels: ``paged_kernel=True`` sends S == 1 decode attention (and every
draft decode step) to the paged-decode CUDA kernel
(``ops/paged_attention.py``), and ``flash_prefill=True`` sends batched
chunked prefill, the draft's too, and the speculative verify's
``(B, k+1)`` block to the flash-prefill CUDA kernel
(``ops/flash_prefill.py``); both read the pages in place through the
page table.  Without them attention gathers the slot's pages into a
contiguous view and runs the reference's einsums — the kernels' plain
versions, each counted in its kernel's ``COUNTS.plain_calls``.  (The
reference's verify always took its gather path, whose counterpart here
is K3's plain version; the port's verify follows ``flash_prefill`` as
its prefill does.)  On CPU tensors the kernel entry points take those
plain versions too.

``kv_quant=True`` stores the pool int8 with per-row scales: new K/V rows
are quantised as they are written, and decode attention (S == 1) runs
the int8 core — through K2 under ``paged_kernel``, else its plain
version.  Prefill and the verify (S > 1) on an int8 pool take the
gather path, which has no kernel (the reference refuses ``kv_quant``
with ``flash_prefill``, and so does this engine).  Params from
``models.generate.quantize_decode_params`` serve int8 weights: every
projection and the unembedding go through ``prequantized_dense`` (K4 on
the card).

**Modes.**  ``mesh`` (a ``utils.mesh.grid_axes`` dict) and ``tp_axis``
(the name of its tensor-parallel axis) serve tensor-parallel: one
process a rank, each rank's engine holding its Megatron shards
(``parallel.tensor.shard_tree_tp``) and a pool of its ``n_kv / tp``
local heads, the layer body's two rejoins ``all_reduce``d over the axis
(the ``serve_decode`` contract: 2 a layer a step); every rank makes the
same host decisions.  ``disaggregate=True`` prefills on one device's
params and pool and decodes on another's (``device=(prefill, decode)``;
by default ``cuda:0`` and ``cuda:1``): after a request's last prefill
chunk its prompt pages' rows, an int8 pool's scales with them, are
copied into its decode pages (:meth:`ServingEngine._handoff`).  A pair
naming one device twice still copies between two pools.  ``watchdog``
(a ``resilience.elastic.Watchdog``) guards every decode burst's sync
point and the pump's, so a wedged burst raises ``StepTimeoutError`` for
the fleet's failover instead of hanging.

What does not carry over from JAX: the reference's steps were jitted
with donated pool buffers and held a zero-retrace contract
(``recompiles_after_warmup`` in its SLO report).  PyTorch runs eagerly,
so there is nothing to retrace and the report leaves that key out; the
pool is updated in place where JAX donated and returned new buffers.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import transformer as T
from ..models.generate import _decode_cfg, _quant_kv, _unembed
from ..ops import collectives as C
from ..ops.flash_prefill import paged_flash_prefill, paged_flash_prefill_plain
from ..ops.paged_attention import (gather_attention_q8, paged_attention_decode,
                                   paged_attention_plain,
                                   paged_attention_plain_q8)
from ..ops.quant import QuantizedWeight
from ..parallel.tensor import check_tp_divisibility, shard_tree_tp
from ..runtime.pump import StepPump
from ..telemetry.metrics import maybe_inc
from ..utils import mesh as M
from .accounting import pool_capacity_pages, serve_waterline_gb, tree_bytes
from .kv_pool import PagedKVPool, PoolBuffers, RadixPrefixCache
from .scheduler import DECODE, PREFILL, ContinuousBatcher, Request

__all__ = ["ServingEngine", "serve", "make_draft_params"]


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
                      apos, valid, paged_kernel=False, flash_prefill=False,
                      pk_s=None, pv_s=None, tp_axis=None):
    """One decoder layer against the PAGED pool.  New K/V rows are
    written token by token into their page-table slots (rows with
    ``valid`` False divert to the null page 0); attention then reads the
    slot's pages — through a kernel, or by gathering them into the
    contiguous view whose position ``t`` is absolute position ``t``.
    An int8 pool (``pk.dtype == int8``) comes with its row scales
    ``pk_s``/``pv_s``.  ``tp_axis``: ``layer`` holds this rank's
    Megatron shards and the pool its ``n_kv / tp`` local heads; the
    attention output and the MLP's are partial sums, each rejoined with
    one ``all_reduce`` over the axis.

    x (B, S, H); pages (B, P) int32; apos (B, S) int32 absolute
    positions of x's rows; valid (B, S) bool."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    tp = M.axis_size(tp_axis) if tp_axis is not None else 1
    nq, nkv = cfg.num_attention_heads // tp, cfg.num_key_value_heads // tp
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
    qg = q.reshape(B, S, nkv, nq // nkv, hd)
    if pk.dtype == torch.int8:
        # int8 rows with their scales; int8 prefill has no kernel
        kq, ks_new = _quant_kv(k)
        vq, vs_new = _quant_kv(v)
        pk[pg, off] = kq
        pv[pg, off] = vq
        pk_s[pg, off] = ks_new
        pv_s[pg, off] = vs_new
        qq, q_s = _quant_kv(qg)
        if S > 1:
            attn = gather_attention_q8(qq, q_s, pk, pv, pk_s, pv_s, pages,
                                       apos)
        elif paged_kernel:
            attn = paged_attention_decode(qq, pk, pv, pages, apos,
                                          q_scale=q_s, pk_s=pk_s, pv_s=pv_s)
        else:
            attn = paged_attention_plain_q8(qq, q_s, pk, pv, pk_s, pv_s,
                                            pages, apos)
    else:
        pk[pg, off] = k
        pv[pg, off] = v
        if S == 1:
            attend = paged_attention_decode if paged_kernel \
                else paged_attention_plain
        else:
            attend = paged_flash_prefill if flash_prefill \
                else paged_flash_prefill_plain
        attn = attend(qg, pk, pv, pages, apos)
    attn = attn.to(x.dtype).reshape(B, S, nq * hd)
    attn_out = dense(attn, layer["wo"])
    if tp_axis is not None:
        attn_out = C.all_reduce(attn_out, tp_axis)
    x = x + attn_out
    r = T.rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    mlp, _ = T._mlp_block(r, layer, cfg=cfg)
    if tp_axis is not None:
        mlp = C.all_reduce(mlp, tp_axis)
    return x + mlp


def _paged_forward(params, ids, cfg, bufs: PoolBuffers, pages, apos, valid,
                   paged_kernel=False, flash_prefill=False, tp_axis=None):
    """ids (B, S) → hidden x (B, S, H), writing every layer's new K/V
    rows into ``bufs``."""
    x = params["embed"].to(cfg.dtype)[ids.long()]
    cos, sin = _ragged_rope_tables(apos, cfg.resolved_head_dim,
                                   cfg.rope_theta)
    q8 = bufs.k_scale is not None
    for li, use_rope in enumerate(T.rope_flags(cfg)):
        x = _paged_layer_body(
            x, T.layer_params(params, li), cfg=cfg, cos=cos, sin=sin,
            use_rope=use_rope, pk=bufs.k[li], pv=bufs.v[li], pages=pages,
            apos=apos, valid=valid, paged_kernel=paged_kernel,
            flash_prefill=flash_prefill,
            pk_s=bufs.k_scale[li] if q8 else None,
            pv_s=bufs.v_scale[li] if q8 else None, tp_axis=tp_axis)
    return x


def _last_logits(params, x_last, cfg):
    """(B, 1, H) hidden → (B, vocab) f32 logits: ``generate``'s tail
    (the int8 unembedding ``unembed_q`` when the params carry one)."""
    return _unembed(params, x_last, cfg)[:, 0]


@torch.no_grad()
def _decode_core(bufs, params, pages, toks, lengths, stop_at, active, *,
                 cfg, paged_kernel=False, tp_axis=None):
    """One fixed-shape decode step over every slot.  toks/lengths/
    stop_at (B,) int32, active (B,) bool.  Emits the next greedy token
    per ACTIVE slot (inactive slots freeze); a slot retires ON DEVICE
    when its length reaches ``stop_at``, so it can never write past its
    page grant mid-burst."""
    x = _paged_forward(params, toks[:, None], cfg, bufs, pages,
                       lengths[:, None], active[:, None],
                       paged_kernel=paged_kernel, tp_axis=tp_axis)
    logits = _last_logits(params, x[:, -1:], cfg)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    nxt = torch.where(active, nxt, toks)
    new_len = lengths + active.to(torch.int32)
    new_active = active & (new_len < stop_at)
    return nxt, new_len, new_active, active.sum()


@torch.no_grad()
def _prefill_core(bufs, params, pages_row, ids, pos: int, plen: int, *,
                  cfg, tp_axis=None):
    """One prefill CHUNK for one request: ids (1, C) padded with zeros,
    ``pos`` the chunk start, ``plen`` the prompt length.  Rows past the
    prompt divert to the null page.  Returns the greedy token at the
    prompt's last position — meaningful on the final chunk only."""
    Ck = ids.shape[1]
    apos = pos + torch.arange(Ck, dtype=torch.int32,
                              device=ids.device)[None, :]
    x = _paged_forward(params, ids, cfg, bufs, pages_row, apos, apos < plen,
                       tp_axis=tp_axis)
    last = min(max(plen - 1 - pos, 0), Ck - 1)
    logits = _last_logits(params, x[:, last:last + 1], cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def _prefill_batch_core(bufs, params, pages, ids, pos, plen, *, cfg,
                        flash_prefill=False, tp_axis=None):
    """One prefill chunk for a BATCH of requests: ids (Bp, C), pages
    (Bp, P), pos/plen (Bp,) int32.  Pad rows carry ``plen == 0``: every
    position is invalid and their token is never read.  Returns each
    row's greedy token at its final prompt position."""
    Bp, Ck = ids.shape
    apos = pos[:, None] + torch.arange(Ck, dtype=torch.int32,
                                       device=ids.device)[None, :]
    x = _paged_forward(params, ids, cfg, bufs, pages, apos,
                       apos < plen[:, None], flash_prefill=flash_prefill,
                       tp_axis=tp_axis)
    last = (plen - 1 - pos).clamp(0, Ck - 1).long()
    xl = x[torch.arange(Bp, device=x.device), last][:, None]
    logits = _last_logits(params, xl, cfg)
    return torch.argmax(logits, dim=-1).to(torch.int32)


@torch.no_grad()
def _spec_verify_core(bufs, params, pages, toks_blk, lengths, stop_at,
                      active, *, cfg, flash_prefill=False, tp_axis=None):
    """The speculative VERIFY step: one fixed-shape target forward over a
    (B, k+1) token block per slot — the last accepted token plus the
    draft's k proposals.  Row ``i`` writes its K/V at ``lengths + i``
    (the write precedes the attention in every layer, so each row
    attends over exactly the committed prefix plus proposal rows ``<=
    i``, the visible set a sequential greedy decode would see).  Rows at
    positions ``>= stop_at`` divert to the null page, so the device never
    writes past a request's page grant.  Returns each row's greedy
    argmax (B, k+1) int32 and the occupancy, both on the device."""
    B, S = toks_blk.shape
    ar = torch.arange(S, dtype=torch.int32, device=toks_blk.device)
    apos = lengths[:, None] + ar[None, :]
    valid = active[:, None] & (apos < stop_at[:, None])
    x = _paged_forward(params, toks_blk, cfg, bufs, pages, apos, valid,
                       flash_prefill=flash_prefill, tp_axis=tp_axis)
    greedy = torch.argmax(_unembed(params, x, cfg),
                          dim=-1).to(torch.int32)
    return greedy, active.sum()


@torch.no_grad()
def _spec_accept_core(toks_blk, greedy, toks, lengths, stop_at, active):
    """Device-side acceptance: the longest verified prefix per slot.
    Proposal ``toks_blk[:, i+1]`` is accepted iff it equals the target's
    greedy continuation ``greedy[:, i]`` and every earlier proposal
    matched, so the emitted stream ``greedy[:, :e]`` is what sequential
    greedy decode would emit (the rejected tail's pool rows sit past the
    committed length, masked, and the next macro-step overwrites them).
    ``e`` is capped at ``stop_at - lengths``; inactive slots freeze with
    e = 0.  Returns (next token, new lengths, new active, e)."""
    k = toks_blk.shape[1] - 1
    match = (toks_blk[:, 1:] == greedy[:, :-1]).to(torch.int32)
    e = 1 + torch.cumprod(match, dim=1).sum(dim=1)
    e = torch.minimum(e, stop_at - lengths)
    e = torch.where(active, e, torch.zeros_like(e)).to(torch.int32)
    new_len = lengths + e
    new_active = active & (new_len < stop_at)
    idx = (e - 1).clamp(0, k).long()
    nxt = torch.gather(greedy, 1, idx[:, None])[:, 0]
    nxt = torch.where(active, nxt, toks).to(torch.int32)
    return nxt, new_len, new_active, e


def make_draft_params(params, cfg, n_layers: int):
    """A truncated-target draft: the target's first ``n_layers`` decoder
    layers with the embedding, final norm and unembedding kept.  The
    layer leaves are views of the target's storage (a ``QuantizedWeight``
    leaf is sliced field by field, as ``transformer.layer_params`` does:
    slicing the NamedTuple itself would pick its fields).  Parity never
    depends on the draft: at temperature 0 any draft yields the target's
    greedy stream, a poor one only lowers the acceptance rate.  Returns
    ``(draft_params, draft_cfg)``."""
    n = int(n_layers)
    if not 1 <= n <= cfg.num_hidden_layers:
        raise ValueError(f"draft of {n_layers} layers from a "
                         f"{cfg.num_hidden_layers}-layer target")
    draft = dict(params)
    draft["layers"] = {
        k: (QuantizedWeight(v.q[:n], v.s[:n])
            if isinstance(v, QuantizedWeight) else v[:n])
        for k, v in params["layers"].items()}
    return draft, dataclasses.replace(cfg, num_hidden_layers=n)


# ------------------------------------------------------------------- engine

class ServingEngine:
    """Continuous-batching server over the paged pool.

    ``submit()`` requests (with optional virtual ``arrival_s`` offsets),
    then ``run()`` drives the round loop to completion and returns the
    finished :class:`.scheduler.Request` records; ``slo_report()``
    aggregates them into TTFT / per-token percentiles and throughput.
    Runs on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``); under ``mesh`` on the rank's device (its process
    group's: ``cuda:LOCAL_RANK`` over NCCL, the CPU over gloo); with
    ``disaggregate`` on the ``(prefill, decode)`` pair.  ``watchdog``:
    a ``resilience.elastic.Watchdog`` around every burst's sync point.
    ``telem``: a ``telemetry.TelemetryRun`` that the rounds stream into
    (prefill events carry each request's TTFT, decode bursts the
    occupancy and pool gauges and the latency of the requests they
    complete; ``serve/*`` spans)."""

    def __init__(self, params, cfg, *, mesh=None, tp_axis: str = "tp",
                 max_batch: int = 4, page_size: int = 8,
                 max_seq_len: int = 64, n_pages: int | None = None,
                 prefill_chunk: int = 16,
                 prefill_chunks_per_round: int = 2, sync_every: int = 4,
                 max_in_flight: int = 8, kv_quant: bool = False,
                 paged_kernel: bool = False, prefix_cache: bool = False,
                 spec_k: int = 0, draft_params=None, draft_cfg=None,
                 draft_layers: int | None = None,
                 flash_prefill: bool = False,
                 hbm_budget_gb: float | None = None,
                 disaggregate: bool = False, device=None, watchdog=None,
                 telem=None):
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
        self.kv_quant = bool(kv_quant)
        self.paged_kernel = bool(paged_kernel)
        self.flash_prefill = bool(flash_prefill)
        self.spec_k = int(spec_k)
        if self.flash_prefill and self.kv_quant:
            raise ValueError("the flash prefill kernel is float-only — "
                             "drop kv_quant or flash_prefill")
        if prefix_cache and disaggregate:
            raise ValueError(
                "prefix_cache aliases decode-pool pages across "
                "requests; the disaggregated handoff injects full page "
                "rows and would overwrite shared pages — not wired")
        if self.spec_k and disaggregate:
            raise ValueError("speculative decoding needs a resident "
                             "draft pool; the disaggregated handoff is "
                             "not wired for it")
        if self.spec_k:
            if draft_params is None and draft_layers is None:
                raise ValueError(
                    "spec_k > 0 needs draft_params + draft_cfg, or "
                    "draft_layers to truncate the target")
            if draft_params is not None and draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
        self.telem = telem
        # fleet replica index, stamped into this engine's serve spans
        self.replica = None
        self.disaggregate = bool(disaggregate)
        self.watchdog = watchdog

        self.mesh = mesh
        self.tp_axis = None
        tp = 1
        if mesh is not None:
            if device is not None:
                raise ValueError("pass mesh or device, not both")
            if disaggregate:
                raise ValueError("disaggregate splits devices into "
                                 "single-program slices; pass mesh=None")
            self.tp_axis = mesh[tp_axis]
            tp = M.axis_size(self.tp_axis)
            check_tp_divisibility(self.cfg, tp)
            if "unembed_q" in params:
                raise ValueError("tensor-parallel serving takes bf16 "
                                 "params (int8 weight sharding is not "
                                 "wired)")
        self.tp = tp
        self._prefill_dev, self._decode_dev = self._placement(device)
        self.device = self._decode_dev

        self._params, self._params_pre = self._place(params)
        self.draft_cfg = self._draft_params = None
        if self.spec_k:
            if draft_params is None:
                # truncated from the target on the device: views of its
                # storage (of this rank's shards under tp)
                draft_params, draft_cfg = make_draft_params(
                    self._params, self.cfg, draft_layers)
                self._draft_params = draft_params
            else:
                if self.tp_axis is not None:
                    check_tp_divisibility(_decode_cfg(draft_cfg), tp)
                self._draft_params = self._place(draft_params)[0]
            self.draft_cfg = _decode_cfg(draft_cfg)
            T.check_supported(self.draft_cfg)
        # the draft's weights are priced as resident, as the reference
        # prices them, even where they are views of the target's
        wb = tree_bytes(self._params)
        dwb = tree_bytes(self._draft_params) if self.spec_k else 0
        if n_pages is None:
            n_pages = self.max_batch * self.pages_per_request + 1
            if hbm_budget_gb is not None:
                fit = pool_capacity_pages(
                    self.cfg, self.page_size, budget_gb=hbm_budget_gb,
                    weight_bytes=wb, kv_quant=self.kv_quant, tp=tp,
                    draft_weight_bytes=dwb, draft_cfg=self.draft_cfg) + 1
                n_pages = min(n_pages, fit)
        if n_pages < self.pages_per_request + 1:
            raise ValueError(
                f"pool of {n_pages} pages cannot hold one request "
                f"({self.pages_per_request} pages + null); raise the "
                f"HBM budget or shrink max_seq_len")
        self.n_pages = int(n_pages)
        self.pool = PagedKVPool(self.cfg, self.n_pages, self.page_size,
                                kv_quant=self.kv_quant, device=self.device,
                                tp=tp)
        # the draft's own pool, addressed by the SAME page tables as the
        # target's (no second allocator): a request's draft KV at
        # position p lives at the same (page, offset) as its target KV,
        # so admission, retirement and prefix aliasing are shared and a
        # cached page's draft rows stay valid as long as the page does
        self.draft_pool = None
        if self.spec_k:
            self.draft_pool = PagedKVPool(
                self.draft_cfg, self.n_pages, self.page_size,
                kv_quant=self.kv_quant, device=self.device, tp=tp)
        # disaggregated: the prefill device's own pool, sized like the
        # decode pool, and each prefilling request's pages in it
        self.pool_pre = None
        self._pre_pages: dict[int, list[int]] = {}
        if self.disaggregate:
            self.pool_pre = PagedKVPool(
                self.cfg, self.n_pages, self.page_size,
                kv_quant=self.kv_quant, device=self._prefill_dev)
        self._mem_prediction_gb = serve_waterline_gb(
            self.cfg, self.n_pages, self.page_size, weight_bytes=wb,
            kv_quant=self.kv_quant, tp=tp, draft_weight_bytes=dwb,
            draft_cfg=self.draft_cfg)

        B, P = self.max_batch, self.pages_per_request
        self._h_tokens = np.zeros(B, np.int32)
        self._h_lengths = np.zeros(B, np.int32)
        self._h_stop = np.zeros(B, np.int32)
        self._h_active = np.zeros(B, np.bool_)
        self._h_pages = np.zeros((B, P), np.int32)

        self.batcher = ContinuousBatcher(self.max_batch,
                                         self.pool.allocator,
                                         self.page_size)
        self.batcher.metrics = getattr(telem, "metrics", None)
        self.prefix_cache = None
        if prefix_cache:
            self.prefix_cache = RadixPrefixCache(self.pool.allocator,
                                                 self.page_size)
            self.batcher.prefix_cache = self.prefix_cache
        self._pending: list[Request] = []
        self.completed: list[Request] = []
        self._rid = 0
        self._pump = None
        self._t0: float | None = None
        self.stats = {"rounds": 0, "decode_steps": 0, "prefill_chunks": 0,
                      "admit_s": 0.0, "bookkeep_s": 0.0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "occupancy_sum": 0, "peak_pool_util": 0.0,
                      "wall_s": 0.0, "host_sync_count": 0,
                      "draft_steps": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "handoffs": 0,
                      "handoff_bytes": 0, "handoff_s": 0.0}

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
        # a single engine has no router in front: mint the trace id here,
        # in the shape the fleet's router uses
        req.trace_id = f"tr-{req.rid:06d}"
        self._rid += 1
        self._pending.append(req)
        return req

    def enqueue(self, req: Request, now: float) -> None:
        """Hand an externally built request straight to the batcher (a
        fleet router's dispatch path: rids are the fleet's, admission
        control already ran)."""
        self.batcher.submit(req, now)

    # ---- fleet queries -----------------------------------------------
    def can_accept(self, req: Request) -> bool:
        """True when ``req`` would be admitted at the next round: a free
        slot AND its full page grant, with nothing already queued.  The
        trie's evictable pages count as free: ``admit`` evicts under
        pressure, and without the credit a saturated prefix cache would
        wedge dispatch while the engine sits idle."""
        if self.batcher.waiting:
            return False
        if not any(r is None for r in self.batcher.slots):
            return False
        free = self.pool.allocator.free_pages
        if self.prefix_cache is not None:
            free += self.prefix_cache.reclaimable_pages
        return free >= self.batcher.pages_needed(req)

    def drained(self) -> bool:
        """No request in flight: the state :meth:`swap_params` needs."""
        return not self.batcher.has_work()

    def in_flight(self) -> int:
        """Unfinished requests resident here (queued or in a slot)."""
        return len(self.batcher.waiting) + sum(
            r is not None for r in self.batcher.slots)

    # ---- placement ----------------------------------------------------
    def _placement(self, device):
        """``(prefill device, decode device)``.  Under ``mesh`` the rank's
        device; with ``disaggregate`` the ``device`` pair (one device
        named twice is allowed), by default ``cuda:0`` and ``cuda:1``;
        else ``device`` for both."""
        if self.mesh is not None:
            if M.initialized():
                import torch.distributed as dist
                if dist.get_backend() != "nccl":
                    return (torch.device("cpu"),) * 2
                dev = torch.device("cuda", torch.cuda.current_device())
                return dev, dev
            dev = resolve_device(None)
            return dev, dev
        if not self.disaggregate:
            dev = resolve_device(device)
            return dev, dev
        if device is None:
            resolve_device(None)              # raises without a card
            if torch.cuda.device_count() < 2:
                raise ValueError("disaggregate needs >= 2 devices")
            device = ("cuda:0", "cuda:1")
        if isinstance(device, (str, torch.device)) or len(device) != 2:
            raise ValueError("device commits the whole engine to one "
                             "device; disaggregate splits it — pick one "
                             "(or pass a (prefill, decode) pair)")
        return resolve_device(device[0]), resolve_device(device[1])

    def _place(self, params):
        """``params`` as this engine serves them: this rank's Megatron
        shards under ``mesh``, on the decode device and on the prefill
        device (the same tensors when they are one device)."""
        if self.tp_axis is not None:
            params = shard_tree_tp(params, M.axis_rank(self.tp_axis),
                                   self.tp)
        dec = _to_device(params, self._decode_dev)
        if self._prefill_dev == self._decode_dev:
            return dec, dec
        return dec, _to_device(params, self._prefill_dev)

    def _put(self, a, device=None) -> torch.Tensor:
        return torch.as_tensor(a, device=device or self.device)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """The burst's sync point: ``t`` on the host, through the
        watchdog when there is one (a wedged burst then raises
        ``StepTimeoutError`` instead of blocking)."""
        if self.watchdog is not None:
            return self.watchdog.block(lambda x: x.cpu().numpy(), t,
                                       step=self.stats["decode_steps"])
        return t.cpu().numpy()

    def _handoff(self, req: Request) -> None:
        """Disaggregated KV handoff after ``req``'s last prefill chunk:
        the rows of its prompt pages in every layer of the prefill pool
        (an int8 pool's scales with its codes) are copied into its first
        decode pages, then its prefill pages are freed.  Pure data
        movement: the decode pool then holds what the engine without
        ``disaggregate`` would have written there."""
        t = time.perf_counter()
        src = self._pre_pages.pop(req.rid)
        pre = torch.as_tensor(src, device=self._prefill_dev)
        dec = torch.as_tensor(req.pages[:len(src)], device=self.device)
        a, b = self.pool_pre.bufs, self.pool.bufs
        pairs = list(zip(a.k + a.v, b.k + b.v))
        if a.k_scale is not None:
            pairs += list(zip(a.k_scale + a.v_scale, b.k_scale + b.v_scale))
        for s_buf, d_buf in pairs:
            rows = s_buf[pre].to(self.device, non_blocking=True)
            d_buf[dec] = rows
            self.stats["handoff_bytes"] += rows.numel() * rows.element_size()
        self.pool_pre.allocator.free(src)
        self.stats["handoffs"] += 1
        self.stats["handoff_s"] += time.perf_counter() - t

    # ---- prefill ------------------------------------------------------
    def _prefill_one_chunk(self, req: Request, t0: float) -> None:
        Ck = self.prefill_chunk
        pos = req.prefill_pos
        chunk = req.prompt[pos:pos + Ck]
        ids = np.zeros((1, Ck), np.int32)
        ids[0, :chunk.shape[0]] = chunk
        src = (self._pre_pages[req.rid] if self.disaggregate
               else req.pages)
        row = np.zeros((1, self.pages_per_request), np.int32)
        row[0, :len(src)] = src
        t_chunk = time.perf_counter()
        dev = self._prefill_dev
        row_d, ids_d = self._put(row, dev), self._put(ids, dev)
        bufs = self.pool_pre.bufs if self.disaggregate else self.pool.bufs
        tok_d = _prefill_core(bufs, self._params_pre, row_d, ids_d,
                              pos, req.n_prompt, cfg=self.cfg,
                              tp_axis=self.tp_axis)
        if self.spec_k:
            # the draft needs the prompt's KV in ITS pool to propose: it
            # rides the same chunk (same pages, draft params)
            _prefill_core(self.draft_pool.bufs, self._draft_params, row_d,
                          ids_d, pos, req.n_prompt, cfg=self.draft_cfg,
                          tp_axis=self.tp_axis)
        req.prefill_pos = min(pos + Ck, req.n_prompt)
        self.stats["prefill_chunks"] += 1
        if req.prefill_pos < req.n_prompt:
            self.stats["prefill_s"] += time.perf_counter() - t_chunk
            return
        if self.disaggregate:
            self._handoff(req)
        first = int(tok_d.cpu()[0])     # sync: TTFT resolution
        self.stats["host_sync_count"] += 1
        self._finish_prefill(req, first, t_chunk, t0)
        self.stats["prefill_s"] += time.perf_counter() - t_chunk

    def _finish_prefill(self, req: Request, first: int, t_chunk: float,
                        t0: float) -> None:
        """Final-chunk bookkeeping: donate the full prompt pages to the
        prefix cache, stamp TTFT, emit telemetry and flip the slot into
        DECODE (or retire it when ``max_new == 1``)."""
        now = time.perf_counter() - t0
        if self.prefix_cache is not None:
            # the full prompt pages hold committed KV now.  A concurrent
            # twin that finished first won the trie slot: our duplicate
            # page is freed and the page-table entry swaps to the twin's
            # (the same bits, so decode cannot tell)
            nodes, swaps = self.prefix_cache.insert(
                req.prompt, req.pages, req.cache_nodes)
            req.cache_nodes = nodes
            for i, pg in swaps.items():
                req.pages[i] = pg
                self._h_pages[req.slot, i] = pg
        req.tokens.append(first)
        req.t_first = now
        spans = getattr(self.telem, "spans", None)
        if spans is not None:
            spans.record("serve/prefill_chunk", start_perf=t_chunk,
                         end_perf=time.perf_counter(), cat="serve",
                         rid=req.rid, n_prompt=int(req.n_prompt),
                         request_id=req.rid, trace_id=req.trace_id,
                         replica=self.replica,
                         t_submit_s=req.t_submit, t_admit_s=req.t_admit,
                         t_first_s=req.t_first)
        if self.telem is not None:
            self.telem.step(
                loss=None, tokens=req.n_prompt,
                tracker_metrics={
                    "last_step_time_s": time.perf_counter() - t_chunk},
                phase="prefill", rid=req.rid, request_id=req.rid,
                trace_id=req.trace_id, ttft_ms=1e3 * (req.ttft_s or 0.0),
                pool_util=self.pool.utilization)
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
            src = (self._pre_pages[req.rid] if self.disaggregate
                   else req.pages)
            pages[i, :len(src)] = src
            pos[i] = req.prefill_pos
            plen[i] = req.n_prompt
        t_chunk = time.perf_counter()
        dev = self._prefill_dev
        args = (self._put(pages, dev), self._put(ids, dev),
                self._put(pos, dev), self._put(plen, dev))
        bufs = self.pool_pre.bufs if self.disaggregate else self.pool.bufs
        tok_d = _prefill_batch_core(bufs, self._params_pre, *args,
                                    cfg=self.cfg,
                                    flash_prefill=self.flash_prefill,
                                    tp_axis=self.tp_axis)
        if self.spec_k:
            _prefill_batch_core(self.draft_pool.bufs, self._draft_params,
                                *args, cfg=self.draft_cfg,
                                flash_prefill=self.flash_prefill,
                                tp_axis=self.tp_axis)
        self.stats["prefill_chunks"] += 1
        finishing = []
        for i, req in enumerate(reqs):
            req.prefill_pos = min(req.prefill_pos + Ck, req.n_prompt)
            if req.prefill_pos >= req.n_prompt:
                finishing.append((i, req))
        if finishing:
            if self.disaggregate:
                for _, req in finishing:
                    self._handoff(req)
            toks = tok_d.cpu().numpy()   # sync: TTFT resolution for all
            self.stats["host_sync_count"] += 1
            for i, req in finishing:
                self._finish_prefill(req, int(toks[i]), t_chunk, t0)
        self.stats["prefill_s"] += time.perf_counter() - t_chunk

    # ---- decode -------------------------------------------------------
    def _burst_inputs(self):
        return (self._put(self._h_tokens), self._put(self._h_lengths),
                self._put(self._h_stop), self._put(self._h_active),
                self._put(self._h_pages))

    def _retire_finished(self, active, t0: float) -> list[Request]:
        now = time.perf_counter() - t0
        finished = []
        for b in range(self.max_batch):
            req = self.batcher.slot_request(b)
            if req is not None and req.state == DECODE and not active[b]:
                self.batcher.retire(req, now)
                self._h_pages[b] = 0     # slot back to the null page
                self.completed.append(req)
                finished.append(req)
        return finished

    def _decode_step_event(self, burst_s: float, sync: int, occ_burst,
                           emitted: int, finished, **extra) -> None:
        self.telem.step(
            loss=None, tokens=emitted,
            tracker_metrics={"last_step_time_s": burst_s / sync},
            phase="decode", active=float(np.mean(occ_burst)),
            admitted=self.batcher.admitted_total,
            completed=self.batcher.completed_total,
            kv_pages_in_use=self.pool.allocator.pages_in_use,
            pool_util=self.pool.utilization, **extra,
            completed_requests=[
                {"rid": r.rid, "trace_id": r.trace_id,
                 "ttft_ms": 1e3 * (r.ttft_s or 0.0),
                 "per_token_ms": 1e3 * (r.per_token_s or 0.0),
                 "tokens": len(r.tokens)} for r in finished])

    def _decode_burst(self, pump: StepPump, t0: float) -> None:
        sync = self.sync_every
        L0 = self._h_lengths.copy()
        A0 = self._h_active.copy()
        toks_d, len_d, stop_d, act_d, pages_d = self._burst_inputs()
        t_burst = time.perf_counter()
        step_tokens = []
        for _ in range(sync):
            toks_d, len_d, act_d, occ = _decode_core(
                self.pool.bufs, self._params, pages_d, toks_d, len_d,
                stop_d, act_d, cfg=self.cfg, paged_kernel=self.paged_kernel,
                tp_axis=self.tp_axis)
            self.stats["decode_steps"] += 1     # dispatched steps
            pump.emit(occ)
            step_tokens.append(toks_d)
        # sync point: resolve the burst's tokens and replay the device's
        # deterministic active chain on the host
        mats = self._host(torch.stack(step_tokens))
        self.stats["host_sync_count"] += 1
        burst_s = time.perf_counter() - t_burst
        self.stats["decode_s"] += burst_s
        spans = getattr(self.telem, "spans", None)
        if spans is not None:
            spans.record("serve/decode_burst", start_perf=t_burst,
                         end_perf=time.perf_counter(), cat="serve",
                         steps=int(sync), replica=self.replica)
        t_book = time.perf_counter()
        active, lengths = A0.copy(), L0.copy()
        occ_burst, emitted = [], 0
        for j in range(sync):
            occ_burst.append(int(active.sum()))
            for b in np.nonzero(active)[0]:
                self.batcher.slot_request(int(b)).tokens.append(
                    int(mats[j][b]))
                emitted += 1
            lengths = lengths + active
            active = active & (lengths < self._h_stop)
        self._h_tokens = mats[-1].copy()
        self._h_lengths = lengths.astype(np.int32)
        self._h_active = active
        finished = self._retire_finished(active, t0)
        self.stats["bookkeep_s"] += time.perf_counter() - t_book
        if self.telem is not None:
            self._decode_step_event(burst_s, sync, occ_burst, emitted,
                                    finished)

    def _spec_burst(self, pump: StepPump, t0: float) -> None:
        """Speculative decode burst: ``sync_every`` macro-steps, each k
        draft decode steps + one (B, k+1) target verify + the device-side
        acceptance update.  The whole chain dispatches without a host
        sync (no ``.item()``, no ``.cpu()``); ONE sync at the end
        resolves every macro-step's greedy rows and acceptance counts,
        and the host replays the acceptance chain to append tokens and
        retire finished requests.  Rolling back a rejected draft tail is
        free: its pool rows sit past the committed length, masked from
        every live query, and the next macro-step overwrites them before
        any read — in both pools."""
        sync, k = self.sync_every, self.spec_k
        L0 = self._h_lengths.copy()
        A0 = self._h_active.copy()
        toks_d, len_d, stop_d, act_d, pages_d = self._burst_inputs()
        # the reference attaches its compiled step here for its ledgers
        # (telem.attach_step_hlo); a serving run files no ledger in the
        # port: the memory ledger is ROADMAP.md queue A item A12
        t_burst = time.perf_counter()
        g_steps, e_steps = [], []
        for _ in range(sync):
            # k draft self-decode steps propose a chain per slot, against
            # the draft's pool at the same page table and the same stop_at
            d_toks, d_len, d_act = toks_d, len_d, act_d
            props = [toks_d]
            for _i in range(k):
                d_toks, d_len, d_act, _docc = _decode_core(
                    self.draft_pool.bufs, self._draft_params, pages_d,
                    d_toks, d_len, stop_d, d_act, cfg=self.draft_cfg,
                    paged_kernel=self.paged_kernel, tp_axis=self.tp_axis)
                props.append(d_toks)
            blk = torch.stack(props, dim=1)          # (B, k+1)
            g_d, occ = _spec_verify_core(
                self.pool.bufs, self._params, pages_d, blk, len_d, stop_d,
                act_d, cfg=self.cfg, flash_prefill=self.flash_prefill,
                tp_axis=self.tp_axis)
            self.stats["decode_steps"] += 1     # dispatched macro-steps
            self.stats["draft_steps"] += k
            pump.emit(occ)
            toks_d, len_d, act_d, e_d = _spec_accept_core(
                blk, g_d, toks_d, len_d, stop_d, act_d)
            g_steps.append(g_d)
            e_steps.append(e_d)
        # the burst's one sync: every macro-step's greedy rows and
        # acceptance counts, and the last committed tokens, in one copy
        B = self.max_batch
        flat = torch.cat([torch.stack(g_steps).flatten(),
                          torch.stack(e_steps).flatten(), toks_d])
        flat = self._host(flat)
        n_g = sync * B * (k + 1)
        gs = flat[:n_g].reshape(sync, B, k + 1)
        es = flat[n_g:n_g + sync * B].reshape(sync, B)
        last = flat[n_g + sync * B:]
        self.stats["host_sync_count"] += 1
        burst_s = time.perf_counter() - t_burst
        self.stats["decode_s"] += burst_s
        spans = getattr(self.telem, "spans", None)
        if spans is not None:
            spans.record("serve/spec_burst", start_perf=t_burst,
                         end_perf=time.perf_counter(), cat="serve",
                         steps=int(sync), k=int(k), replica=self.replica)
        t_book = time.perf_counter()
        active, lengths = A0.copy(), L0.copy()
        occ_burst, emitted = [], 0
        proposed = accepted = 0
        for j in range(sync):
            occ_burst.append(int(active.sum()))
            for b in np.nonzero(active)[0]:
                e_b = int(es[j][b])
                self.batcher.slot_request(int(b)).tokens.extend(
                    int(t) for t in gs[j][b, :e_b])
                emitted += e_b
                proposed += k
                accepted += e_b - 1
            lengths = lengths + es[j]
            active = active & (lengths < self._h_stop)
        self.stats["spec_proposed"] += proposed
        self.stats["spec_accepted"] += accepted
        maybe_inc(self.batcher.metrics, "spec_proposed_total", proposed)
        maybe_inc(self.batcher.metrics, "spec_accepted_total", accepted)
        self._h_tokens = last.astype(np.int32)
        self._h_lengths = lengths.astype(np.int32)
        self._h_active = active
        finished = self._retire_finished(active, t0)
        self.stats["bookkeep_s"] += time.perf_counter() - t_book
        if self.telem is not None:
            self._decode_step_event(
                burst_s, sync, occ_burst, emitted, finished,
                spec_accept_rate=(accepted / proposed if proposed
                                  else None))

    # ---- round loop ---------------------------------------------------
    def start(self, t0: float | None = None) -> None:
        """Arm the engine clock and the pump without driving the loop.
        ``run()`` calls it; a fleet calls it with a SHARED ``t0`` so that
        every replica's timestamps live on one clock, then drives rounds
        through :meth:`step_round`."""
        if self._t0 is None:
            self._t0 = time.perf_counter() if t0 is None else t0
        if self._pump is None:
            self._pump = StepPump(sync_every=self.sync_every,
                                  max_in_flight=self.max_in_flight,
                                  watchdog=self.watchdog)

    def close_pump(self) -> None:
        """Drain and drop the pump."""
        if self._pump is not None:
            pump, self._pump = self._pump, None
            pump.close()
            self.stats["host_sync_count"] += pump.host_sync_count

    def abandon_pump(self) -> None:
        """Drop the pump WITHOUT draining: the failover path of a replica
        whose in-flight work will never resolve."""
        self._pump = None

    def step_round(self, now: float) -> list[Request]:
        """One scheduler round at elapsed time ``now``: admit, run up to
        ``prefill_chunks_per_round`` prefill chunks, then one decode
        burst (speculative when ``spec_k``) if any slot is active.
        Returns the requests that finished this round."""
        self.start()
        t0 = self._t0
        done_base = len(self.completed)
        t_admit = time.perf_counter()
        for req in self.batcher.admit(now):
            self._h_pages[req.slot] = 0
            self._h_pages[req.slot, :len(req.pages)] = req.pages
            if self.disaggregate:
                pre = self.pool_pre.allocator.alloc(
                    -(-req.n_prompt // self.page_size))
                if pre is None:
                    raise RuntimeError(
                        "prefill pool exhausted — it is sized like the "
                        "decode pool, so this is a leak, not load")
                self._pre_pages[req.rid] = pre
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
            if self.spec_k:
                self._spec_burst(self._pump, t0)
            else:
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

    # ---- failover / hot-swap -----------------------------------------
    def release_all(self) -> list[Request]:
        """Failover teardown: every unfinished request leaves reset for
        replay (``scheduler.reset_for_replay``), slots and pages are
        freed, the host mirrors zeroed.  The device pool is not touched."""
        orphans = self.batcher.release_all()
        for rid in list(self._pre_pages):
            self.pool_pre.allocator.free(self._pre_pages.pop(rid))
        self._h_active[:] = False
        self._h_pages[:] = 0
        return orphans

    def swap_params(self, params) -> None:
        """Install new weights on a DRAINED engine (the fleet's hot-swap
        lands here once the engine has no request in flight), placed as
        ``__init__`` placed the first (this rank's shards under ``mesh``,
        both devices when disaggregated).  As in the reference, the
        draft keeps the weights it was built with: any draft leaves the
        emitted stream the target's."""
        if not self.drained():
            raise RuntimeError(
                f"swap_params with {self.in_flight()} request(s) in "
                f"flight — drain the engine first")
        self._params, self._params_pre = self._place(params)

    # ---- reporting ----------------------------------------------------
    def slo_report(self) -> dict:
        """TTFT / per-token percentiles + throughput + pool/scheduler
        health for the finished requests (the dict ``train.serve_bench``
        files under summary.json's ``serving`` key).  Times are
        host-clock seconds around work that ends in a host sync."""
        done = [r for r in self.completed if r.t_done is not None]
        ttft = np.array([r.ttft_s for r in done
                         if r.ttft_s is not None]) * 1e3
        ptl = np.array([r.per_token_s for r in done
                        if r.per_token_s is not None]) * 1e3

        def pct(a, q):
            return float(np.percentile(a, q)) if a.size else None

        toks = int(sum(len(r.tokens) for r in done))
        wall = self.stats["wall_s"] or 1e-9
        ndev = self.tp if self.tp_axis is not None else len(
            {self._prefill_dev, self._decode_dev})
        # tokens emitted by decode steps (each request's first comes from
        # prefill): the steps-per-token the speculative leg is judged on
        dec_toks = max(toks - len(done), 1)
        rep = {
            "requests": self.batcher.admitted_total,
            "completed": len(done),
            "ttft_ms": {"p50": pct(ttft, 50), "p99": pct(ttft, 99),
                        "mean": float(ttft.mean()) if ttft.size else None},
            "per_token_ms": {"p50": pct(ptl, 50), "p99": pct(ptl, 99)},
            "tokens_total": toks,
            "tokens_per_s": toks / wall,
            "tokens_per_s_per_device": toks / wall / ndev,
            "devices": ndev,
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
            "disaggregated": self.disaggregate,
            "kv_quant": self.kv_quant,
            "paged_kernel": self.paged_kernel,
            "flash_prefill": self.flash_prefill,
        }
        if self.disaggregate:
            n = self.stats["handoffs"]
            rep["handoff"] = {
                "requests": n, "bytes": self.stats["handoff_bytes"],
                "ms_total": 1e3 * self.stats["handoff_s"],
                "bytes_per_request": (self.stats["handoff_bytes"] / n
                                      if n else None)}
        if self.prefix_cache is not None:
            rep["prefix_cache"] = self.prefix_cache.stats()
        if self.spec_k:
            prop = self.stats["spec_proposed"]
            rep["speculative"] = {
                "k": self.spec_k,
                "draft_layers": self.draft_cfg.num_hidden_layers,
                "draft_steps": self.stats["draft_steps"],
                "proposed": prop,
                "accepted": self.stats["spec_accepted"],
                "acceptance_rate": (self.stats["spec_accepted"] / prop
                                    if prop else None),
            }
        return rep


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, QuantizedWeight):
        return QuantizedWeight(params.q.to(device), params.s.to(device))
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
