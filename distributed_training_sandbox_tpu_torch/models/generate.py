"""One-shot autoregressive decoding with a contiguous KV cache — the
port of the JAX package's ``models/generate.py`` (float and int8 caches,
and the int8 decode weights of ``quantize_decode_params``).

The serving engine's parity law is stated against this path: with
``cache_capacity`` equal to the engine's ``view_capacity``, every
request the engine serves emits the tokens ``generate`` emits for its
prompt.  The cache is per-layer HEAD-MAJOR ``(B, n_kv, S_max, hd)``
buffers written in place; attention always contracts over the whole
capacity with positions past the current one masked to −1e30, as the
reference does.

``kv_quant`` stores the cache int8 with per-row f32 scales, and the
attention then runs the reference's int8 core (``ops/paged_attention.
attend_q8``: int8 q·k, the scales folded after, the v-scaled
probabilities requantised per row for an int8 PV).  Params from
``quantize_decode_params`` carry every projection and the unembedding
as int8 ``QuantizedWeight``s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ops.paged_attention import attend_q8
from ..ops.quant import prequantized_dense, quantize_int8, quantize_weight
from . import transformer as T


class KVCache(NamedTuple):
    """Per-layer cache buffers, each HEAD-MAJOR (B, n_kv, S_max, hd), in
    ``cfg.dtype`` or int8; an int8 cache has (B, n_kv, S_max, 1) f32 row
    scales."""
    k: list
    v: list
    length: int
    k_scale: list | None = None
    v_scale: list | None = None


def init_cache(cfg: T.TransformerConfig, batch: int, max_len: int,
               device=None, quantized: bool = False) -> KVCache:
    """An empty cache; ``quantized`` stores it int8 with scales
    initialised to ones (unwritten rows dequantise to zeros)."""
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.resolved_head_dim)
    shape = (batch, nkv, max_len, hd)
    dt = torch.int8 if quantized else cfg.dtype

    def zeros():
        return [torch.zeros(shape, dtype=dt, device=device)
                for _ in range(L)]

    def ones():
        return [torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                           device=device) for _ in range(L)]

    if quantized:
        return KVCache(k=zeros(), v=zeros(), length=0, k_scale=ones(),
                       v_scale=ones())
    return KVCache(k=zeros(), v=zeros(), length=0)


# Projection leaves stored int8 for decode (stacked (L, K, N) leaves get
# per-layer scales); the norm scales stay in cfg.dtype.
_QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# an MoE config quantises its attention projections only
_QUANT_ATTN_KEYS = ("wq", "wk", "wv", "wo")


def quantize_decode_params(params: dict, cfg: T.TransformerConfig) -> dict:
    """Training params → decode params with every projection weight
    stored int8 (``ops.quant.QuantizedWeight``, per output column over
    the contraction dim) and an int8 copy of the unembedding, (H, vocab),
    under ``"unembed_q"``; ``lm_head`` is dropped.  An MoE config keeps
    its expert banks and router in ``cfg.dtype`` and quantises ``wq``,
    ``wk``, ``wv`` and ``wo`` only, as the reference does.  The
    reference runs this eagerly, so the scales take the division form
    (``quantize_weight(..., eager=True)``)."""
    layers = dict(params["layers"])
    for k in _QUANT_ATTN_KEYS if cfg.n_experts else _QUANT_LAYER_KEYS:
        if k in layers:
            layers[k] = quantize_weight(layers[k], contract_axis=-2,
                                        eager=True)
    out = {**params, "layers": layers}
    w_vocab = T._output_embedding(params, cfg)          # (vocab, H) rows
    out["unembed_q"] = quantize_weight(w_vocab.T, contract_axis=-2,
                                       eager=True)
    out.pop("lm_head", None)
    return out


def _quant_kv(t: torch.Tensor):
    """Row quantisation over the last axis, the jitted form: ``(..., D)``
    → ``(int8 (..., D), f32 (..., 1))``.  Used on K/V rows and q rows
    (over hd)."""
    return quantize_int8(t, axis=-1)


def _cached_layer_body(x, layer, *, cfg, cos, sin, use_rope, ck, cv,
                       start: int, ck_s=None, cv_s=None):
    """One decoder layer that writes its new K/V rows into ``ck``/``cv``
    in place (the reference donated its buffers; here the update is an
    in-place slice copy) and attends over the whole cache capacity.  An
    int8 cache (``ck.dtype == int8``) also takes the row scales
    ``ck_s``/``cv_s``."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    dense = T._dense(cfg)

    r = T.rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = T._qkv_proj(r, layer, cfg=cfg, cos=cos, sin=sin,
                          use_rope=use_rope)
    S_max = ck.shape[2]
    rep = nq // nkv
    qg = q.reshape(B, S, nkv, rep, hd)
    pos_q = start + torch.arange(S, device=x.device)
    pos_kv = torch.arange(S_max, device=x.device)
    vis = pos_kv[None, :] <= pos_q[:, None]                  # (S, S_max)
    if ck.dtype == torch.int8:
        kq, ks_new = _quant_kv(k.transpose(1, 2))
        vq, vs_new = _quant_kv(v.transpose(1, 2))
        ck[:, :, start:start + S] = kq
        cv[:, :, start:start + S] = vq
        ck_s[:, :, start:start + S] = ks_new
        cv_s[:, :, start:start + S] = vs_new
        qq, q_s = _quant_kv(qg)
        attn = attend_q8(qq, q_s, ck.transpose(1, 2), cv.transpose(1, 2),
                         ck_s.transpose(1, 2), cv_s.transpose(1, 2),
                         vis[None].expand(B, S, S_max))
    else:
        ck[:, :, start:start + S] = k.transpose(1, 2)
        cv[:, :, start:start + S] = v.transpose(1, 2)
        # scores in f32 from the stored-dtype operands (the reference's
        # preferred_element_type=f32), probs cast to the activation
        # dtype for the PV contraction, accumulated in f32
        scores = torch.einsum("bsgrh,bgkh->bgrsk", qg.float(),
                              ck.float()) / math.sqrt(hd)
        scores = torch.where(vis[None, None, None], scores,
                             torch.full((), -1e30, device=x.device))
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bgrsk,bgkh->bsgrh", probs.to(x.dtype).float(),
                            cv.float())
    attn = attn.to(x.dtype).reshape(B, S, nq * hd)
    x = x + dense(attn, layer["wo"])
    r = T.rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    mlp, _ = T._mlp_block(r, layer, cfg=cfg)
    return x + mlp


def _forward_cached(params, ids, cfg, cache: KVCache, start: int):
    """ids (B, S) → (last-position logits (B, V) f32, cache')."""
    B, S = ids.shape
    x = params["embed"].to(cfg.dtype)[ids]
    cos, sin = T._rope_tables(S, cfg.resolved_head_dim, cfg.rope_theta,
                              start, device=ids.device)
    q8 = cache.k_scale is not None
    for li, use_rope in enumerate(T.rope_flags(cfg)):
        x = _cached_layer_body(
            x, T.layer_params(params, li), cfg=cfg, cos=cos, sin=sin,
            use_rope=use_rope, ck=cache.k[li], cv=cache.v[li], start=start,
            ck_s=cache.k_scale[li] if q8 else None,
            cv_s=cache.v_scale[li] if q8 else None)
    x = T.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_norm_eps)
    uq = params.get("unembed_q")
    if uq is not None:       # int8 decode: the (H, vocab) int8 copy
        logits = prequantized_dense(x, uq)[:, 0]
    else:
        logits = (x @ T._output_embedding(params, cfg).T)[:, 0]
    return logits.float(), cache._replace(length=start + S)


def _decode_cfg(cfg: T.TransformerConfig) -> T.TransformerConfig:
    """Decode never checkpoints: strip the remat knob."""
    return dataclasses.replace(cfg, remat=False) if cfg.remat else cfg


@torch.no_grad()
def generate(params, prompt_ids, cfg: T.TransformerConfig, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             cache_capacity: int | None = None, kv_quant: bool = False,
             device=None):
    """Decode ``max_new_tokens`` after ``prompt_ids`` (B, S_prompt).

    Greedy argmax at temperature 0; categorical sampling above it, which
    needs an explicit ``generator``.  ``cache_capacity`` pads the cache
    to a fixed S_max ≥ prompt+new, the contraction extent the serving
    engine uses.  ``kv_quant`` stores the cache int8.  ``params`` must
    already be on ``device`` (default
    ``cuda``).  Returns (B, max_new_tokens) int64 on ``device``."""
    dev = resolve_device(device)
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature > 0 samples stochastically: pass "
                         "generator=torch.Generator(...) explicitly")
    cfg = _decode_cfg(cfg)
    T.check_supported(cfg)
    prompt_ids = torch.as_tensor(prompt_ids, device=dev).long()
    B, S0 = prompt_ids.shape
    if cache_capacity is not None and cache_capacity < S0 + max_new_tokens:
        raise ValueError(
            f"cache_capacity={cache_capacity} < prompt+new "
            f"({S0}+{max_new_tokens}); the decode would write past it")
    cache = init_cache(cfg, B, cache_capacity or (S0 + max_new_tokens),
                       device=dev, quantized=kv_quant)

    def pick(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    logits, cache = _forward_cached(params, prompt_ids, cfg, cache, 0)
    toks = [pick(logits)]
    for _ in range(max_new_tokens - 1):
        logits, cache = _forward_cached(params, toks[-1][:, None], cfg,
                                        cache, cache.length)
        toks.append(pick(logits))
    return torch.stack(toks, dim=1)
