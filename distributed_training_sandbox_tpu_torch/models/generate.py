"""One-shot autoregressive decoding with a contiguous KV cache — the
port of the JAX package's ``models/generate.py`` (float cache).

The serving engine's parity law is stated against this path: with
``cache_capacity`` equal to the engine's ``view_capacity``, every
request the engine serves emits the tokens ``generate`` emits for its
prompt.  The cache is per-layer HEAD-MAJOR ``(B, n_kv, S_max, hd)``
buffers written in place; attention always contracts over the whole
capacity with positions past the current one masked to −1e30, as the
reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from . import transformer as T


class KVCache(NamedTuple):
    """Per-layer cache buffers, each HEAD-MAJOR (B, n_kv, S_max, hd)."""
    k: list
    v: list
    length: int


def init_cache(cfg: T.TransformerConfig, batch: int, max_len: int,
               device=None) -> KVCache:
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.resolved_head_dim)
    shape = (batch, nkv, max_len, hd)

    def zeros():
        return [torch.zeros(shape, dtype=cfg.dtype, device=device)
                for _ in range(L)]

    return KVCache(k=zeros(), v=zeros(), length=0)


def _cached_layer_body(x, layer, *, cfg, cos, sin, use_rope, ck, cv,
                       start: int):
    """One decoder layer that writes its new K/V rows into ``ck``/``cv``
    in place (the reference donated its buffers; here the update is an
    in-place slice copy) and attends over the whole cache capacity."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    dense = T._dense(cfg)

    r = T.rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = T._qkv_proj(r, layer, cfg=cfg, cos=cos, sin=sin,
                          use_rope=use_rope)
    ck[:, :, start:start + S] = k.transpose(1, 2)
    cv[:, :, start:start + S] = v.transpose(1, 2)

    S_max = ck.shape[2]
    rep = nq // nkv
    qg = q.reshape(B, S, nkv, rep, hd)
    # scores in f32 from the stored-dtype operands (the reference's
    # preferred_element_type=f32), probs cast to the activation dtype
    # for the PV contraction, accumulated in f32
    scores = torch.einsum("bsgrh,bgkh->bgrsk", qg.float(),
                          ck.float()) / math.sqrt(hd)
    pos_q = start + torch.arange(S, device=x.device)
    pos_kv = torch.arange(S_max, device=x.device)
    vis = pos_kv[None, :] <= pos_q[:, None]                  # (S, S_max)
    scores = torch.where(vis[None, None, None], scores,
                         torch.full((), -1e30, device=x.device))
    probs = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bgrsk,bgkh->bsgrh", probs.to(x.dtype).float(),
                        cv.float())
    attn = attn.to(x.dtype).reshape(B, S, nq * hd)
    x = x + dense(attn, layer["wo"])
    r = T.rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    return x + T._mlp_block(r, layer, cfg=cfg)


def _forward_cached(params, ids, cfg, cache: KVCache, start: int):
    """ids (B, S) → (last-position logits (B, V) f32, cache')."""
    B, S = ids.shape
    x = params["embed"].to(cfg.dtype)[ids]
    cos, sin = T._rope_tables(S, cfg.resolved_head_dim, cfg.rope_theta,
                              start, device=ids.device)
    for li, use_rope in enumerate(T.rope_flags(cfg)):
        x = _cached_layer_body(
            x, T.layer_params(params, li), cfg=cfg, cos=cos, sin=sin,
            use_rope=use_rope, ck=cache.k[li], cv=cache.v[li], start=start)
    x = T.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_norm_eps)
    logits = (x @ T._output_embedding(params, cfg).T)[:, 0]
    return logits.float(), cache._replace(length=start + S)


def _decode_cfg(cfg: T.TransformerConfig) -> T.TransformerConfig:
    """Decode never checkpoints: strip the remat knob."""
    return dataclasses.replace(cfg, remat=False) if cfg.remat else cfg


@torch.no_grad()
def generate(params, prompt_ids, cfg: T.TransformerConfig, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             cache_capacity: int | None = None, device=None):
    """Decode ``max_new_tokens`` after ``prompt_ids`` (B, S_prompt).

    Greedy argmax at temperature 0; categorical sampling above it, which
    needs an explicit ``generator``.  ``cache_capacity`` pads the cache
    to a fixed S_max ≥ prompt+new, the contraction extent the serving
    engine uses.  ``params`` must already be on ``device`` (default
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
                       device=dev)

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
