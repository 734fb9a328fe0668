"""Decoder-only transformer LM — the port of the JAX package's
``models/transformer.py`` building blocks that serving runs.

The parameter tree is the reference's, leaf for leaf: ``embed``
(vocab, H), ``layers`` holding stacked ``(L, …)`` tensors with
projection weights stored ``(in, out)`` so every projection is
``x @ w``, and ``final_norm`` (H,).  That keeps the bridge
(``bridge.py``) one array copy per leaf.

Only the pieces the serving slice needs are here: config, init, RMSNorm,
split-half RoPE with the NoPE schedule, the QKV projection, the dense
SwiGLU MLP and the tied unembedding, at ``matmul_precision="bf16"``.
Training (scanned layers, remat, flash/ring attention, losses) and the
quantized precisions are later slices of the port (ROADMAP.md queue A).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

_ROADMAP = ("not ported yet — see ROADMAP.md, queue A item 2 (model "
            "core) and queue B (precision kernels)")


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 128_256
    hidden_size: int = 2048
    intermediate_size: int = 11_008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 4
    head_dim: int | None = None
    rope_theta: float = 5_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    # every nope_interval-th layer (layers where (i+1) % interval == 0)
    # skips RoPE — SmolLM3's NoPE scheme; 0 = RoPE everywhere
    nope_interval: int = 4
    dtype: Any = torch.bfloat16
    remat: bool = True
    matmul_precision: str = "bf16"
    n_experts: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


# SmolLM3-3B-class config (~3.1 B params).
SMOLLM3_3B = TransformerConfig()

TINY_LM = TransformerConfig(
    vocab_size=512, hidden_size=64, intermediate_size=160,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10_000.0, dtype=torch.float32, remat=False)


def check_supported(cfg: TransformerConfig) -> None:
    """Raise on the configurations this slice of the port does not run."""
    if cfg.matmul_precision != "bf16":
        raise NotImplementedError(
            f"matmul_precision={cfg.matmul_precision!r}: {_ROADMAP}")
    if cfg.n_experts:
        raise NotImplementedError(f"n_experts={cfg.n_experts}: {_ROADMAP}")


# ------------------------------------------------------------------- init

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random init from config: truncated normal (±2σ) at σ = 0.02,
    out-projections scaled by 1/sqrt(2·layers).  The tensors are drawn
    on ``generator``'s device and moved to ``device`` (default: the
    generator's).  The stream differs from ``jax.random``'s; parity
    tests bridge the reference's weights instead (``bridge.py``)."""
    check_supported(cfg)
    h = cfg.hidden_size
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    L = cfg.num_hidden_layers
    gdev = generator.device
    device = torch.device(device) if device is not None else gdev

    def tn(shape, std=0.02):
        t = torch.empty(shape, dtype=torch.float32, device=gdev)
        torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)
        return t.to(device=device, dtype=cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    out_std = 0.02 / math.sqrt(2 * L)
    params = {
        "embed": tn((cfg.vocab_size, h)),
        "layers": {
            "ln1": ones((L, h)),
            "wq": tn((L, h, nq * hd)),
            "wk": tn((L, h, nkv * hd)),
            "wv": tn((L, h, nkv * hd)),
            "wo": tn((L, nq * hd, h), out_std),
            "ln2": ones((L, h)),
        },
        "final_norm": ones((h,)),
    }
    params["layers"].update(
        w_gate=tn((L, h, cfg.intermediate_size)),
        w_up=tn((L, h, cfg.intermediate_size)),
        w_down=tn((L, cfg.intermediate_size, h), out_std))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = tn((h, cfg.vocab_size))
    return params


# ---------------------------------------------------------------- building blocks

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim)


def _rope_tables(seq_len: int, head_dim: int, theta: float, offset=0,
                 device=None):
    """cos/sin (seq_len, hd/2) f32 for positions ``offset + arange``."""
    inv_freq = _inv_freq(head_dim, theta, device)
    positions = offset + torch.arange(seq_len, dtype=torch.float32,
                                      device=device)
    ang = positions[:, None] * inv_freq[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, n_heads, head_dim); split-half rotation (HF convention)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def _dense(cfg: TransformerConfig):
    """The projection matmul; this slice runs ``bf16`` (a plain
    ``x @ w`` in the config's dtype) only."""
    check_supported(cfg)
    return torch.matmul


def _qkv_proj(r, layer, *, cfg: TransformerConfig, cos, sin, use_rope: bool):
    """Normed residual → RoPE'd (q, k, v), each (B, S, heads, hd)."""
    B, S, _ = r.shape
    hd = cfg.resolved_head_dim
    dense = _dense(cfg)
    q = dense(r, layer["wq"]).reshape(B, S, cfg.num_attention_heads, hd)
    k = dense(r, layer["wk"]).reshape(B, S, cfg.num_key_value_heads, hd)
    v = dense(r, layer["wv"]).reshape(B, S, cfg.num_key_value_heads, hd)
    if use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _mlp_block(r, layer, *, cfg: TransformerConfig):
    """Dense SwiGLU MLP on the normed residual."""
    dense = _dense(cfg)
    return dense(torch.nn.functional.silu(dense(r, layer["w_gate"]))
                 * dense(r, layer["w_up"]), layer["w_down"])


def rope_flags(cfg: TransformerConfig) -> list[bool]:
    """Per-layer use-RoPE flags (NoPE on every ``nope_interval``-th)."""
    return [(li + 1) % cfg.nope_interval != 0 if cfg.nope_interval
            else True for li in range(cfg.num_hidden_layers)]


def layer_params(params: dict, li: int) -> dict:
    """Layer ``li``'s leaves, sliced from the stacked ``(L, …)`` tensors
    (views — no copy)."""
    return {k: v[li] for k, v in params["layers"].items()}


def _output_embedding(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Unembedding as (vocab, H) rows (tied: the input embedding itself)."""
    w = params.get("lm_head")
    if w is None:
        return params["embed"].to(cfg.dtype)
    return w.to(cfg.dtype).T
