"""Analytic transformer FLOPs per token, for tokens/s → MFU.

A copy of the JAX package's ``utils/flops.py`` (jax-free there too; the
port keeps its own copy and imports nothing of the JAX package).  Its
convention, as in the reference: matmuls count 2·m·n·k, the backward
twice the forward, the causal attention term at half the square, and
the vocab head included.
"""

from __future__ import annotations

from dataclasses import dataclass

# an H100 SXM's dense bf16 peak, the denominator of the port's MFU
PEAK_BF16_FLOPS = 989e12


@dataclass(frozen=True)
class FlopsConfig:
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    vocab_size: int
    gated_mlp: bool = True


def get_model_flops_per_token(cfg, seq_len: int, *, backward_factor: float = 2.0,
                              causal: bool = True,
                              include_lm_head: bool = True) -> float:
    """Forward+backward FLOPs per token.

    Matmul FLOPs count 2·m·n·k; the backward pass re-does each matmul twice
    (grad-wrt-input and grad-wrt-weight), hence the (1 + backward_factor)
    multiplier — the same convention the reference's analytic model uses.
    ``cfg`` is any object with the FlopsConfig attribute names (an HF-style
    config works unchanged).

    ``include_lm_head=False`` drops the per-token vocab-projection term —
    the honest count for heads that are NOT a per-token unembedding (e.g.
    the pooled classifier, whose head is one (B,H)@(H,2) matmul; counting
    2·h·vocab per token there overstates TFLOPS/MFU by ~10-15% at
    SmolLM3-350M geometry).
    """
    h = cfg.hidden_size
    inter = cfg.intermediate_size
    layers = cfg.num_hidden_layers
    n_q = cfg.num_attention_heads
    n_kv = getattr(cfg, "num_key_value_heads", n_q) or n_q
    head_dim = getattr(cfg, "head_dim", None) or h // n_q
    vocab = cfg.vocab_size

    q_proj = 2 * h * (n_q * head_dim)
    kv_proj = 2 * 2 * h * (n_kv * head_dim)
    o_proj = 2 * (n_q * head_dim) * h
    # QK^T and PV: each is 2 · seq · head_dim per head per token; causal
    # attention touches half the positions on average.
    attn_quadratic = 2 * 2 * (n_q * head_dim) * seq_len * (0.5 if causal else 1.0)
    router = 0
    active_k = 1
    n_exp = getattr(cfg, "n_experts", 0)
    if n_exp:
        # top-k MoE: each token runs k experts of moe_ffn width (active
        # FLOPs, the MFU-relevant count) plus the router matmul.
        inter = getattr(cfg, "moe_ffn", None) or inter
        router = 2 * h * n_exp
        active_k = getattr(cfg, "moe_top_k", 1)
    mlp = (3 if getattr(cfg, "gated_mlp", True) else 2) * 2 * h * inter \
        * active_k
    per_layer = q_proj + kv_proj + o_proj + attn_quadratic + mlp + router
    head = 2 * h * vocab if include_lm_head else 0
    fwd = layers * per_layer + head
    return fwd * (1.0 + backward_factor)
