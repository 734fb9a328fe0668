"""Decoder-only transformer LM — the port of the JAX package's
``models/transformer.py``.

The parameter tree is the reference's, leaf for leaf: ``embed``
(vocab, H), ``layers`` holding stacked ``(L, …)`` tensors with
projection weights stored ``(in, out)`` so every projection is
``x @ w``, and ``final_norm`` (H,).  That keeps the bridge
(``bridge.py``) one array copy per leaf.

Ported: config, init, RMSNorm, split-half RoPE with the NoPE schedule,
the QKV projection, the dense SwiGLU MLP, the tied unembedding (the
serving slice), and the training trunk: ``_layer_body``,
``hidden_states`` (a Python loop over the stacked layers, each layer
under ``torch.utils.checkpoint`` for remat ``"full"``), ``forward``,
the dense and streamed-vocab cross-entropy, ``lm_loss`` and
``model_flops_per_token``; the FSDP slice added the ``layer_hook`` seam
of ``hidden_states`` and ``lm_loss`` and the ``RingShard`` dispatch of
``_dense``; the MoE slice the mixture-of-experts MLP
(``parallel/expert.py``): the config's MoE fields, the expert leaves of
``init_params``, ``_mlp_block``'s MoE branch (every caller takes its
``(mlp, aux)``), ``hidden_states(return_aux=True)`` and the weighted aux
loss of ``lm_loss``.  Attention is ``"xla"`` (the plain
``_attention_xla``) or ``"flash"`` (the port's kernel,
``ops/flash_attention.py``); projections run at ``bf16``, the fp8
recipe or the int8 recipe (``ops/quant.py``).  The remat policies
(``resolve_remat_policy``) are the reference's four: ``"full"``,
``"save_attn"``, ``"save_dots"`` and ``"save_dots_q8"``.  The
tensor- and sequence-parallel slice added ``attention_impl="ring"``
(``ops/ring_attention.py``) with the config's ``sp_axis``,
``ring_block_q`` and ``ring_layout``, the global RoPE positions of a
rank's sequence chunk, ``_layer_body``'s Megatron arguments
(``tp_axis``, ``tp_overlap``) and the ``layer_body`` seam of
``hidden_states`` and ``lm_loss`` (``parallel/tensor.py``).  The
activation offload is a later slice (ROADMAP.md queue A, A12).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from ..ops import collectives as C
from ..ops.flash_attention import (ATTENTION_OP, attention_plain,
                                   attention_saved, flash_attention)
from ..ops.quant import (DOT_Q8_OP, FP8_DENSE_OP, INT8_DENSE_OP,
                         QuantizedWeight, dot_q8, quantized_all_reduce,
                         quantized_residual, resolve_quantized_dense)
from ..ops.ring_attention import LAYOUTS, ring_attention, zigzag_positions
from ..utils.flops import get_model_flops_per_token
from ..utils.mesh import axis_rank, axis_size, resolve_axis

_ROADMAP = "not a precision of the reference (ops/quant.py)"
MOE_DISPATCHES = ("grouped", "einsum", "sort")
REMAT_POLICIES = ("full", "save_attn", "save_dots", "save_dots_q8")
PRECISIONS = ("bf16", "fp8", "fp8_delayed", "fp8_pallas", "int8",
              "int8_pallas", "int8_bwd", "int8_pallas_bwd")


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
    # "full" recomputes each layer in the backward (torch.utils.checkpoint
    # around the layer); "save_attn" keeps the attention output, so its
    # forward runs once; "save_dots" keeps the projection products'
    # outputs the backward reads (none at the *_pallas precisions, as
    # the reference's policy sees no dot in a kernel); "save_dots_q8"
    # keeps them as int8 codes and f32 scales, half save_dots' bytes at
    # bf16 (resolve_remat_policy)
    remat_policy: str = "full"
    # "xla" (the plain causal attention) | "flash" (the port's kernel) |
    # "ring" (exact causal attention over the sequence sharded on
    # ``sp_axis``, a name or a utils.mesh.Axis: parallel/sequence.py)
    attention_impl: str = "xla"
    sp_axis: Any = None
    # ring q-chunk: bound each merge's f32 score buffer to (B, n,
    # ring_block_q, S_local); 0 = unchunked.  Must divide S_local
    # (S_local/2 for the zigzag layout)
    ring_block_q: int = 0
    # ring KV layout: "contiguous" (rank-order chunks) or "zigzag"
    # (balanced stripes; batches through parallel.sequence.zigzag_shuffle)
    ring_layout: str = "contiguous"
    # None: dense f32 log-softmax over (B, S, vocab) logits; an int
    # streams the vocab in chunks of that size (chunked_softmax_xent)
    loss_vocab_chunk: int | None = None
    # "bf16" | "fp8" | "fp8_delayed" | "fp8_pallas" | "int8" |
    # "int8_pallas" | "int8_bwd" | "int8_pallas_bwd" (ops/quant.py)
    matmul_precision: str = "bf16"
    fp8_amax_history_len: int = 16
    # Mixture-of-experts MLP (parallel/expert.py): 0 = dense.  With
    # n_experts > 0 every layer's MLP is a top-k switch MoE of
    # ``n_experts`` experts of hidden width ``moe_ffn`` (default
    # intermediate_size); ``ep_axis`` (a name or a utils.mesh.Axis)
    # shards the experts over that axis (None: all experts local).  The
    # layers' load-balance losses are summed and added to lm_loss with
    # ``moe_aux_weight``.
    n_experts: int = 0
    moe_ffn: int | None = None
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 0.01
    # "grouped" (per-group one-hot products) | "sort" (global-capacity
    # sort dispatch) | "einsum" (the whole-chunk one-hot oracle)
    moe_dispatch: str = "grouped"
    moe_group_size: int = 128   # tokens per dispatch group ("grouped")
    # experts per token: 1 = Switch, 2+ = GShard top-k (normalised gates;
    # requires the grouped dispatch)
    moe_top_k: int = 1
    # router health (ST-MoE): z-loss weight on mean logsumexp(logits)^2,
    # and the router's learning-rate multiplier
    moe_router_z_weight: float = 0.0
    moe_router_lr_mult: float = 1.0
    ep_axis: Any = None

    def __post_init__(self):
        # a sequence-sharded config with a local-chunk attention would
        # never attend across chunk boundaries
        if self.sp_axis is not None and self.attention_impl != "ring":
            raise ValueError(
                f"sp_axis={_axis_name(self.sp_axis)!r} (sequence sharded) "
                f"requires attention_impl='ring', got "
                f"{self.attention_impl!r} (parallel.sequence.sp_config "
                f"sets both)")
        if self.attention_impl == "ring" and self.sp_axis is None:
            raise ValueError(
                "attention_impl='ring' needs sp_axis set to the axis the "
                "sequence is sharded on (see parallel.sequence.sp_config)")
        if self.ring_layout not in LAYOUTS:
            raise ValueError(f"unknown ring_layout {self.ring_layout!r}")
        if self.moe_top_k > 1 and self.moe_dispatch != "grouped":
            raise ValueError(
                f"moe_top_k={self.moe_top_k} requires moe_dispatch="
                f"'grouped' (got {self.moe_dispatch!r})")
        if self.moe_router_z_weight and not self.moe_aux_weight:
            raise ValueError(
                "moe_router_z_weight rides the aux-loss channel scaled "
                "by moe_aux_weight — set moe_aux_weight > 0 too")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def param_count(self) -> int:
        h, hd = self.hidden_size, self.resolved_head_dim
        attn = h * hd * (self.num_attention_heads * 2
                         + self.num_key_value_heads * 2)
        if self.n_experts:
            F = self.moe_ffn or self.intermediate_size
            mlp = self.n_experts * 3 * h * F + h * self.n_experts
        else:
            mlp = 3 * h * self.intermediate_size
        per_layer = attn + mlp + 2 * h
        embed = self.vocab_size * h
        head = 0 if self.tie_word_embeddings else embed
        return self.num_hidden_layers * per_layer + embed + head + h


# SmolLM3-3B-class config (~3.1 B params).
SMOLLM3_3B = TransformerConfig()

# One-card flagship: the 3B geometry truncated to 8 layers, with the
# flash attention and the streamed-vocab loss.
SMOLLM3_3B_L8 = TransformerConfig(
    num_hidden_layers=8, attention_impl="flash", loss_vocab_chunk=16_032)

# Switch-MoE flagship: the 3B-L8 geometry with its MLP split into 8
# experts of ffn 2752 (the dense MLP's FLOPs, 4 ways active).
SMOLLM3_3B_L8_MOE = TransformerConfig(
    num_hidden_layers=8, attention_impl="flash", loss_vocab_chunk=16_032,
    n_experts=8, moe_ffn=2752, moe_dispatch="grouped")

# Qwen3-4B geometry (hidden 2560, 32 / 8 heads at hd 128, vocab 151 936,
# RoPE everywhere); Qwen3's QK-norm is not modelled, as in the reference.
QWEN3_4B = TransformerConfig(
    vocab_size=151_936, hidden_size=2560, intermediate_size=9728,
    num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=1_000_000.0, nope_interval=0)

# Its one-card sibling: the same layer, 6 of them.
QWEN3_4B_L6 = TransformerConfig(
    vocab_size=151_936, hidden_size=2560, intermediate_size=9728,
    num_hidden_layers=6, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=1_000_000.0, nope_interval=0,
    attention_impl="flash", loss_vocab_chunk=15_194)

# Llama-3.2-1B (hd 64) and Llama-3.1-8B (an untied output head) geometry.
LLAMA32_1B = TransformerConfig(
    vocab_size=128_256, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
    head_dim=64, rope_theta=500_000.0, nope_interval=0,
    attention_impl="flash", loss_vocab_chunk=16_032)
LLAMA31_8B = TransformerConfig(
    vocab_size=128_256, hidden_size=4096, intermediate_size=14_336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    head_dim=128, rope_theta=500_000.0, nope_interval=0,
    tie_word_embeddings=False)

# SmolLM3-350M geometry: 15 / 5 heads at hd 64 (GQA rep 3).
SMOLLM3_350M = TransformerConfig(
    vocab_size=49_152, hidden_size=960, intermediate_size=2560,
    num_hidden_layers=32, num_attention_heads=15, num_key_value_heads=5,
    head_dim=64)

TINY_LM = TransformerConfig(
    vocab_size=512, hidden_size=64, intermediate_size=160,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10_000.0, dtype=torch.float32, remat=False)

# The corpus configs: vocab 8192, the committed corpus tokenizer's
# (data/corpus/tokenizer.json), 12 / 4 and 15 / 5 heads at hd 64.
CORPUS_LM = TransformerConfig(
    vocab_size=8192, hidden_size=768, intermediate_size=2048,
    num_hidden_layers=8, num_attention_heads=12, num_key_value_heads=4,
    head_dim=64, rope_theta=10_000.0, nope_interval=0,
    attention_impl="flash")
CORPUS_350M = TransformerConfig(
    vocab_size=8192, hidden_size=960, intermediate_size=2560,
    num_hidden_layers=32, num_attention_heads=15, num_key_value_heads=5,
    head_dim=64, nope_interval=0, attention_impl="flash")

# TINY_LM at 8 layers (4-stage and interleaved pipelines).
TINY_LM_L8 = dataclasses.replace(TINY_LM, num_hidden_layers=8)


def check_supported(cfg: TransformerConfig) -> None:
    """Raise on the configurations the port does not run yet."""
    if cfg.matmul_precision not in PRECISIONS:
        raise NotImplementedError(
            f"matmul_precision={cfg.matmul_precision!r}: {_ROADMAP}")
    if cfg.moe_dispatch not in MOE_DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    if cfg.attention_impl not in ("xla", "flash", "ring"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={cfg.remat_policy!r}; choose from "
                         f"{REMAT_POLICIES}")


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
    if cfg.n_experts:
        E, F = cfg.n_experts, cfg.moe_ffn or cfg.intermediate_size
        params["layers"].update(
            w_router=tn((L, h, E)),
            w_gate=tn((L, E, h, F)),
            w_up=tn((L, E, h, F)),
            w_down=tn((L, E, F, h), out_std))
    else:
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
                 device=None, positions=None):
    """cos/sin (seq_len, hd/2) f32 for positions ``offset + arange``
    (under sequence parallelism a contiguous chunk starts at rank · S),
    or for the explicit global ``positions`` (the zigzag layout's two
    stripes)."""
    inv_freq = _inv_freq(head_dim, theta, device)
    if positions is None:
        positions = offset + torch.arange(seq_len, dtype=torch.float32,
                                          device=device)
    ang = positions.float()[:, None] * inv_freq[None, :]
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
    """The projection matmul at the configured precision
    (``ops/quant.resolve_quantized_dense``).  A weight arriving as a
    :class:`ops.collectives.RingShard` (the FSDP layer hook of the
    ring_fused modes leaves projection weights sharded along their
    contraction dim) runs as the ring's collective matmul instead:
    ``all_gather_matmul``, or its kernel twin (K7) when the shard is
    marked ``impl="pallas"``; the precision does not apply to it, as in
    the reference.

    Under remat ``"save_dots_q8"`` each projection's output makes an int8
    round-trip (``quantized_residual``, reference ``:446-447``), fused
    with the projection of any precision as one op
    (``ops.quant.dot_q8``), whose codes and scales the policy keeps, so
    the recompute skips the product.  A :class:`C.RingShard`'s
    collective matmul (its hops are collectives that the backward
    reads again) and a pre-quantised decode weight take the round-trip
    after their product: the values are the reference's, and the policy
    keeps nothing of them (ROADMAP A12)."""
    check_supported(cfg)
    base = resolve_quantized_dense(
        cfg.matmul_precision, fp8_history_len=cfg.fp8_amax_history_len)
    q8 = cfg.remat and cfg.remat_policy == "save_dots_q8"

    def dispatch(a, w):
        if isinstance(w, C.RingShard):
            if w.impl == "pallas":
                out = C.all_gather_matmul_pallas(a, w.shard, w.axis_name)
            else:
                out = C.all_gather_matmul(a, w.shard, w.axis_name)
        elif q8 and not isinstance(w, QuantizedWeight):
            return dot_q8(a, w, cfg.matmul_precision,
                          fp8_history_len=cfg.fp8_amax_history_len)
        else:
            out = base(a, w)
        return quantized_residual(out) if q8 else out

    return dispatch


def _qkv_proj(r, layer, *, cfg: TransformerConfig, cos, sin, use_rope: bool,
              tp: int = 1):
    """Normed residual → RoPE'd (q, k, v), each (B, S, heads, hd); under
    ``tp`` ranks of tensor parallelism the rank's local heads."""
    B, S, _ = r.shape
    hd = cfg.resolved_head_dim
    dense = _dense(cfg)
    q = dense(r, layer["wq"]).reshape(B, S, cfg.num_attention_heads // tp,
                                      hd)
    k = dense(r, layer["wk"]).reshape(B, S, cfg.num_key_value_heads // tp,
                                      hd)
    v = dense(r, layer["wv"]).reshape(B, S, cfg.num_key_value_heads // tp,
                                      hd)
    if use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _mlp_block(r, layer, *, cfg: TransformerConfig):
    """Post-attention MLP (dense SwiGLU or top-k MoE) on the normed
    residual, shared by training, ``generate`` and the serving engine:
    ``(mlp, aux)``, ``aux`` the MoE load-balance loss (an f32 scalar;
    None for the dense MLP, which adds no device op a layer)."""
    if cfg.n_experts:
        from ..parallel.expert import moe_mlp
        return moe_mlp(r, layer["w_router"], layer["w_gate"],
                       layer["w_up"], layer["w_down"], axis=cfg.ep_axis,
                       capacity_factor=cfg.moe_capacity_factor,
                       dispatch=cfg.moe_dispatch,
                       group_size=cfg.moe_group_size, top_k=cfg.moe_top_k,
                       matmul_precision=cfg.matmul_precision,
                       router_z_ratio=(cfg.moe_router_z_weight
                                       / cfg.moe_aux_weight
                                       if cfg.moe_router_z_weight else 0.0))
    dense = _dense(cfg)
    h = torch.nn.functional.silu(dense(r, layer["w_gate"])) \
        * dense(r, layer["w_up"])
    # the down projection's output only joins the residual add, whose
    # backward reads neither operand: no remat policy keeps it
    with not_kept():
        mlp = dense(h, layer["w_down"])
    return mlp, None


def rope_flags(cfg: TransformerConfig) -> list[bool]:
    """Per-layer use-RoPE flags (NoPE on every ``nope_interval``-th)."""
    return [(li + 1) % cfg.nope_interval != 0 if cfg.nope_interval
            else True for li in range(cfg.num_hidden_layers)]


def layer_params(params: dict, li: int) -> dict:
    """Layer ``li``'s leaves, sliced from the stacked ``(L, …)`` tensors
    (views — no copy).  A ``QuantizedWeight`` leaf is sliced field by
    field: indexing the NamedTuple itself would pick one of its fields."""
    return {k: (QuantizedWeight(v.q[li], v.s[li])
                if isinstance(v, QuantizedWeight) else v[li])
            for k, v in params["layers"].items()}


def _output_embedding(params: dict, cfg: TransformerConfig) -> torch.Tensor:
    """Unembedding as (vocab, H) rows (tied: the input embedding itself)."""
    w = params.get("lm_head")
    if w is None:
        return params["embed"].to(cfg.dtype)
    return w.to(cfg.dtype).T


def _attention_xla(q, k, v, scale: float) -> torch.Tensor:
    """Plain causal attention (B, S, n, hd) → (B, S, nq, hd): f32
    scores, the -1e30 mask, softmax, probabilities in q's dtype."""
    return attention_plain(q, k, v, scale)


def _axis_name(axis) -> str:
    return resolve_axis(axis).name


TP_OVERLAPS = ("none", "ring", "q8")


def _rejoin(tp_axis, tp_overlap: str):
    """The Megatron rejoin of the row-parallel partial sums over
    ``tp_axis``: ``all_reduce``, ``decomposed_all_reduce`` over the
    hidden dim (``"ring"``) or the two-shot int8 all-reduce (``"q8"``);
    every backward a full-precision all_reduce of the cotangent."""
    if tp_overlap == "ring":
        return lambda v: C.decomposed_all_reduce(v, tp_axis, axis=-1)
    if tp_overlap == "q8":
        return lambda v: quantized_all_reduce(v, tp_axis)
    if tp_overlap != "none":
        raise ValueError(f"tp_overlap={tp_overlap!r}; choose from "
                         f"{TP_OVERLAPS}")
    return lambda v: C.all_reduce(v, tp_axis)


def _layer_body(x, layer, *, cfg: TransformerConfig, cos, sin,
                use_rope: bool, tp_axis=None, tp_overlap: str = "none"):
    """One decoder layer on the residual stream x (B, S, H): ``(new
    residual, aux)``, ``aux`` the MLP's load-balance loss (None for
    the dense MLP).

    ``tp_axis``: Megatron tensor parallelism (``parallel/tensor.py``).
    ``layer`` holds this rank's shards (wq, wk, wv, w_gate, w_up split
    along their output dim, wo and w_down along their input dim; an
    expert bank inside each expert), attention runs on the rank's
    ``nq/tp`` query and ``nkv/tp`` KV heads, and the two row-parallel
    outputs are rejoined over ``tp_axis`` (:func:`_rejoin`) before they
    enter the residual stream.  Without ``tp_axis`` the layer makes no
    collective call."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    tp = axis_size(tp_axis) if tp_axis is not None else 1
    r = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = _qkv_proj(r, layer, cfg=cfg, cos=cos, sin=sin,
                        use_rope=use_rope, tp=tp)
    scale = 1.0 / math.sqrt(hd)
    if cfg.attention_impl == "flash":
        attend = flash_attention
    elif cfg.attention_impl == "ring":
        def attend(q, k, v, scale):
            return ring_attention(q, k, v, cfg.sp_axis, scale=scale,
                                  block_q=cfg.ring_block_q or None,
                                  layout=cfg.ring_layout)
    elif cfg.remat and cfg.remat_policy == "save_attn":
        attend = attention_saved   # one op, so the policy can keep it
    else:
        attend = _attention_xla
    attn = attend(q, k, v, scale).to(x.dtype)
    attn_out = _dense(cfg)(attn.reshape(B, S, q.shape[2] * hd), layer["wo"])
    if tp_axis is not None:
        rejoin = _rejoin(tp_axis, tp_overlap)
        with record_function("tp_attn_psum"):
            attn_out = rejoin(attn_out)
    x = x + attn_out
    r = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    if tp_axis is not None and cfg.n_experts and cfg.ep_axis is not None:
        raise ValueError("shard experts over ep OR split them over "
                         "tp, not both (ep_axis and tp_axis set)")
    # under TP each rank holds every expert's F/tp slice: routing and
    # dispatch are replicated over the tp group, the expert products give
    # partial sums, and one rejoin after the combine adds them
    mlp, aux = _mlp_block(r, layer, cfg=cfg)
    if tp_axis is not None:
        with record_function("tp_moe_psum" if cfg.n_experts
                             else "tp_mlp_psum"):
            mlp = rejoin(mlp)
    return x + mlp, aux


# int8 precisions whose projection runs K4 on the pre-quantised operands
# (the reference's XLA int8 dot), and the plain fp8 recipe (its XLA fp8
# dot): save_dots keeps their products, as the reference does; at the
# *_pallas precisions a kernel runs, which the reference's
# dots_with_no_batch_dims_saveable does not see, so it keeps none
_DOT_PRECISIONS = {"int8": INT8_DENSE_OP, "int8_bwd": INT8_DENSE_OP,
                   "fp8": FP8_DENSE_OP, "fp8_delayed": FP8_DENSE_OP}
_NOT_KEPT = {"on": False}
_KEPT_LOG: dict = {"entries": None}


@contextlib.contextmanager
def not_kept():
    """Ops dispatched inside are never kept by a remat policy: the
    projection outputs no backward reads (the MLP's down projection),
    which the reference's policies, choosing among residuals, never
    keep either."""
    old = _NOT_KEPT["on"]
    _NOT_KEPT["on"] = True
    try:
        yield
    finally:
        _NOT_KEPT["on"] = old


def _saved_ops(cfg: TransformerConfig):
    """The dispatcher ops whose outputs ``cfg.remat_policy`` keeps (None:
    keep none, the plain checkpoint of ``"full"``), at each precision as
    the reference keeps them (its ``print_saved_residuals`` on
    ``lm_loss``):

    * ``save_attn``: the attention op;
    * ``save_dots``: at bf16 the projections' ``aten.mm``; at ``int8``,
      ``int8_bwd``, ``fp8``, ``fp8_delayed`` the projection op
      (``ops.quant.INT8_DENSE_OP``: K4's output where the reference keeps
      its dot's int32 accumulator; ``FP8_DENSE_OP``: the f32 product);
      at ``int8_pallas``, ``int8_pallas_bwd``, ``fp8_pallas`` nothing;
    * ``save_dots_q8``: the round-trip's int8 codes and f32 scales at
      every precision (``DOT_Q8_OP``, each projection fused with its
      round-trip)."""
    policy = cfg.remat_policy
    if policy == "full":
        return None
    if policy == "save_attn":
        return {ATTENTION_OP}
    precision = cfg.matmul_precision
    if policy == "save_dots":
        if precision == "bf16":
            # dots with no batch dims: the (B·S, K) x (K, N) projections;
            # attention's batched einsums are aten.bmm, not kept
            return {torch.ops.aten.mm.default}
        if precision not in _DOT_PRECISIONS:
            return None   # a kernel is no dot: save_dots keeps what full keeps
        return {_DOT_PRECISIONS[precision]}
    return {DOT_Q8_OP}


class _KeptLog(TorchDispatchMode):
    """In a checkpointed forward, the outputs of the ops ``saved`` keeps
    (shape, dtype, op name), appended to ``entries``."""

    def __init__(self, saved, entries: list):
        super().__init__()
        self.saved, self.entries = saved, entries

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.saved and not _NOT_KEPT["on"]:
            self.entries.extend(
                (tuple(t.shape), t.dtype, str(func))
                for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def record_kept():
    """Yields a list that collects what every remat policy entered inside
    keeps in its forward: one ``(shape, dtype, op)`` entry a kept tensor
    (a policy's cache, which the checkpoint's own saved-tensor hooks
    shadow from any outer ``saved_tensors_hooks``).  Its bytes are the
    activation memory the policy adds over ``"full"``."""
    old = _KEPT_LOG["entries"]
    _KEPT_LOG["entries"] = entries = []
    try:
        yield entries
    finally:
        _KEPT_LOG["entries"] = old


def kept_bytes(entries) -> int:
    """The bytes of :func:`record_kept`'s entries."""
    return sum(math.prod(shape) * torch.empty((), dtype=dt).element_size()
               for shape, dt, _ in entries)


def resolve_remat_policy(cfg: TransformerConfig):
    """``cfg.remat_policy`` → a wrapper ``(fn, *args) -> fn(*args)``
    around one layer (the reference's mapping onto ``jax.checkpoint``
    policies, ``:565-595``).  Each is ``torch.utils.checkpoint``,
    non-reentrant, with early stopping off, so that every operation of
    the layer not kept, its kernels included, runs again in the
    backward.  ``"full"``, and ``"save_dots"`` at a ``*_pallas``
    precision, keep nothing; the others are selective checkpoints
    (``create_selective_checkpoint_contexts``) that keep the outputs of
    the ops :func:`_saved_ops` names, outside a :func:`not_kept` block,
    and recompute the rest: ``"save_attn"`` the attention op, so the
    forward attention runs once; ``"save_dots"`` the projections' products
    (bf16 ``aten.mm``; the int8 and fp8 projection ops where the
    reference's XLA dots run); ``"save_dots_q8"`` each projection's int8
    codes and f32 scales.

    The recompute re-runs everything not kept: under ``save_dots`` and
    ``save_dots_q8`` that includes the attention forward, as the
    reference's policies do (its splash kernel is no dot and is not
    named), and the MLP's down projection, which no policy keeps (a
    selective checkpoint replays every op it does not keep, where XLA
    drops one whose output no backward reads).  The host offload of
    the kept activations (the reference's ``offload_activations``) is
    not ported; ``parallel.fsdp`` refuses its ``offload="opt_act"``
    (A12)."""
    check_supported(cfg)
    saved = _saved_ops(cfg)
    context_fn = None
    if saved is not None:
        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE
                    if op in saved and not _NOT_KEPT["on"]
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        def context_fn():
            fwd, rec = create_selective_checkpoint_contexts(policy)
            entries = _KEPT_LOG["entries"]
            if entries is None:
                return fwd, rec

            @contextlib.contextmanager
            def logged():
                with fwd, _KeptLog(saved, entries):
                    yield
            return logged(), rec

    def remat(fn, *args):
        kw = {} if context_fn is None else {"context_fn": context_fn}
        with set_checkpoint_early_stop(False):
            return checkpoint(fn, *args, use_reentrant=False, **kw)

    return remat


def hidden_states(params: dict, input_ids: torch.Tensor,
                  cfg: TransformerConfig, *, layer_hook=None,
                  layer_body=None, return_aux: bool = False):
    """Trunk only: (B, S) ids → final-norm hidden states (B, S, H);
    with ``return_aux`` also the layers' aux losses summed (the MoE
    load-balance term; 0 for dense layers).  The reference scans the
    stacked layers; here a Python loop slices them, each layer
    checkpointed when ``cfg.remat``.

    ``layer_hook(layer_params) -> layer_params`` runs inside the
    checkpointed layer body, before the layer computes: the seam where
    FSDP gathers a layer's full weights from its shards.  Under remat
    the hook, its gathers included, runs again in the backward, and the
    gathered weights do not outlive the layer.

    ``layer_body`` replaces ``_layer_body`` (same signature): the seam
    where tensor parallelism runs the layer on its shards
    (``parallel.tensor.tp_lm_loss``).  Under sequence parallelism
    (``cfg.sp_axis``) S is the rank's chunk and RoPE sees its global
    positions: ``rank · S`` onward for a contiguous chunk, the stripe pair's
    (``ops.ring_attention.zigzag_positions``) for zigzag."""
    check_supported(cfg)
    S = input_ids.shape[1]
    apply_layer = layer_body or _layer_body
    x = params["embed"].to(cfg.dtype)[input_ids.long()]
    if cfg.sp_axis is not None and cfg.ring_layout == "zigzag":
        cos, sin = _rope_tables(S, cfg.resolved_head_dim, cfg.rope_theta,
                                device=x.device,
                                positions=zigzag_positions(cfg.sp_axis, S,
                                                           device=x.device))
    else:
        offset = axis_rank(cfg.sp_axis) * S if cfg.sp_axis is not None else 0
        cos, sin = _rope_tables(S, cfg.resolved_head_dim, cfg.rope_theta,
                                offset, device=x.device)
    remat = resolve_remat_policy(cfg) if cfg.remat else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, use_rope in enumerate(rope_flags(cfg)):
        layer = layer_params(params, li)

        def body(x, layer, use_rope=use_rope):
            if layer_hook is not None:
                layer = layer_hook(layer)
            return apply_layer(x, layer, cfg=cfg, cos=cos, sin=sin,
                               use_rope=use_rope)

        x, a = remat(body, x, layer) if remat else body(x, layer)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x, aux) if return_aux else x


def forward(params: dict, input_ids: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """(B, S) ids → logits (B, S, vocab) in ``cfg.dtype``."""
    x = hidden_states(params, input_ids, cfg)
    return x @ _output_embedding(params, cfg).T


def chunked_softmax_xent(x: torch.Tensor, w_vocab: torch.Tensor,
                         labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean cross-entropy of ``x @ w_vocab.T`` against ``labels``
    without the (B, S, vocab) logits: vocab chunks stream through an
    online logsumexp, the gold logit gathered as its chunk passes, each
    chunk checkpointed so the backward also holds one chunk of logits.

    The chunk logits are f32, as the reference's
    ``preferred_element_type=f32``: both operands are upcast to f32
    (exact for bf16) and multiplied in f32 — with TF32 off, the sum is
    a true f32 sum.  The reference pads the last chunk with zero rows
    and masks them to -inf; here the last chunk is shorter, which
    computes the same function."""
    V = w_vocab.shape[0]
    B, S, _ = x.shape
    xf = x.float()
    labels = labels.long()

    def body(m, s, gold, w_c, c0):
        logits = xf @ w_c.float().T
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[..., None]).sum(dim=-1)
        idx = labels - c0
        hit = (idx >= 0) & (idx < logits.shape[-1])
        g = logits.gather(-1, idx.clamp(0, logits.shape[-1] - 1)[..., None])
        gold = gold + torch.where(hit, g[..., 0], 0.0)
        return m_new, s, gold

    m = torch.full((B, S), -math.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    gold = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for c0 in range(0, V, chunk):
        m, s, gold = checkpoint(body, m, s, gold, w_vocab[c0:c0 + chunk],
                                c0, use_reentrant=False)
    return torch.mean(torch.log(s) + m - gold)


def xent_from_hidden(x: torch.Tensor, w_vocab: torch.Tensor,
                     labels: torch.Tensor, *,
                     chunk: int | None = None) -> torch.Tensor:
    """Mean causal-LM cross-entropy from final hidden states:
    streamed-vocab when ``chunk`` is set; otherwise dense, with the
    logits in ``x``'s dtype cast to f32 as the reference does."""
    if chunk:
        return chunked_softmax_xent(x, w_vocab, labels, chunk)
    logits = (x @ w_vocab.T).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def lm_loss(params: dict, batch, cfg: TransformerConfig, *,
            layer_hook=None, layer_body=None) -> torch.Tensor:
    """Causal-LM cross-entropy of ``batch`` = (input_ids, labels), both
    (B, S) (``layer_hook``, ``layer_body``: see :func:`hidden_states`),
    plus ``moe_aux_weight`` times the layers' summed aux loss for an MoE
    config."""
    input_ids, labels = batch
    x, aux = hidden_states(params, input_ids, cfg, layer_hook=layer_hook,
                           layer_body=layer_body, return_aux=True)
    loss = xent_from_hidden(x, _output_embedding(params, cfg), labels,
                            chunk=cfg.loss_vocab_chunk)
    if cfg.n_experts:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def model_flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    return get_model_flops_per_token(cfg, seq_len)
