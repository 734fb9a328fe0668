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
``_dense``.  Attention is ``"xla"`` (the plain
``_attention_xla``) or ``"flash"`` (the port's kernel,
``ops/flash_attention.py``); projections run at ``bf16``, the fp8
recipe or the int8 recipe (``ops/quant.py``).  The remat policies
(``resolve_remat_policy``) are the reference's four: ``"full"``,
``"save_attn"``, ``"save_dots"`` and ``"save_dots_q8"``.  Ring
attention, MoE and the activation offload are later slices (ROADMAP.md
queue A).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    set_checkpoint_early_stop)

from ..ops import collectives as C
from ..ops.flash_attention import (ATTENTION_OP, attention_plain,
                                   attention_saved, flash_attention)
from ..ops.quant import QuantizedWeight, dot_q8, resolve_quantized_dense
from ..utils.flops import get_model_flops_per_token

_ROADMAP = ("not ported yet — see ROADMAP.md, queue A item 2 (model "
            "core) and queue B (precision kernels)")
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
    # outputs; "save_dots_q8" keeps them as int8 codes and f32 scales
    # (ops/quant.dot_q8), half save_dots' bytes (resolve_remat_policy)
    remat_policy: str = "full"
    # "xla" (the plain causal attention) | "flash" (the port's kernel);
    # the reference's "ring" needs the sequence-parallel slice
    attention_impl: str = "xla"
    # None: dense f32 log-softmax over (B, S, vocab) logits; an int
    # streams the vocab in chunks of that size (chunked_softmax_xent)
    loss_vocab_chunk: int | None = None
    # "bf16" | "fp8" | "fp8_delayed" | "fp8_pallas" | "int8" |
    # "int8_pallas" | "int8_bwd" | "int8_pallas_bwd" (ops/quant.py)
    matmul_precision: str = "bf16"
    fp8_amax_history_len: int = 16
    n_experts: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


# SmolLM3-3B-class config (~3.1 B params).
SMOLLM3_3B = TransformerConfig()

# One-card flagship: the 3B geometry truncated to 8 layers, with the
# flash attention and the streamed-vocab loss.
SMOLLM3_3B_L8 = TransformerConfig(
    num_hidden_layers=8, attention_impl="flash", loss_vocab_chunk=16_032)

TINY_LM = TransformerConfig(
    vocab_size=512, hidden_size=64, intermediate_size=160,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    rope_theta=10_000.0, dtype=torch.float32, remat=False)


def check_supported(cfg: TransformerConfig) -> None:
    """Raise on the configurations the port does not run yet."""
    if cfg.matmul_precision not in PRECISIONS:
        raise NotImplementedError(
            f"matmul_precision={cfg.matmul_precision!r}: {_ROADMAP}")
    if cfg.n_experts:
        raise NotImplementedError(f"n_experts={cfg.n_experts}: {_ROADMAP}")
    if cfg.attention_impl not in ("xla", "flash"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r}: not ported yet — see "
            f"ROADMAP.md, queue A item 10 (sequence parallelism)")
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
    """The projection matmul at the configured precision
    (``ops/quant.resolve_quantized_dense``).  A weight arriving as a
    :class:`ops.collectives.RingShard` (the FSDP layer hook of the
    ring_fused modes leaves projection weights sharded along their
    contraction dim) runs as the ring's collective matmul instead:
    ``all_gather_matmul``, or its kernel twin (K7) when the shard is
    marked ``impl="pallas"``; the precision does not apply to it, as in
    the reference.

    Under remat ``"save_dots_q8"`` each projection's output makes an int8
    round-trip (``quantized_residual``, reference ``:446-447``) fused
    with its product as one op (``ops.quant.dot_q8``), whose codes and
    scales the policy keeps."""
    check_supported(cfg)
    base = resolve_quantized_dense(
        cfg.matmul_precision, fp8_history_len=cfg.fp8_amax_history_len)
    if cfg.remat and cfg.remat_policy == "save_dots_q8":
        base = dot_q8

    def dispatch(a, w):
        if isinstance(w, C.RingShard):
            if w.impl == "pallas":
                return C.all_gather_matmul_pallas(a, w.shard, w.axis_name)
            return C.all_gather_matmul(a, w.shard, w.axis_name)
        return base(a, w)

    return dispatch


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


def _layer_body(x, layer, *, cfg: TransformerConfig, cos, sin,
                use_rope: bool):
    """One decoder layer on the residual stream x (B, S, H).  The
    reference's tensor-parallel arguments and MoE aux loss are not
    ported, so it returns the new residual only."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    r = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = _qkv_proj(r, layer, cfg=cfg, cos=cos, sin=sin,
                        use_rope=use_rope)
    scale = 1.0 / math.sqrt(hd)
    if cfg.attention_impl == "flash":
        attend = flash_attention
    elif cfg.remat and cfg.remat_policy == "save_attn":
        attend = attention_saved   # one op, so the policy can keep it
    else:
        attend = _attention_xla
    attn = attend(q, k, v, scale).to(x.dtype)
    x = x + _dense(cfg)(attn.reshape(B, S, cfg.num_attention_heads * hd),
                        layer["wo"])
    r = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    return x + _mlp_block(r, layer, cfg=cfg)


def _saved_ops(cfg: TransformerConfig):
    """The dispatcher ops whose outputs ``cfg.remat_policy`` keeps
    (None: ``"full"``, keep none)."""
    policy = cfg.remat_policy
    if policy == "full":
        return None
    if policy == "save_attn":
        return {ATTENTION_OP}
    if cfg.matmul_precision != "bf16":
        # the int8 and fp8_pallas projections launch kernels through
        # ctypes, which no policy sees; fp8's plain recipe is no one op
        raise NotImplementedError(
            f"remat_policy={policy!r} at matmul_precision="
            f"{cfg.matmul_precision!r}: the policy keeps the bf16 "
            f"projections only; not ported yet — see ROADMAP.md, queue A "
            f"item A2 (the remat policies)")
    if policy == "save_dots":
        # dots with no batch dims: the (B·S, K) x (K, N) projections;
        # attention's batched einsums are aten.bmm, not kept
        return {torch.ops.aten.mm.default}
    return {torch.ops.dtsb_torch.dot_q8.default}


def resolve_remat_policy(cfg: TransformerConfig):
    """``cfg.remat_policy`` → a wrapper ``(fn, *args) -> fn(*args)``
    around one layer (the reference's mapping onto ``jax.checkpoint``
    policies, ``:565-595``).  Each is ``torch.utils.checkpoint``,
    non-reentrant, with early stopping off, so that every operation of
    the layer not kept, its kernels included, runs again in the
    backward.  ``"full"`` keeps nothing; the others are selective
    checkpoints (``create_selective_checkpoint_contexts``) that keep the
    outputs of named ops and recompute the rest:

    * ``"save_attn"``: the attention op (``ATTENTION_OP``, the flash
      kernel's or the plain one's), so the forward attention runs once;
    * ``"save_dots"``: ``aten.mm``, the projections (bf16 only);
    * ``"save_dots_q8"``: ``dtsb_torch::dot_q8``, each projection's int8
      codes and f32 scales (bf16 only; see ``_dense``).

    The recompute re-runs everything not kept: under ``save_dots`` and
    ``save_dots_q8`` that includes the attention forward, as the
    reference's policies do (its splash kernel is no dot and is not
    named).  ``save_dots`` and ``save_dots_q8`` at the other precisions
    raise.  The host offload of the kept activations (the reference's
    ``offload_activations``) is not ported; ``parallel.fsdp`` refuses
    its ``offload="opt_act"`` (A12)."""
    check_supported(cfg)
    saved = _saved_ops(cfg)
    context_fn = None
    if saved is not None:
        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       policy)

    def remat(fn, *args):
        kw = {} if context_fn is None else {"context_fn": context_fn}
        with set_checkpoint_early_stop(False):
            return checkpoint(fn, *args, use_reentrant=False, **kw)

    return remat


def hidden_states(params: dict, input_ids: torch.Tensor,
                  cfg: TransformerConfig, *, layer_hook=None
                  ) -> torch.Tensor:
    """Trunk only: (B, S) ids → final-norm hidden states (B, S, H).
    The reference scans the stacked layers; here a Python loop slices
    them, each layer checkpointed when ``cfg.remat``.

    ``layer_hook(layer_params) -> layer_params`` runs inside the
    checkpointed layer body, before the layer computes: the seam where
    FSDP gathers a layer's full weights from its shards.  Under remat
    the hook, its gathers included, runs again in the backward, and the
    gathered weights do not outlive the layer."""
    check_supported(cfg)
    S = input_ids.shape[1]
    x = params["embed"].to(cfg.dtype)[input_ids.long()]
    cos, sin = _rope_tables(S, cfg.resolved_head_dim, cfg.rope_theta,
                            device=x.device)
    remat = resolve_remat_policy(cfg) if cfg.remat else None
    for li, use_rope in enumerate(rope_flags(cfg)):
        layer = layer_params(params, li)

        def body(x, layer, use_rope=use_rope):
            if layer_hook is not None:
                layer = layer_hook(layer)
            return _layer_body(x, layer, cfg=cfg, cos=cos, sin=sin,
                               use_rope=use_rope)

        x = remat(body, x, layer) if remat else body(x, layer)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


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
            layer_hook=None) -> torch.Tensor:
    """Causal-LM cross-entropy of ``batch`` = (input_ids, labels), both
    (B, S) (``layer_hook``: see :func:`hidden_states`)."""
    input_ids, labels = batch
    x = hidden_states(params, input_ids, cfg, layer_hook=layer_hook)
    return xent_from_hidden(x, _output_embedding(params, cfg), labels,
                            chunk=cfg.loss_vocab_chunk)


def model_flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    return get_model_flops_per_token(cfg, seq_len)
