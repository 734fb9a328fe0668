"""Serving byte accounting — the port of the JAX package's
``serving/accounting.py``: the per-step read formulas of the decode
roofline, and the pool capacity planner (weights + pool + headroom, the
draft model's terms included).  Sizes come from the torch dtype of the
config; ``tp`` prices one tensor-parallel rank's pool, which holds
``n_kv / tp`` local heads (the engine under ``mesh``)."""

from __future__ import annotations

import torch

GB = 1024 ** 3


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kv_bytes_per_step(cfg, batch: int, s_max: int,
                      kv_quant: bool = False) -> int:
    """Bytes the gather path READS from the KV cache per decode step:
    batch × S_max × layers × n_kv × hd × 2 (K and V) × itemsize — the
    whole fixed view, masked or not.  An int8 cache reads one byte an
    element plus the f32 row scales (4 bytes per hd elements); the
    reference counts a float cache as bf16."""
    elems = batch * s_max * cfg.num_hidden_layers \
        * cfg.num_key_value_heads * cfg.resolved_head_dim * 2
    if kv_quant:
        return elems + (elems // cfg.resolved_head_dim) * 4
    return elems * _itemsize(cfg.dtype)


def weight_read_bytes(cfg, params, wb: int) -> int:
    """Weight bytes a decode step reads: with a separate unembedding
    (int8 decode's ``unembed_q``, or an untied ``lm_head``) the
    embedding table is only gathered, so its bytes drop out; tied decode
    reads it as the unembedding."""
    if "unembed_q" in params or "lm_head" in params:
        return wb - cfg.vocab_size * cfg.hidden_size * _itemsize(cfg.dtype)
    return wb


def page_bytes(cfg, page_size: int, *, kv_quant: bool = False,
               tp: int = 1) -> int:
    """Bytes ONE page occupies across every layer's K and V pool:
    page_size × layers × (n_kv/tp local heads) × hd × 2 × itemsize,
    plus the f32 row scales of an int8 pool.  The unit the capacity
    planner divides the budget by."""
    nkv = cfg.num_key_value_heads // tp
    elems = page_size * cfg.num_hidden_layers * nkv \
        * cfg.resolved_head_dim * 2
    if kv_quant:
        return elems + (elems // cfg.resolved_head_dim) * 4
    return elems * _itemsize(cfg.dtype)


def serve_waterline_gb(cfg, n_pages: int, page_size: int, *,
                       weight_bytes: int = 0, kv_quant: bool = False,
                       tp: int = 1, draft_weight_bytes: int = 0,
                       draft_cfg=None) -> float:
    """Static serving memory waterline: resident weights + the paged KV
    pool.  Speculative decoding adds the draft's weights and the draft's
    own pool, which mirrors the target's page table (same ``n_pages``
    and ``page_size``, the draft config's layers).  Prefix sharing adds
    nothing: aliased pages are the same physical pages."""
    pool = n_pages * page_bytes(cfg, page_size, kv_quant=kv_quant, tp=tp)
    if draft_cfg is not None:
        pool += n_pages * page_bytes(draft_cfg, page_size,
                                     kv_quant=kv_quant, tp=tp)
    return (weight_bytes + draft_weight_bytes + pool) / GB


def pool_capacity_pages(cfg, page_size: int, *, budget_gb: float,
                        weight_bytes: int = 0, kv_quant: bool = False,
                        tp: int = 1,
                        headroom_fraction: float = 0.10,
                        draft_weight_bytes: int = 0,
                        draft_cfg=None) -> int:
    """Pages that fit ``budget_gb`` once the weights are resident, with
    ``headroom_fraction`` of the budget held back for the decode step's
    working set — the inverse of :func:`serve_waterline_gb`: at the
    returned page count the waterline stays within the usable budget.
    Returns 0 when the weights alone exceed it.  With a draft resident,
    its weights come off the top and each page costs its target page
    plus its draft-pool twin."""
    usable = budget_gb * GB * (1.0 - headroom_fraction) \
        - weight_bytes - draft_weight_bytes
    if usable <= 0:
        return 0
    per_page = page_bytes(cfg, page_size, kv_quant=kv_quant, tp=tp)
    if draft_cfg is not None:
        per_page += page_bytes(draft_cfg, page_size, kv_quant=kv_quant,
                               tp=tp)
    return int(usable // per_page)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a dict / tuple tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
