"""Serving byte accounting — the port of the JAX package's
``serving/accounting.py`` formulas the engine and the measurements use.
Sizes come from the torch dtype of the config."""

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


def page_bytes(cfg, page_size: int, *, kv_quant: bool = False) -> int:
    """Bytes ONE page occupies across every layer's K and V pool, plus
    the f32 row scales of an int8 pool."""
    elems = page_size * cfg.num_hidden_layers * cfg.num_key_value_heads \
        * cfg.resolved_head_dim * 2
    if kv_quant:
        return elems + (elems // cfg.resolved_head_dim) * 4
    return elems * _itemsize(cfg.dtype)


def serve_waterline_gb(cfg, n_pages: int, page_size: int, *,
                       weight_bytes: int = 0, kv_quant: bool = False) -> float:
    """Static serving memory waterline: resident weights + the paged KV
    pool."""
    return (weight_bytes + n_pages * page_bytes(cfg, page_size,
                                                kv_quant=kv_quant)) / GB


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a dict / tuple tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
