"""Serving byte accounting — the port of the JAX package's
``serving/accounting.py`` formulas the engine and the measurements use.
Sizes come from the torch dtype of the config."""

from __future__ import annotations

import torch

GB = 1024 ** 3


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kv_bytes_per_step(cfg, batch: int, s_max: int) -> int:
    """Bytes the gather path READS from the KV cache per decode step:
    batch × S_max × layers × n_kv × hd × 2 (K and V) × itemsize — the
    whole fixed view, masked or not."""
    elems = batch * s_max * cfg.num_hidden_layers \
        * cfg.num_key_value_heads * cfg.resolved_head_dim * 2
    return elems * _itemsize(cfg.dtype)


def weight_read_bytes(cfg, params, wb: int) -> int:
    """Weight bytes a decode step reads: with a separate unembedding
    (an untied ``lm_head``) the embedding table is only gathered, so
    its bytes drop out; tied decode reads it as the unembedding."""
    if "lm_head" in params:
        return wb - cfg.vocab_size * cfg.hidden_size * _itemsize(cfg.dtype)
    return wb


def page_bytes(cfg, page_size: int) -> int:
    """Bytes ONE page occupies across every layer's K and V pool."""
    return page_size * cfg.num_hidden_layers * cfg.num_key_value_heads \
        * cfg.resolved_head_dim * 2 * _itemsize(cfg.dtype)


def serve_waterline_gb(cfg, n_pages: int, page_size: int, *,
                       weight_bytes: int = 0) -> float:
    """Static serving memory waterline: resident weights + the paged KV
    pool."""
    return (weight_bytes + n_pages * page_bytes(cfg, page_size)) / GB


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a dict / tuple tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
