"""Paged KV cache pool — the port of the JAX package's
``serving/kv_pool.py`` (float and int8 pools; the radix prefix cache is
a later slice).

  * per-layer POOLS of page blocks, ``(n_pages, page_size, n_kv, hd)``
    tensors in ``cfg.dtype`` on one device, or int8 with f32
    ``(n_pages, page_size, n_kv, 1)`` row scales (``kv_quant``);
  * a host-side PAGE TABLE per request slot: absolute position ``p`` of
    a request lives at ``(page_table[slot, p // page_size],
    p % page_size)``;
  * page 0 is RESERVED as the null page: writes for padded or inactive
    positions are diverted there, and unassigned page-table entries
    point at it, so reads of dead slots land on masked garbage, never
    out of bounds.

The reference's jitted steps donated the pool buffers and returned new
ones; here the steps write into the pool tensors in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PoolBuffers(NamedTuple):
    """The device half of the pool: per-layer page-block tensors, and
    for an int8 pool their per-row f32 scales."""
    k: tuple            # L × (n_pages, page_size, n_kv, hd)
    v: tuple
    k_scale: tuple | None = None   # L × (n_pages, page_size, n_kv, 1)
    v_scale: tuple | None = None


class PageAllocator:
    """Host-side free list over pages ``1..n_pages-1`` (page 0 is the
    reserved null page).  LIFO reuse; allocation is all-or-nothing so a
    request can never deadlock holding a partial page set."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (1 null + 1 usable), "
                             f"got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))

    def alloc(self, n: int) -> list[int] | None:
        """``n`` pages or None — never a partial grant."""
        if n <= 0:
            raise ValueError(f"alloc({n})")
        if len(self._free) < n:
            return None
        got = self._free[-n:]
        del self._free[-n:]
        return got

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"freeing invalid page {p}")
        self._free.extend(pages)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def utilization(self) -> float:
        usable = self.n_pages - 1
        return self.pages_in_use / usable if usable else 0.0


class PagedKVPool:
    """Per-layer device pools + the page allocator.  ``kv_quant`` stores
    K and V as int8 with per-row f32 scales, initialised to ones like
    ``generate.init_cache``'s, so unwritten rows dequantise to zeros."""

    def __init__(self, cfg, n_pages: int, page_size: int, *,
                 kv_quant: bool = False, device):
        self.cfg = cfg
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.kv_quant = bool(kv_quant)
        self.device = torch.device(device)
        shape = (self.n_pages, self.page_size, cfg.num_key_value_heads,
                 cfg.resolved_head_dim)
        L = cfg.num_hidden_layers
        dt = torch.int8 if self.kv_quant else cfg.dtype

        def zeros():
            return tuple(torch.zeros(shape, dtype=dt, device=self.device)
                         for _ in range(L))

        def ones():
            return tuple(torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                                    device=self.device) for _ in range(L))

        sc = (ones(), ones()) if self.kv_quant else (None, None)
        self.bufs = PoolBuffers(k=zeros(), v=zeros(), k_scale=sc[0],
                                v_scale=sc[1])
        self.allocator = PageAllocator(self.n_pages)

    @property
    def utilization(self) -> float:
        return self.allocator.utilization
