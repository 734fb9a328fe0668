"""Paged KV cache pool — the port of the JAX package's
``serving/kv_pool.py`` (float pools; the radix prefix cache is a later
slice).

  * per-layer POOLS of page blocks, ``(n_pages, page_size, n_kv, hd)``
    tensors in ``cfg.dtype`` on one device;
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
    """The device half of the pool: per-layer page-block tensors."""
    k: tuple            # L × (n_pages, page_size, n_kv, hd)
    v: tuple


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
    """Per-layer device pools + the page allocator."""

    def __init__(self, cfg, n_pages: int, page_size: int, *, device):
        self.cfg = cfg
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.device = torch.device(device)
        shape = (self.n_pages, self.page_size, cfg.num_key_value_heads,
                 cfg.resolved_head_dim)

        def zeros():
            return tuple(torch.zeros(shape, dtype=cfg.dtype,
                                     device=self.device)
                         for _ in range(cfg.num_hidden_layers))

        self.bufs = PoolBuffers(k=zeros(), v=zeros())
        self.allocator = PageAllocator(self.n_pages)

    @property
    def utilization(self) -> float:
        return self.allocator.utilization
