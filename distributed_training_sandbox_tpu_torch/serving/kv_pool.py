"""Paged KV cache pool — the port of the JAX package's
``serving/kv_pool.py``: float and int8 pools, the page allocator and the
radix prefix cache over committed pages (host Python, line for line the
reference's, so its decisions can be held against it bit for bit).

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


class _TrieNode:
    """One cached full page of prompt KV: the page-size token chunk that
    keys it under its parent, the pool page holding those positions'
    K/V rows, and the in-flight refcount."""
    __slots__ = ("key", "page", "parent", "children", "refs", "last_used")

    def __init__(self, key: tuple, page: int, parent):
        self.key = key
        self.page = page
        self.parent = parent          # _TrieNode | None (root child)
        self.children: dict = {}
        self.refs = 0
        self.last_used = 0

    @property
    def depth(self) -> int:
        d, n = 1, self.parent
        while n is not None:
            d, n = d + 1, n.parent
        return d


class RadixPrefixCache:
    """Token-trie over committed KV pages — the prefix-reuse substrate.

    Nodes are PAGE-granular: each trie edge is an exact ``page_size``
    token chunk, so a node's path from the root spells out a full-page
    prompt prefix and its ``page`` holds exactly those positions' K/V
    rows.  Content identity is positional: K/V at absolute position
    ``p`` depends only on the token at ``p`` and ``p`` itself (per-row
    bitwise independence, the engine's parity invariant), so two
    requests sharing a page-aligned token prefix can alias the same
    pages and stay bitwise-identical to their private-cache runs.

    Ownership: pages referenced by the trie are OWNED by the trie —
    they are never on the allocator's free list and are returned to it
    only by :meth:`evict`.  Requests hold refcounts on the nodes they
    alias (``acquire``/``release``); eviction takes refcount-0 LEAF
    nodes in LRU order, so an in-flight request can never lose a page
    under it and interior nodes never orphan their children.

    Copy-on-write falls out of page granularity: the first divergent
    page has a different token chunk, so it simply isn't in the trie —
    admission allocates a fresh page for it and prefill recomputes from
    the matched boundary.  Aliased pages are never scatter targets
    (prefill starts at the matched page boundary; decode writes at
    positions past the prompt), which the CoW test pins byte-for-byte.

    The last prompt page is never cached even when full: prefill must
    run at least the final prompt position to produce the first token's
    logits, so matchable pages are capped at ``(n_prompt - 1) //
    page_size``.
    """

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = int(page_size)
        self._root: dict = {}         # key chunk -> _TrieNode
        self._nodes: list[_TrieNode] = []
        self._clock = 0
        # counters the engine mirrors into telemetry / slo_report
        self.hit_pages = 0
        self.lookup_pages = 0
        self.evictions = 0
        self.inserted_pages = 0
        # refcount-0 node count, maintained O(1) at every transition.
        # Exact reclaimability: a holder always refs its node's whole
        # prefix path, so a refs-0 node's subtree is refs-0 throughout
        # and :meth:`evict` can drain all of it leaf-first.
        self._idle_pages = 0

    # ---- queries ------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        """Pages owned by the trie (not in the allocator free list)."""
        return len(self._nodes)

    @property
    def reclaimable_pages(self) -> int:
        """Pages :meth:`evict` could free right now (refcount-0 nodes).
        ``can_accept`` credits these against a request's page grant —
        without the credit a saturated trie wedges dispatch forever
        while every replica sits idle (the fleet-sim-discovered
        livelock)."""
        return self._idle_pages

    @property
    def hit_rate(self) -> float:
        return self.hit_pages / self.lookup_pages if self.lookup_pages \
            else 0.0

    def _chunks(self, tokens) -> list[tuple]:
        p = self.page_size
        n_full = (len(tokens) - 1) // p
        return [tuple(int(t) for t in tokens[i * p:(i + 1) * p])
                for i in range(n_full)]

    def match(self, tokens) -> list[_TrieNode]:
        """Longest cached full-page prefix of ``tokens`` — the nodes
        whose pages an admitted request will alias.  Pure lookup: no
        refcounts taken, no counters (admission may retry the same
        head-of-line request many rounds; it calls :meth:`note_lookup`
        once on success)."""
        nodes: list[_TrieNode] = []
        kids = self._root
        for key in self._chunks(tokens):
            node = kids.get(key)
            if node is None:
                break
            nodes.append(node)
            kids = node.children
        return nodes

    def note_lookup(self, hit_pages: int, lookup_pages: int) -> None:
        self.hit_pages += hit_pages
        self.lookup_pages += lookup_pages

    # ---- refcounts ----------------------------------------------------
    def acquire(self, nodes: list[_TrieNode]) -> None:
        self._clock += 1
        for n in nodes:
            if n.refs == 0:
                self._idle_pages -= 1
            n.refs += 1
            n.last_used = self._clock

    def release(self, nodes: list[_TrieNode]) -> None:
        for n in nodes:
            if n.refs <= 0:
                raise ValueError("prefix-cache refcount underflow — "
                                 "double release")
            n.refs -= 1
            if n.refs == 0:
                self._idle_pages += 1

    # ---- growth -------------------------------------------------------
    def insert(self, tokens, pages: list[int],
               matched: list[_TrieNode]):
        """Donate a just-prefilled request's full-prompt pages into the
        trie.  ``pages`` is the request's page list (cached prefix
        first, then granted pages); ``matched`` the nodes it acquired at
        admission.  Returns ``(nodes, swaps)``: the full prefix-aligned
        node list (refs held by the caller) and a ``{page_index: page}``
        map for chunks a CONCURRENT twin already cached — the caller's
        duplicate page is freed and its page-table entry must be
        rewritten to the cached twin (contents are bitwise-identical,
        so the swap is invisible to decode)."""
        chunks = self._chunks(tokens)
        nodes = list(matched)
        swaps: dict[int, int] = {}
        self._clock += 1
        for i in range(len(matched), len(chunks)):
            kids = nodes[-1].children if nodes else self._root
            node = kids.get(chunks[i])
            if node is None:
                node = _TrieNode(chunks[i], pages[i],
                                 nodes[-1] if nodes else None)
                kids[chunks[i]] = node
                self._nodes.append(node)
                self.inserted_pages += 1
                self._idle_pages += 1   # born refs-0; claimed below
            elif node.page != pages[i]:
                # two requests with the same prefix prefilled
                # concurrently; adopt the cached twin, free ours
                swaps[i] = node.page
                self.allocator.free([pages[i]])
            if node.refs == 0:
                self._idle_pages -= 1
            node.refs += 1
            node.last_used = self._clock
            nodes.append(node)
        return nodes, swaps

    # ---- pressure -----------------------------------------------------
    def evict(self, n: int) -> int:
        """Free up to ``n`` pages by evicting refcount-0 LEAF nodes in
        LRU order (ties broken deepest-first so chains drain tail-in).
        Returns the number actually freed — the caller retries its
        allocation and sheds load if the trie couldn't give enough."""
        freed = 0
        while freed < n:
            victims = [nd for nd in self._nodes
                       if nd.refs == 0 and not nd.children]
            if not victims:
                break
            v = min(victims, key=lambda nd: (nd.last_used, -nd.depth))
            kids = v.parent.children if v.parent is not None \
                else self._root
            del kids[v.key]
            self._nodes.remove(v)
            self.allocator.free([v.page])
            self.evictions += 1
            self._idle_pages -= 1
            freed += 1
        return freed

    def stats(self) -> dict:
        return {"cached_pages": self.cached_pages,
                "hit_pages": self.hit_pages,
                "lookup_pages": self.lookup_pages,
                "hit_rate": round(self.hit_rate, 4),
                "evictions": self.evictions,
                "inserted_pages": self.inserted_pages}


class PagedKVPool:
    """Per-layer device pools + the page allocator.  ``kv_quant`` stores
    K and V as int8 with per-row f32 scales, initialised to ones like
    ``generate.init_cache``'s, so unwritten rows dequantise to zeros.
    ``tp``: the pool of one tensor-parallel rank, which holds its
    ``n_kv / tp`` local heads (the reference shards the head axis of one
    pool over its ``tp`` mesh axis)."""

    def __init__(self, cfg, n_pages: int, page_size: int, *,
                 kv_quant: bool = False, device, tp: int = 1):
        self.cfg = cfg
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.kv_quant = bool(kv_quant)
        self.device = torch.device(device)
        shape = (self.n_pages, self.page_size,
                 cfg.num_key_value_heads // int(tp), cfg.resolved_head_dim)
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
