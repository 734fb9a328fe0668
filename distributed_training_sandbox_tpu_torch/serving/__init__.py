from .accounting import (kv_bytes_per_step, page_bytes, serve_waterline_gb,
                         weight_read_bytes)
from .engine import ServingEngine, serve
from .kv_pool import PageAllocator, PagedKVPool, PoolBuffers
from .scheduler import ContinuousBatcher, Request, reset_for_replay

__all__ = ["ContinuousBatcher", "PageAllocator", "PagedKVPool",
           "PoolBuffers", "Request", "ServingEngine", "kv_bytes_per_step",
           "page_bytes", "reset_for_replay", "serve", "serve_waterline_gb",
           "weight_read_bytes"]
