from .accounting import (kv_bytes_per_step, page_bytes, pool_capacity_pages,
                         serve_waterline_gb, weight_read_bytes)
from .engine import ServingEngine, make_draft_params, serve
from .fleet import Fleet, Replica
from .kv_pool import (PageAllocator, PagedKVPool, PoolBuffers,
                      RadixPrefixCache)
from .router import AdmissionController, Rejection, Router
from .scheduler import ContinuousBatcher, Request, reset_for_replay
from .traces import (TraceRequest, build_fleet_trace, build_tenant_trace,
                     build_trace, trace_digest)

__all__ = ["AdmissionController", "ContinuousBatcher", "Fleet",
           "PageAllocator", "PagedKVPool", "PoolBuffers", "RadixPrefixCache",
           "Rejection", "Replica", "Request", "Router", "ServingEngine",
           "TraceRequest", "build_fleet_trace", "build_tenant_trace",
           "build_trace", "kv_bytes_per_step", "make_draft_params",
           "page_bytes", "pool_capacity_pages", "reset_for_replay", "serve",
           "serve_waterline_gb", "trace_digest", "weight_read_bytes"]
