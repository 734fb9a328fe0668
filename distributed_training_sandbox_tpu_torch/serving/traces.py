"""Shared traffic-trace generators — a copy of the JAX package's
``serving/traces.py`` (numpy only; the port keeps its own copy and
imports nothing of that package).  The serve bench twin
(``train/serve_bench.py``) draws its traffic here.

The rng call order and distributions are the reference's, unchanged, so
a given seed produces byte-identical traces in both packages (the
digest of the drawn stream, :func:`trace_digest`, is the contract).
:func:`build_fleet_trace` scales the traffic model to fleet size:
diurnal rate modulation, Zipf tenant skew, flash crowds.

Everything draws from ONE ``numpy.random.Generator`` passed by the
caller, and nothing here reads a clock: arrivals are virtual seconds
from t=0, so shed sets, cache-hit rates and p99s reproduce from the
seed alone.
"""

from __future__ import annotations

import hashlib
import math
import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["TraceRequest", "build_trace", "build_tenant_trace",
           "build_fleet_trace", "trace_digest"]


@dataclass(frozen=True)
class TraceRequest:
    """One offered request on the virtual clock.  ``tenant`` is -1 for
    anonymous (non-tenant) traffic; otherwise the index of the system
    prompt the request opens with."""
    arrival_s: float
    prompt: np.ndarray
    max_new: int
    tenant: int = -1


def build_tenant_trace(rng, n_requests: int, rate: float, vocab: int,
                       max_seq_len: int, *, tenants: int = 0,
                       overlap_frac: float = 0.0, sys_len: int = 16
                       ) -> list[TraceRequest]:
    """The serve_bench generator with tenant attribution: Poisson
    arrivals, bimodal prompt lengths (70 % chat-short 4–16, 30 %
    document-long 24–48, clipped to capacity), 4–24 new tokens.

    Tenant-skewed mode (``tenants > 0``): each of ``tenants`` tenants
    owns a fixed ``sys_len``-token system prompt drawn up front; an
    ``overlap_frac`` fraction of requests opens with a (uniformly
    chosen) tenant's system prompt followed by a unique user suffix —
    the traffic shape the radix prefix cache exists for.  Everything
    is drawn from the one seeded ``rng``, so cache-hit rates and TTFT
    deltas reproduce run-to-run from the seed alone.

    The rng call order is the serve_bench original's, unchanged —
    tenant ids fall out of draws that already happen, so recording
    them costs nothing and the byte-identity pin holds.
    """
    sys_prompts = [rng.integers(1, vocab, size=sys_len).astype("int32")
                   for _ in range(tenants)]
    t = 0.0
    trace = []
    for _ in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        new = int(rng.integers(4, 25))
        tenant = -1
        if sys_prompts and rng.random() < overlap_frac:
            tenant = int(rng.integers(len(sys_prompts)))
            head = sys_prompts[tenant]
            tail = rng.integers(1, vocab,
                                size=int(rng.integers(4, 17)))
            prompt = np.concatenate(
                [head, tail.astype("int32")])[:max_seq_len - new]
        else:
            long = rng.random() < 0.3
            plen = int(rng.integers(24, 49) if long
                       else rng.integers(4, 17))
            plen = min(plen, max_seq_len - new)
            prompt = rng.integers(1, vocab, size=plen).astype("int32")
        trace.append(TraceRequest(t, prompt, new, tenant))
    return trace


def build_trace(rng, n_requests: int, rate: float, vocab: int,
                max_seq_len: int, *, tenants: int = 0,
                overlap_frac: float = 0.0, sys_len: int = 16):
    """(arrival_s, prompt, max_new) triples — serve_bench's historical
    interface, backed by the same draw stream as
    :func:`build_tenant_trace` (the tenant id is simply not carried)."""
    return [(r.arrival_s, r.prompt, r.max_new)
            for r in build_tenant_trace(
                rng, n_requests, rate, vocab, max_seq_len,
                tenants=tenants, overlap_frac=overlap_frac,
                sys_len=sys_len)]


def _zipf_cdf(n: int, skew: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** float(skew)
    return np.cumsum(w / w.sum())


def build_fleet_trace(rng, n_requests: int, *, base_rate: float,
                      vocab: int, max_seq_len: int, tenants: int = 8,
                      overlap_frac: float = 0.6, sys_len: int = 16,
                      tenant_skew: float = 1.1,
                      diurnal_amplitude: float = 0.6,
                      diurnal_period_s: float | None = None,
                      flash_crowds: tuple = (),
                      ) -> list[TraceRequest]:
    """Fleet-scale trace for the simulator: a non-homogeneous Poisson
    process whose instantaneous rate follows a diurnal sinusoid around
    ``base_rate`` (peak/trough ratio set by ``diurnal_amplitude``),
    with optional flash crowds — ``(start_s, duration_s, multiplier)``
    windows that multiply the rate — and Zipf-skewed tenant choice
    (exponent ``tenant_skew``: tenant 0 is the whale, the tail starves,
    which is exactly what the per-tenant fairness report must surface).

    ``diurnal_period_s`` defaults to the mean span of the whole trace
    (one "day" over the run), so the sim sees a full peak AND trough
    regardless of request count.  Arrivals are drawn by inverting the
    local rate — dt ~ Exp(1/rate(t)) — which is exact enough for
    traffic shaping and keeps generation O(n) with one rng draw per
    field, so a 10^6-request trace builds in well under a minute.
    """
    if tenants < 1:
        raise ValueError("build_fleet_trace needs tenants >= 1")
    if diurnal_period_s is None:
        diurnal_period_s = max(n_requests / float(base_rate), 1e-9)
    cdf = _zipf_cdf(tenants, tenant_skew)
    sys_prompts = [rng.integers(1, vocab, size=sys_len).astype("int32")
                   for _ in range(tenants)]
    crowds = [(float(s), float(s) + float(d), float(m))
              for s, d, m in flash_crowds]
    t = 0.0
    trace = []
    two_pi = 2.0 * math.pi
    for _ in range(n_requests):
        rate = base_rate * (
            1.0 + diurnal_amplitude
            * math.sin(two_pi * t / diurnal_period_s))
        for s, e, m in crowds:
            if s <= t < e:
                rate *= m
        rate = max(rate, 1e-3 * base_rate)
        t += float(rng.exponential(1.0 / rate))
        new = int(rng.integers(4, 25))
        tenant = int(np.searchsorted(cdf, rng.random()))
        if rng.random() < overlap_frac:
            head = sys_prompts[tenant]
            tail = rng.integers(1, vocab,
                                size=int(rng.integers(4, 17)))
            prompt = np.concatenate(
                [head, tail.astype("int32")])[:max_seq_len - new]
        else:
            long = rng.random() < 0.3
            plen = int(rng.integers(24, 49) if long
                       else rng.integers(4, 17))
            plen = min(plen, max_seq_len - new)
            prompt = rng.integers(1, vocab, size=plen).astype("int32")
        trace.append(TraceRequest(t, prompt, new, tenant))
    return trace


def trace_digest(trace) -> str:
    """sha256 over the full drawn stream — arrivals (as IEEE-754
    bits), token ids, max_new and tenant — the byte-identity pin for
    "same seed ⇒ same trace" across serve_bench and the simulator.
    Accepts both :class:`TraceRequest` lists and serve_bench's
    (arrival, prompt, max_new) triples; a triple digests identically
    to its tenant-less record."""
    h = hashlib.sha256()
    for rec in trace:
        if isinstance(rec, TraceRequest):
            t, prompt, new, tenant = (rec.arrival_s, rec.prompt,
                                      rec.max_new, rec.tenant)
        else:
            t, prompt, new = rec
            tenant = -1
        h.update(struct.pack("<dqq", float(t), int(new), int(tenant)))
        h.update(np.ascontiguousarray(prompt, np.int32).tobytes())
    return h.hexdigest()
