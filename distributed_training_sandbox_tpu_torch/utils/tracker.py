"""Warmup-aware throughput/TFLOPS tracker: port of the JAX package's
``utils/tracker.py`` (the reference's ``PerformanceTracker``).  It
restarts its clock once warmup steps have passed, then reports tokens/s,
steps/s, per-device TFLOP/s from the analytic FLOPs model, and the
allocator's peak.

The peak is sampled every ``memory_sample_every`` steps (and once more
at ``metrics(sample_memory=True)``, which the step pump calls at close)
straight from ``torch.cuda.memory_stats``; the CPU has none, and then
the dict carries no memory fields, as the reference's on a backend
without statistics.  ``clock`` (default ``time.perf_counter``) is read
exactly where the reference reads ``time.perf_counter``, so a test can
feed both the same timestamps.
"""

from __future__ import annotations

import time

import torch

from .memory import GB, all_devices_memory_gb, device_memory_stats


class PerformanceTracker:
    def __init__(self, warmup_steps: int = 5,
                 flops_per_token: float | None = None,
                 num_devices: int | None = None,
                 memory_sample_every: int = 10, *, clock=None,
                 device=None):
        if num_devices is None:
            from .mesh import axis_size
            num_devices = axis_size()
        self.clock = clock or time.perf_counter
        self.device = device
        self.warmup_steps = warmup_steps
        self.flops_per_token = flops_per_token
        self.num_devices = num_devices
        self.memory_sample_every = max(int(memory_sample_every), 1)
        self.step_count = 0
        self.tokens = 0
        self.total_loss = 0.0
        self.loss_count = 0
        self.start = self.clock()
        self._warmed_up = warmup_steps == 0
        self._prev_step_t = self.start
        self.last_step_time_s: float | None = None
        self._peak_gb: float | None = None
        self._mem_all: dict | None = None
        self._mem_sampled = False

    def step(self, tokens: int, loss: float | None = None) -> dict | None:
        """Record one optimizer step of ``tokens`` tokens.  Returns the
        metric dict once past warmup, else None.  ``loss`` may be omitted
        and supplied later via :meth:`record_loss` (the async pump
        resolves losses at its sync points)."""
        now = self.clock()
        self.last_step_time_s = now - self._prev_step_t
        self._prev_step_t = now
        self.step_count += 1
        if not self._warmed_up:
            if self.step_count >= self.warmup_steps:
                self._warmed_up = True
                self.step_count = 0
                self.tokens = 0
                self.total_loss = 0.0
                self.loss_count = 0
                self.start = self.clock()
            return None
        self.tokens += tokens
        if loss is not None:
            self.record_loss(loss)
        return self.metrics(
            sample_memory=self.step_count % self.memory_sample_every == 0)

    def record_loss(self, loss: float) -> None:
        """Fold one resolved loss into the running average."""
        self.total_loss += float(loss)
        self.loss_count += 1

    def _sample_memory(self) -> None:
        dev = self.device
        if dev is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev is not None and torch.device(dev).type == "cuda":
            peak = device_memory_stats(dev)["peak_bytes_in_use"]
            if peak:
                self._peak_gb = peak / GB
                self._mem_all = all_devices_memory_gb()
        self._mem_sampled = True

    def metrics(self, *, sample_memory: bool = False) -> dict:
        elapsed = max(self.clock() - self.start, 1e-9)
        steps_per_second = self.step_count / elapsed
        tokens_per_second = self.tokens / elapsed
        out = {
            "steps_per_second": steps_per_second,
            "tokens_per_second": tokens_per_second,
            "total_tokens": self.tokens,
            "elapsed_s": elapsed,
        }
        if self.last_step_time_s is not None:
            out["last_step_time_s"] = self.last_step_time_s
        if self.loss_count:
            out["avg_loss"] = self.total_loss / self.loss_count
        if self.flops_per_token:
            # per-device TFLOPS: tokens/s is the global rate
            out["tflops_per_device"] = (
                tokens_per_second * self.flops_per_token / self.num_devices
                / 1e12)
        if sample_memory or not self._mem_sampled:
            self._sample_memory()
        if self._peak_gb is not None:
            out["peak_memory_gb"] = self._peak_gb
            out["memory_all_devices"] = self._mem_all
        return out
