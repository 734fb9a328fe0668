"""Background batch staging: port of the JAX package's
``runtime/prefetch.py`` (``DevicePrefetcher``, ``sharded_put``).

While the card runs step ``i``, a producer thread takes batch ``i + 1``
from the host iterator, copies each array into pinned host memory and
then to the card on a side stream, ``depth`` batches ahead, and records
an event after the copy.  The consumer's stream waits on that event
before the batch is used, and each tensor is marked with
``record_stream`` so the allocator does not reuse its memory while the
consumer's stream may still read it.  A batch that is already on the
card (drawn there) is passed through, behind an event of the producer's
stream.

Semantics, as the reference's:
  * order-preserving: the prefetcher yields exactly the wrapped
    iterator's sequence;
  * bounded: at most ``depth`` staged batches exist at once;
  * crash-clean: ``close()`` (also run by ``__exit__``) stops the
    producer, drains the queue and joins the thread;
  * error-transparent: an exception in the host pipeline re-raises at
    the consumer's next ``next()``.

On the CPU it is the same in-order queue, with no pinning and no
streams; a CUDA device asked for without a card raises, as every entry
point does (``device.resolve_device``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..telemetry.metrics import maybe_inc, maybe_observe
from ..telemetry.spans import maybe_span


def _map_leaves(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_leaves(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map_leaves(fn, v) for k, v in batch.items()}
    return fn(batch)


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def sharded_put(batch, device=None, axis="dp"):
    """This rank's contiguous rows of the global ``batch`` (every leaf,
    along dim 0) on ``device``: what each worker of a data-parallel
    group transfers.  ``axis=None`` puts the whole batch (the port's
    steps take the global batch and slice their rows themselves,
    ``parallel.fsdp.local_batch``)."""
    dev = resolve_device(device)
    if axis is not None:
        from ..parallel.fsdp import local_batch
        batch = type(batch)(local_batch(
            tuple(_host_tensor(a) for a in batch), axis))
    return _map_leaves(lambda a: _host_tensor(a).to(dev), batch)


class _End:
    """Sentinel: iterator exhausted."""


class _Err:
    def __init__(self, exc: BaseException):
        self.exc = exc


class _Staged:
    """A batch on the card and the event after its copy."""

    def __init__(self, batch, event):
        self.batch = batch
        self.event = event


class DevicePrefetcher(Iterator[Any]):
    """Iterate ``it`` through a ``depth``-bounded background pipeline
    that stages each batch, whole, on ``device`` (default: the card).
    ``transform`` replaces the put (receives the host batch, returns
    what the consumer should get; it runs on the producer thread), e.g.
    :func:`sharded_put` for this rank's rows alone."""

    def __init__(self, it: Iterable[Any], *, device=None, depth: int = 2,
                 transform: Callable[[Any], Any] | None = None,
                 spans=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self.depth = depth
        self.spans = spans      # late-assigned: ``pref.spans = telem.spans``
        self.metrics = None     # late-assigned: ``pref.metrics = ...``
        self._transform = transform
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._it = iter(it)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._produce, name="device-prefetcher", daemon=True)
        self._thread.start()

    # ---- producer (background thread) -----------------------------------
    def _stage(self, item):
        if self._transform is not None:
            return self._transform(item)
        if not self._cuda:
            return _map_leaves(_host_tensor, item)
        torch.cuda.set_device(self.device)

        item = _map_leaves(_host_tensor, item)
        on_card = []
        _map_leaves(lambda t: on_card.append(t.device.type == "cuda"), item)

        def put(t):
            if t.device.type == "cuda":
                return t
            return t.pin_memory().to(self.device, non_blocking=True)

        with torch.cuda.stream(self._side):
            if any(on_card):
                # drawn on the card, on the producer's default stream:
                # the side stream waits for the draw first
                self._side.wait_stream(torch.cuda.default_stream(self.device))
            staged = _map_leaves(put, item)
            event = torch.cuda.Event()
            event.record(self._side)
        return _Staged(staged, event)

    def _produce(self) -> None:
        try:
            for item in self._it:
                with maybe_span(self.spans, "prefetch/stage",
                                cat="prefetch"):
                    staged = self._stage(item)
                maybe_inc(self.metrics, "prefetch_staged_total")
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._enqueue_final(_End())
        except BaseException as e:  # noqa: BLE001 - relayed to consumer
            self._enqueue_final(_Err(e))

    def _enqueue_final(self, token) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(token, timeout=0.1)
                return
            except queue.Full:
                continue

    # ---- consumer --------------------------------------------------------
    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        with maybe_span(self.spans, "prefetch/wait", cat="prefetch"):
            item = self._q.get()
        maybe_observe(self.metrics, "prefetch_wait_seconds",
                      time.perf_counter() - t0)
        if isinstance(item, _End):
            self.close()
            raise StopIteration
        if isinstance(item, _Err):
            self.close()
            raise item.exc
        if isinstance(item, _Staged):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(item.event)

            def mark(t):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(stream)
                return t

            return _map_leaves(mark, item.batch)
        return item

    # ---- lifecycle -------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        """Stop the producer and join it.  Idempotent; safe to call from
        an exception handler mid-loop (the ``with`` form does)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        self._thread.join()

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
