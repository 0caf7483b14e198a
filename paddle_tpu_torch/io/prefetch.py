"""Device-resident batch prefetcher (counterpart of
paddle_tpu/io/prefetch.py).

Batch N+1 is copied host -> device while the card computes on batch N, so
the step loop never waits on the transfer. One background thread pulls
host batches from any iterator and places them: on a card it pins each
host tensor, copies it with a non-blocking copy on a side CUDA stream and
records an event there; the batch and its event wait in a bounded queue.
The consumer's `next()` makes its current stream wait on the event and
calls `record_stream` on the placed tensors, so the caching allocator does
not reuse their memory while the consumer's stream may still read it.
Numpy leaves are turned into tensors first; other leaves pass through.
`device="cpu"` keeps the batches on the host (the tests' path).

Semantics (the reference's):
  * ordering: batches come out in exactly the input iterator's order;
  * boundedness: at most `depth` batches are resident beyond the one the
    consumer holds (the producer blocks, it does not run ahead);
  * exceptions: a producer-side error is re-raised at the consumer's
    next() call, after every batch produced before it;
  * the consumer's wait time is reported to profiler.timer.benchmark() as
    reader cost and to the registry counters io_prefetch_batches_total and
    io_prefetch_wait_seconds_total.

The reference's `sharding=` (placing a batch pre-sharded over a mesh)
waits for the distributed slice.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.flags import define_flag, get_flag
from ..core.place import resolve_device
from ..observability.registry import counter as _obs_counter
from ..observability.spans import span as _span
from ..profiler.timer import benchmark

define_flag(
    "io_device_prefetch", False,
    "Overlap host->device transfer of batch N+1 with compute of batch N "
    "via DevicePrefetcher (double buffering).",
)
define_flag(
    "io_prefetch_depth", 2,
    "Number of device-resident batches DevicePrefetcher keeps in flight "
    "(2 = double buffering).",
)

_DONE = object()

# always=True: DevicePrefetcher.stats counts with FLAGS_metrics off too
_BATCHES = _obs_counter(
    "io_prefetch_batches_total",
    "Batches yielded by DevicePrefetcher across all instances.", always=True)
_WAIT_S = _obs_counter(
    "io_prefetch_wait_seconds_total",
    "Cumulative consumer-side wait (starvation) in DevicePrefetcher.__next__.",
    always=True)


class DevicePrefetcher:
    """Wrap a host-batch iterable; yield device-resident batches, ahead of
    the consumer by up to ``depth`` batches. `device=None` is the current
    CUDA device (raising when there is none)."""

    def __init__(self, iterable: Iterable, depth: Optional[int] = None,
                 device=None):
        if depth is None:
            depth = int(get_flag("io_prefetch_depth"))
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        self._it = iter(iterable)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._batches = 0
        self._wait_s = 0.0
        self._thread = threading.Thread(
            target=self._produce, name="device-prefetch", daemon=True)
        self._thread.start()

    @property
    def stats(self):
        """This instance's batches and consumer wait seconds (a snapshot;
        the process-wide totals are the registry counters)."""
        return {"batches": self._batches, "wait_s": self._wait_s}

    # -- producer side -------------------------------------------------
    def _place(self, batch):
        """host tree -> (device tree, event the consumer waits on)."""
        def place(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            if not torch.is_tensor(x):
                return x
            if self._cuda and x.device.type == "cpu":
                x = x.pin_memory()
            return x.to(self.device, non_blocking=self._cuda)

        if not self._cuda:
            return pytree.tree_map(place, batch), None
        with torch.cuda.stream(self._stream):
            placed = pytree.tree_map(place, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close(); False = stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for batch in self._it:
                with _span("io.prefetch.place", cat="io"):
                    placed = self._place(batch)
                if not self._put(("ok", placed)):
                    return
        except BaseException as e:  # re-raised consumer-side, in order
            self._put(("err", e))
            return
        self._put(("ok", _DONE))

    # -- consumer side -------------------------------------------------
    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        with _span("io.prefetch.wait", cat="io"):
            kind, payload = self._q.get()
        waited = time.perf_counter() - t0
        benchmark().record_reader(waited)
        self._wait_s += waited
        _WAIT_S.inc(waited)
        if kind == "err":
            self._stop.set()
            raise payload
        if payload is _DONE:
            self._stop.set()
            raise StopIteration
        batch, event = payload
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in pytree.tree_leaves(batch):
                if torch.is_tensor(t):
                    t.record_stream(stream)
        self._batches += 1
        _BATCHES.inc()
        return batch

    def close(self):
        """Stop the producer and drop queued batches (idempotent)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def maybe_prefetch(iterable, depth=None, device=None):
    """Wrap in DevicePrefetcher when FLAGS_io_device_prefetch is on;
    otherwise return the iterable unchanged (zero-cost off switch)."""
    if get_flag("io_device_prefetch"):
        return DevicePrefetcher(iterable, depth=depth, device=device)
    return iterable
