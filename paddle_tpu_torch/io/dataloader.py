"""DataLoader (counterpart of paddle_tpu/io/dataloader.py).

Worker modes:
  * num_workers=0: inline.
  * mode='process' (default for num_workers > 0, the reference's
    semantics): forked workers run __getitem__ and the numpy collate and
    ship batches through POSIX shared memory (io/worker.py), so
    Python-level decoding does not share the parent's GIL. The workers
    never touch torch.
  * mode='thread': thread workers and a bounded prefetch queue, for
    datasets that are not fork-safe (open file handles, sockets).

Placement: `places` is the device of the batches the default collate makes
(torch tensors): None is the current CUDA device, raising when there is
none, as every entry point of the port does; "cpu" keeps them on the host,
which is what a feed through DevicePrefetcher asks for (the prefetcher pins
and copies them itself). A custom collate_fn's output passes through as
produced (numpy stays numpy), as in the reference.

Reader-cost accounting: every iterator reports the time spent blocked
waiting for data to profiler.timer.benchmark().
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.place import resolve_device
from ..profiler.timer import benchmark
from .dataset import IterableDataset
from .sampler import BatchSampler


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    dataset: object


_worker_info = threading.local()


def get_worker_info() -> Optional[WorkerInfo]:
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch):
    """Stack a list of samples into host torch tensors (tuples, lists and
    dicts recursively; numpy arrays, tensors and numbers stacked)."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if torch.is_tensor(sample):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    return batch


class DataLoader:
    def __init__(
        self, dataset, feed_list=None, places=None, return_list=True,
        batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
        collate_fn=None, num_workers=0, use_buffer_reader=True,
        prefetch_factor=2, use_shared_memory=True, timeout=0,
        worker_init_fn=None, persistent_workers=False, mode="process",
        worker_respawn=0,
    ):
        self.device = resolve_device(places)
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = prefetch_factor
        self.worker_init_fn = worker_init_fn
        self.use_shared_memory = use_shared_memory
        self.persistent_workers = persistent_workers
        # crashed process workers: respawn up to this many times (the
        # resilience retry policy paces the restarts); 0 fails fast
        self.worker_respawn = int(worker_respawn)
        self.timeout = timeout
        if mode not in ("process", "thread"):
            raise ValueError(
                f"mode must be 'process' or 'thread', got {mode!r}")
        self.mode = mode
        self._pool = None
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def __iter__(self):
        if self._iterable:
            it = self._iter_iterable()
        elif self.num_workers == 0:
            it = self._iter_single()
        elif self.mode == "process":
            it = self._iter_multiprocess()
        else:
            it = self._iter_threaded()
        return self._timed(it)

    def _timed(self, it):
        """Place each default-collated batch on the loader's device and
        report its production time to the global Benchmark."""
        bm = benchmark()
        place = self.collate_fn is default_collate_fn and \
            self.device.type != "cpu"
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            if place:
                item = pytree.tree_map(
                    lambda t: t.to(self.device) if torch.is_tensor(t) else t,
                    item)
            bm.record_reader(time.perf_counter() - t0)
            yield item

    def _produces_tensors(self, probe_index) -> bool:
        """Probe one sample (and the custom collate, if any) in the parent:
        torch tensor leaves keep the pipeline on threads, as the reference
        keeps its Tensor-producing ones. Probed once per loader with an
        index from the already-materialised epoch list, so one-shot
        samplers are never consumed."""
        cached = getattr(self, "_tensor_probe", None)
        if cached is not None:
            return cached

        def has_tensor(tree):
            if torch.is_tensor(tree):
                return True
            if isinstance(tree, (tuple, list)):
                return any(has_tensor(t) for t in tree)
            if isinstance(tree, dict):
                return any(has_tensor(v) for v in tree.values())
            return False

        result = False
        try:
            sample = self.dataset[probe_index]
            result = has_tensor(sample)
            if not result and self.collate_fn is not default_collate_fn:
                result = has_tensor(self.collate_fn([sample]))
        except Exception:
            result = False  # let the worker surface the real error
        self._tensor_probe = result
        return result

    def _iter_single(self):
        for batch_indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in batch_indices])

    def _iter_iterable(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _iter_multiprocess(self):
        """Process workers + shared-memory transport (io/worker.py); ordered
        reassembly; persistent_workers keeps the pool across epochs."""
        import multiprocessing as _mp
        import warnings

        if "fork" not in _mp.get_all_start_methods():
            warnings.warn("fork start method unavailable; DataLoader falls "
                          "back to thread workers")
            yield from self._iter_threaded()
            return
        from .worker import WorkerPool

        # workers collate to numpy unless the user supplied a collate
        # (which must then be numpy-level too)
        worker_collate = (None if self.collate_fn is default_collate_fn
                          else self.collate_fn)
        indices = list(self.batch_sampler)
        if not indices:
            return
        if self._produces_tensors(indices[0][0]):
            warnings.warn(
                "dataset/collate_fn produces torch tensors; DataLoader keeps "
                "them on thread workers. Return numpy from __getitem__/"
                "collate_fn to use processes.")
            yield from self._iter_threaded()
            return
        pool = self._pool
        if pool is None or not pool.alive:
            pool = WorkerPool(self.dataset, worker_collate, self.num_workers,
                              self.worker_init_fn, self.use_shared_memory,
                              self.prefetch_factor,
                              respawn=self.worker_respawn,
                              poll_timeout=(self.timeout
                                            if self.timeout else 5.0))
            if self.persistent_workers:
                self._pool = pool
        # the default collate yields host tensors (placed by _timed); a
        # custom collate's output passes through as produced
        to_tensor = (torch.from_numpy if worker_collate is None
                     else (lambda a: a))
        try:
            yield from pool.run_epoch(indices, to_tensor)
        finally:
            if not self.persistent_workers:
                pool.shutdown()

    def __del__(self):  # pragma: no cover
        pool = getattr(self, "_pool", None)
        if pool is not None:
            try:
                pool.shutdown()
            except Exception:
                pass

    def _iter_threaded(self):
        indices = list(self.batch_sampler)
        out_q: "queue.Queue" = queue.Queue(
            maxsize=self.num_workers * self.prefetch_factor)
        results = {}
        next_to_yield = 0
        task_q: "queue.Queue" = queue.Queue()
        for i, b in enumerate(indices):
            task_q.put((i, b))
        stop = threading.Event()

        def worker(wid):
            _worker_info.info = WorkerInfo(wid, self.num_workers,
                                           self.dataset)
            if self.worker_init_fn:
                self.worker_init_fn(wid)
            while not stop.is_set():
                try:
                    i, batch_indices = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    data = self.collate_fn([self.dataset[j]
                                            for j in batch_indices])
                    out_q.put((i, data))
                except Exception as e:  # propagate
                    out_q.put((i, e))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            received = 0
            while received < len(indices):
                i, data = out_q.get()
                received += 1
                if isinstance(data, Exception):
                    raise data
                results[i] = data
                while next_to_yield in results:
                    yield results.pop(next_to_yield)
                    next_to_yield += 1
        finally:
            stop.set()
