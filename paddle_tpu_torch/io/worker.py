"""Multiprocess DataLoader workers and shared-memory batch transport
(counterpart of paddle_tpu/io/worker.py).

Workers are forked processes that run the dataset's __getitem__ and the
numpy collate; they never touch torch, so forking a process whose CUDA
context is live is safe (a child that called into CUDA would fail). Pinning
and the host-to-device copy happen in the parent (DevicePrefetcher).
Batches cross processes through a ring of reusable shared-memory segments
per worker (all arrays of one batch packed into one segment at offsets):
reusing mapped segments keeps the transfer at memcpy speed, where a fresh
segment per batch would pay a page fault per page on both sides. The parent
recycles a slot to its worker through an ack queue right after copying out,
so the ring stays at prefetch_factor + 1 slots whatever the reorder depth.
A worker that dies is replaced (a new incarnation with new channels, see
WorkerPool) up to `respawn` times, paced by resilience.retry.RetryPolicy;
past that budget, or with none, the epoch fails fast. The reference copies through
its native feed library where it is built; the port copies with numpy.
"""
from __future__ import annotations

import atexit
import multiprocessing as mp
import multiprocessing.connection as _mp_connection
import os
import queue as _queue
import traceback
import weakref
from multiprocessing import resource_tracker, shared_memory

import numpy as np

_POOLS: "weakref.WeakSet[WorkerPool]" = weakref.WeakSet()


@atexit.register
def _shutdown_all_pools():  # let workers unlink their segments cleanly
    for pool in list(_POOLS):
        try:
            pool.shutdown()
        except Exception:  # pragma: no cover
            pass

# arrays below this many bytes ride the pickle queue; others pack into shm
_SHM_MIN_BYTES = 1 << 14


class _WorkerError:
    def __init__(self, exc):
        self.exc_type = type(exc).__name__
        self.msg = str(exc)
        self.tb = traceback.format_exc()

    def reraise(self):
        raise RuntimeError(
            f"DataLoader worker raised {self.exc_type}: {self.msg}\n{self.tb}")


class _ShmRef:
    """One array inside a slot segment: (offset, shape, dtype)."""

    __slots__ = ("offset", "shape", "dtype")

    def __init__(self, offset, shape, dtype):
        self.offset = offset
        self.shape = shape
        self.dtype = dtype


def _np_collate(batch):
    """Collate to numpy (never tensors: workers must not touch torch)."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(_np_collate([b[i] for b in batch]) for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: _np_collate([b[k] for b in batch]) for k in sample}
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    return batch


def _tree_arrays(tree, out):
    """Collect large contiguous arrays (the shm candidates) in tree order."""
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _tree_arrays(t, out)
    elif isinstance(tree, dict):
        for k in tree:
            _tree_arrays(tree[k], out)
    elif isinstance(tree, np.ndarray) and tree.nbytes >= _SHM_MIN_BYTES:
        out.append(tree)
    return out


def _pack(tree, seg):
    """Replace large arrays with _ShmRef into `seg` (sequential offsets);
    the arrays are copied in with numpy."""
    offset = [0]
    pending = []  # arrays to copy, in offset order

    def rec(t):
        if isinstance(t, tuple):
            return tuple(rec(x) for x in t)
        if isinstance(t, list):
            return [rec(x) for x in t]
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, np.ndarray) and t.nbytes >= _SHM_MIN_BYTES:
            o = offset[0]
            pending.append(t)
            offset[0] = o + t.nbytes
            return _ShmRef(o, t.shape, t.dtype)
        return t

    out = rec(tree)
    o = 0
    for t in pending:
        np.ndarray(t.shape, t.dtype, buffer=seg.buf, offset=o)[...] = t
        o += t.nbytes
    return out


def _unpack(tree, buf, to_tensor):
    if isinstance(tree, tuple):
        return tuple(_unpack(t, buf, to_tensor) for t in tree)
    if isinstance(tree, list):
        return [_unpack(t, buf, to_tensor) for t in tree]
    if isinstance(tree, dict):
        return {k: _unpack(v, buf, to_tensor) for k, v in tree.items()}
    if isinstance(tree, _ShmRef):
        arr = np.ndarray(tree.shape, tree.dtype, buffer=buf,
                         offset=tree.offset).copy()
        return to_tensor(arr)
    if isinstance(tree, np.ndarray):
        return to_tensor(tree)
    return tree


class _SlotRing:
    """Per-worker ring of reusable segments with ack-gated reuse."""

    def __init__(self, wid, size):
        self.wid = wid
        self.size = size
        self.segs = [None] * size
        self.capacity = [0] * size
        self.outstanding = [0] * size
        self.next = 0

    def acquire(self, nbytes, ack_q, done):
        s = self.next
        self.next = (self.next + 1) % self.size
        # wait until the parent has copied every batch still using slot s
        while self.outstanding[s]:
            try:
                freed = ack_q.get(timeout=0.5)
            except _queue.Empty:
                if done.value:
                    return None, None
                continue
            self.outstanding[freed] -= 1
        if self.capacity[s] < nbytes:
            if self.segs[s] is not None:
                self.segs[s].close()
                self.segs[s].unlink()
            cap = max(nbytes, 1)
            seg = shared_memory.SharedMemory(create=True, size=cap)
            self.segs[s] = seg
            self.capacity[s] = cap
        self.outstanding[s] += 1
        return s, self.segs[s]

    def release(self, s):
        """Undo an acquire whose payload never shipped (pack failure): the
        parent will never ack it, so the count must roll back here or the
        ring deadlocks when it wraps to slot s."""
        if self.outstanding[s] > 0:
            self.outstanding[s] -= 1

    def close(self):
        for seg in self.segs:
            if seg is not None:
                try:
                    seg.close()
                    seg.unlink()
                except Exception:  # pragma: no cover
                    pass


def worker_loop(dataset, collate_fn, task_q, out_conn, ack_q, done, wid,
                num_workers, worker_init_fn, use_shared_memory, ring_size,
                base_seed, incarnation=0):
    """Child-process main (the reference's worker_loop). Takes tasks from
    its own queue and sends results down its own pipe; exits on the None
    sentinel or when the parent raises `done`. `incarnation` tags every
    result so the parent can discard output of a killed predecessor
    instead of acking it into this worker's fresh slot ring."""
    from .dataloader import WorkerInfo, _worker_info

    np.random.seed((base_seed + wid + (incarnation << 16)) % (1 << 31))
    _worker_info.info = WorkerInfo(wid, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(wid)
    collate = collate_fn or _np_collate
    ring = _SlotRing(wid, ring_size)
    try:
        while not done.value:
            try:
                task = task_q.get(timeout=0.5)
            except _queue.Empty:
                continue
            except (EOFError, OSError):  # parent died
                return
            if task is None:
                break
            epoch, i, indices = task
            try:
                data = collate([dataset[j] for j in indices])
                if use_shared_memory:
                    big = _tree_arrays(data, [])
                    nbytes = sum(a.nbytes for a in big)
                    if nbytes:
                        slot, seg = ring.acquire(nbytes, ack_q, done)
                        if slot is None:
                            return
                        try:
                            payload = _pack(data, seg)
                        except Exception:
                            # roll the acquire back: an unacked slot would
                            # deadlock the ring when it wraps around
                            ring.release(slot)
                            raise
                        out_conn.send((epoch, i, wid, incarnation, slot,
                                       seg.name, payload))
                        continue
                out_conn.send((epoch, i, wid, incarnation, None, None, data))
            except Exception as e:  # noqa: BLE001 - must cross the process
                out_conn.send((epoch, i, wid, incarnation, None, None,
                               _WorkerError(e)))
    except (BrokenPipeError, EOFError):  # parent gone
        return
    finally:
        ring.close()


class WorkerPool:
    """Persistent fork-pool for one DataLoader (persistent_workers keeps it
    across epochs; otherwise it is torn down at iterator exhaustion).

    Every worker has its own channels: a task queue, a result pipe and an
    ack queue, and the stop flag is a lock-free shared byte. The reference
    shares one task queue and one result queue among its workers, whose
    locks a worker holds while it waits for a task or sends a result: a
    worker killed there (chaos.kill_worker's SIGKILL lands at any moment,
    most often in the idle wait) takes the lock with it and hangs every
    other worker and the epoch. Here a dead worker's channels are dropped
    with it and its replacement gets new ones. Task e goes to worker
    e % num_workers, as PyTorch's loader assigns them; a respawned worker
    is given the tasks its predecessor had not answered."""

    def __init__(self, dataset, collate_fn, num_workers, worker_init_fn,
                 use_shared_memory, prefetch_factor, respawn=0,
                 poll_timeout=5.0):
        ctx = mp.get_context("fork")  # workers never touch CUDA; fork is cheap
        self._ctx = ctx
        self.num_workers = num_workers
        self.prefetch = max(prefetch_factor, 1) * num_workers
        self._ring_size = max(prefetch_factor, 1) + 1
        self.task_qs = [ctx.Queue() for _ in range(num_workers)]
        self.ack_qs = [ctx.Queue() for _ in range(num_workers)]
        self.conns = [ctx.Pipe(duplex=False) for _ in range(num_workers)]
        self.done = ctx.RawValue("b", 0)
        self._attached = {}    # segment name -> SharedMemory (parent mappings)
        self._slot_names = {}  # (wid, slot) -> current segment name
        self._epoch = 0
        self.poll_timeout = poll_timeout
        # crashed-worker respawn budget, paced by the shared retry policy
        # (resilience/retry.py); 0 fails fast. A SIGKILLed worker never
        # unlinks its ring segments; the resource tracker reclaims them at
        # interpreter exit, so a bounded budget also bounds that leak.
        from ..resilience.retry import RetryPolicy

        self._respawns_left = int(respawn)
        self._respawn_count = 0
        self._respawn_policy = RetryPolicy(
            max_attempts=max(int(respawn), 1), base_delay=0.05,
            max_delay=1.0, name="dataloader.worker_respawn")
        self._incarnation = [0] * num_workers
        self._seed = int.from_bytes(os.urandom(4), "little")
        self._worker_static = (dataset, collate_fn, num_workers,
                               worker_init_fn, use_shared_memory)
        # one resource tracker for the parent and its workers, started
        # before the fork: a worker's unlink then balances the parent's
        # attach (see _decode); with fork's queues nothing else starts it
        # first, and a tracker of the parent's own would report every
        # segment the workers unlinked as leaked at exit
        resource_tracker.ensure_running()
        self.procs = [self._spawn(w) for w in range(num_workers)]
        for p in self.procs:
            p.start()
        self.alive = True
        _POOLS.add(self)

    def _spawn(self, wid):
        dataset, collate_fn, num_workers, worker_init_fn, use_shm = \
            self._worker_static
        return self._ctx.Process(
            target=worker_loop,
            args=(dataset, collate_fn, self.task_qs[wid], self.conns[wid][1],
                  self.ack_qs[wid], self.done, wid, num_workers,
                  worker_init_fn, use_shm, self._ring_size, self._seed,
                  self._incarnation[wid]),
            daemon=True)

    def _respawn(self, wid):
        """Replace a dead worker: a new incarnation with new channels (its
        predecessor may have died holding a lock of the old ones, and acks
        for the dead ring must never free slots in the new one)."""
        self._respawns_left -= 1
        self._respawn_count += 1
        self._respawn_policy.backoff(self._respawn_count)
        self.procs[wid].join(timeout=1.0)
        self._incarnation[wid] += 1
        for q in (self.task_qs[wid], self.ack_qs[wid]):
            q.cancel_join_thread()
            q.close()
        for c in self.conns[wid]:
            c.close()
        self.task_qs[wid] = self._ctx.Queue()
        self.ack_qs[wid] = self._ctx.Queue()
        self.conns[wid] = self._ctx.Pipe(duplex=False)
        self.procs[wid] = self._spawn(wid)
        self.procs[wid].start()

    def _decode(self, wid, slot, seg_name, payload, to_tensor):
        if slot is None:
            return _unpack(payload, None, to_tensor)
        key = (wid, slot)
        prev = self._slot_names.get(key)
        if prev is not None and prev != seg_name:
            # the worker resized this slot under a new name: the old segment
            # is unlinked; drop our mapping so its pages are not pinned
            old = self._attached.pop(prev, None)
            if old is not None:
                old.close()
        seg = self._attached.get(seg_name)
        if seg is None:
            # attach-only mapping. Ownership: segment creation is tracked and
            # balanced by the WORKER's unlink. On 3.13+ `track=False` keeps
            # this attach out of the tracker entirely. On 3.12 attach
            # registers implicitly - but the pool starts the tracker BEFORE
            # the fork, so parent and workers share one tracker whose
            # name cache is a set: the duplicate register is idempotent and
            # the worker's unlink balances it. An extra parent-side
            # unregister here would make the shared tracker print KeyError
            # tracebacks at teardown, so none is issued.
            try:
                seg = shared_memory.SharedMemory(name=seg_name, track=False)
            except TypeError:  # pre-3.13: no track parameter
                seg = shared_memory.SharedMemory(name=seg_name)
            self._attached[seg_name] = seg
            self._slot_names[key] = seg_name
        out = _unpack(payload, seg.buf, to_tensor)
        self.ack_qs[wid].put(slot)  # slot free for reuse
        return out

    def _get_result(self):
        """The next result from any worker's pipe, with a liveness
        watchdog: dead workers either respawn (budget permitting; returns
        (None, dead) so the caller resubmits their tasks) or raise rather
        than hang training (the reference's exit watchdog)."""
        while True:
            readers = {self.conns[w][0]: w for w in range(self.num_workers)}
            for r in _mp_connection.wait(list(readers),
                                         timeout=self.poll_timeout):
                try:
                    return r.recv(), None
                except (EOFError, OSError):  # torn by a dying worker
                    pass
            dead = [w for w, p in enumerate(self.procs) if not p.is_alive()]
            if not dead:
                continue
            if self._respawns_left < len(dead):
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker(s) {dead} exited unexpectedly "
                    "(killed or crashed); aborting epoch")
            for w in dead:
                self._respawn(w)
            return None, dead

    def run_epoch(self, index_batches, to_tensor):
        """Feed tasks with bounded in-flight count; decode on arrival (so
        slots recycle fast); yield decoded batches in order.

        Every task/result is tagged with an epoch id: abandoning an epoch
        mid-iteration (breaking out of the loader loop) leaves stale entries
        in the channels, which the next epoch discards, acking their slots
        so worker rings do not leak."""
        self._epoch += 1
        epoch = self._epoch
        n = len(index_batches)
        it = iter(enumerate(index_batches))
        outstanding = {}  # batch idx -> index list, dispatched but unreceived

        def submit(e, task):
            self.task_qs[e % self.num_workers].put((epoch, e, task))
            outstanding[e] = task

        for _ in range(min(self.prefetch, n)):
            submit(*next(it))
        results = {}
        done = set()
        next_idx = 0
        while len(done) < n:
            r, dead = self._get_result()
            if r is None:
                # respawned worker(s): the tasks their predecessors held go
                # to their new queues; a duplicate result is dropped below
                for e, task in outstanding.items():
                    if e % self.num_workers in dead:
                        self.task_qs[e % self.num_workers].put(
                            (epoch, e, task))
                continue
            r_epoch, i, wid, inc, slot, seg_name, payload = r
            current_inc = inc == self._incarnation[wid]
            if r_epoch != epoch or not current_inc or i in done:
                # stale epoch / dead incarnation / duplicate after respawn:
                # free the slot (only a LIVE incarnation's ring wants the
                # ack) and drop the payload
                if slot is not None and current_inc:
                    self.ack_qs[wid].put(slot)
                continue
            done.add(i)
            outstanding.pop(i, None)
            for e, task in it:
                submit(e, task)
                break
            if isinstance(payload, _WorkerError):
                self.shutdown()
                payload.reraise()
            results[i] = self._decode(wid, slot, seg_name, payload, to_tensor)
            while next_idx in results:
                yield results.pop(next_idx)
                next_idx += 1

    def shutdown(self):
        if not self.alive:
            return
        self.alive = False
        self.done.value = 1
        for q in self.task_qs:
            try:
                q.put_nowait(None)
            except Exception:  # pragma: no cover
                pass
        for p in self.procs:
            # generous join so a worker inside a slow __getitem__ can reach
            # its finally-block and unlink its ring segments; a terminated
            # worker's segments fall to the resource tracker's exit cleanup
            p.join(timeout=5.0)
            if p.is_alive():  # pragma: no cover
                p.terminate()
        for seg in self._attached.values():
            try:
                seg.close()
            except Exception:  # pragma: no cover
                pass
        self._attached.clear()
        for q in (*self.task_qs, *self.ack_qs):
            q.cancel_join_thread()
            q.close()
        for r, w in self.conns:
            r.close()
            w.close()

    def __del__(self):  # pragma: no cover
        try:
            self.shutdown()
        except Exception:
            pass
