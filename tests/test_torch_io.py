"""The port's data feed against the JAX reference, on the CPU.

paddle_tpu_torch.io: datasets, samplers and BatchSampler give the
reference's orders for the same seeds and epochs; the DataLoader's inline,
thread and forked process modes give the reference's batches (exactly);
a killed worker respawns under `worker_respawn` and fails the epoch fast
without it; the DevicePrefetcher (on device="cpu" here: on a card it pins
and copies on a side stream) keeps order, stays bounded, re-raises the
producer's error after the batches before it and closes idempotently; a
process-mode epoch boundary forks its workers from the prefetcher's thread
while an async checkpoint write and the metrics server's thread are alive;
the entry points raise without a GPU unless asked for the CPU; and none of
the new modules imports JAX or the reference.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.observability import serve as tserve
from paddle_tpu_torch.profiler import benchmark
from paddle_tpu_torch.resilience import CheckpointManager, chaos
from paddle_tpu_torch.resilience import checkpoint_manager as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Rows:
    """A map-style dataset of token rows and a float target, as numpy."""

    def __init__(self, n=23, width=6):
        self.n, self.width = n, width

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        row = (np.arange(self.width, dtype=np.int64) * 7 + i * 13) % 101
        return row, np.float32(i) / 3


def _np(x):
    if torch.is_tensor(x):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _flat(batches):
    return [tuple(_np(x) for x in b) for b in batches]


# ------------------------------------------------------------ samplers
def test_samplers_give_the_reference_orders():
    """RandomSampler (with and without replacement, with a generator,
    num_samples), SubsetRandomSampler, WeightedRandomSampler, BatchSampler
    (shuffled, drop_last) and DistributedBatchSampler over three epochs:
    the same index lists as the reference's."""
    ds = Rows(17)
    pairs = [
        (lambda m: m.RandomSampler(ds), 3),
        (lambda m: m.RandomSampler(ds, replacement=True, num_samples=9), 3),
        (lambda m: m.RandomSampler(ds, generator=42), 2),
        (lambda m: m.SubsetRandomSampler([3, 1, 4, 1, 5, 9, 2, 6]), 3),
        (lambda m: m.WeightedRandomSampler([0.1, 2.0, 0.5, 1.0], 12), 3),
        (lambda m: m.SequenceSampler(ds), 1),
        (lambda m: m.BatchSampler(ds, shuffle=True, batch_size=4), 3),
        (lambda m: m.BatchSampler(ds, shuffle=True, batch_size=5,
                                  drop_last=True), 2),
        (lambda m: m.DistributedBatchSampler(ds, 3, num_replicas=2, rank=1,
                                             shuffle=True), 2),
    ]
    for make, epochs in pairs:
        mine, ref = make(tio), make(jio)
        for _ in range(epochs):
            assert list(mine) == list(ref)
        assert len(mine) == len(ref)


def test_datasets_index_as_the_reference():
    a, b = Rows(5), Rows(7, width=3)
    for m in (tio, jio):
        assert len(m.ConcatDataset([a, b])) == 12
    for i in range(-3, 12):
        got = tio.ConcatDataset([a, b])[i]
        want = jio.ConcatDataset([a, b])[i]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got = tio.ComposeDataset([a, b])[2]
    want = jio.ComposeDataset([a, b])[2]
    assert len(got) == len(want) == 4
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    for lengths, gen in (([3, 4, 5], None), ([6, 6], 9)):
        got = tio.random_split(tio.ConcatDataset([a, b]), lengths, gen)
        want = jio.random_split(jio.ConcatDataset([a, b]), lengths, gen)
        assert [s.indices for s in got] == [s.indices for s in want]
    x = np.arange(12).reshape(6, 2)
    assert all(np.array_equal(g, w) for g, w in
               zip(tio.TensorDataset([x, x * 2])[4],
                   jio.TensorDataset([x, x * 2])[4]))
    chain = [a[0], a[1]]

    class It(tio.IterableDataset):
        def __iter__(self):
            return iter(chain)

    assert sum(1 for _ in tio.ChainDataset([It(), It()])) == 4
    assert len(tio.Subset(b, [6, 0, 2])) == 3


# ------------------------------------------------------------ DataLoader
@pytest.mark.parametrize("mode,workers", [("inline", 0), ("thread", 2),
                                          ("process", 2)])
def test_dataloader_gives_the_reference_batches(mode, workers):
    """Two shuffled epochs of 23 rows in batches of 4: the port's batches
    (host tensors, places="cpu") equal the reference's (its Tensors) in
    order and value, in every worker mode."""
    kw = dict(batch_size=4, shuffle=True, num_workers=workers,
              mode="process" if mode == "inline" else mode)
    mine = tio.DataLoader(Rows(), places="cpu", **kw)
    ref = jio.DataLoader(Rows(), **kw)
    for _ in range(2):
        got = list(mine)
        assert all(torch.is_tensor(x) and x.device.type == "cpu"
                   for b in got for x in b)
        want = _flat(ref)
        assert len(got) == len(want) == 6
        for g, w in zip(_flat(got), want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)


def test_dataloader_process_mode_equals_inline_and_reports_reader_cost():
    bm = benchmark()
    before = bm.reader.count
    inline = tio.DataLoader(Rows(40), places="cpu", batch_size=8,
                            shuffle=True)
    proc = tio.DataLoader(Rows(40), places="cpu", batch_size=8,
                          shuffle=True, num_workers=2,
                          persistent_workers=True)
    try:
        for _ in range(2):
            for g, w in zip(_flat(proc), _flat(inline)):
                for x, y in zip(g, w):
                    np.testing.assert_array_equal(x, y)
    finally:
        proc._pool.shutdown()
    assert bm.reader.count - before == 20


def test_get_worker_info_inside_workers_and_custom_collate():
    """get_worker_info() is None in the parent and names the worker inside
    one; a custom collate's numpy output passes through as produced."""
    assert tio.get_worker_info() is None

    class WhoAmI(Rows):
        def __getitem__(self, i):
            info = tio.get_worker_info()
            return np.array([i, info.id, info.num_workers])

    dl = tio.DataLoader(WhoAmI(8), places="cpu", batch_size=2,
                        num_workers=2, collate_fn=np.stack)
    got = list(dl)
    assert all(isinstance(b, np.ndarray) for b in got)
    rows = np.concatenate(got)
    assert sorted(rows[:, 0]) == list(range(8))
    assert set(rows[:, 1]) <= {0, 1} and set(rows[:, 2]) == {2}


class DieOnce(Rows):
    """Index 9 kills its first worker process outright; the respawned one
    survives (a flag file remembers the first death)."""

    def __init__(self, flag):
        super().__init__(32)
        self.flag = flag

    def __getitem__(self, i):
        if i == 9:
            try:
                with open(self.flag, "x"):
                    pass
                os._exit(17)
            except FileExistsError:
                pass
        return super().__getitem__(i)


def test_killed_worker_respawns_under_worker_respawn(tmp_path):
    dl = tio.DataLoader(DieOnce(str(tmp_path / "died")), places="cpu",
                        batch_size=4, num_workers=2, worker_respawn=2,
                        timeout=1.0)
    want = list(tio.DataLoader(Rows(32), places="cpu", batch_size=4))
    got = list(dl)
    for g, w in zip(_flat(got), _flat(want)):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_chaos_kill_worker_respawns_and_keeps_order():
    """chaos.kill_worker SIGKILLs a live worker mid-epoch: with a respawn
    budget the epoch completes in order."""
    class Slow(Rows):
        def __getitem__(self, i):
            time.sleep(0.01)
            return super().__getitem__(i)

    dl = tio.DataLoader(Slow(48), places="cpu", batch_size=4,
                        num_workers=2, worker_respawn=2, timeout=1.0,
                        persistent_workers=True)
    it = iter(dl)
    got = [next(it)]
    chaos.kill_worker(dl._pool, 0)
    got += list(it)
    dl._pool.shutdown()
    want = list(tio.DataLoader(Rows(48), places="cpu", batch_size=4))
    assert len(got) == len(want) == 12
    for g, w in zip(_flat(got), _flat(want)):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_dead_worker_fails_fast_without_respawn():
    class Suicide(Rows):
        def __getitem__(self, i):
            if i == 5:
                os._exit(17)
            return super().__getitem__(i)

    dl = tio.DataLoader(Suicide(16), places="cpu", batch_size=4,
                        num_workers=2, timeout=1.0)
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        for _ in dl:
            pass


# ------------------------------------------------------- DevicePrefetcher
def _gen(n, produced=None, fail_at=None):
    for i in range(n):
        if fail_at is not None and i == fail_at:
            raise RuntimeError("loader died")
        if produced is not None:
            produced.append(i)
        yield {"x": np.full((2, 2), i, np.float32), "i": i,
               "t": torch.full((3,), float(i))}


class TestDevicePrefetcher:
    def test_ordering_and_placement(self):
        with tio.DevicePrefetcher(_gen(8), depth=2, device="cpu") as pf:
            out = list(pf)
        assert [b["i"] for b in out] == list(range(8))
        assert all(torch.is_tensor(b["x"]) and torch.is_tensor(b["t"])
                   for b in out)
        assert all(float(b["x"][0, 0]) == b["i"] for b in out)
        assert pf.stats["batches"] == 8

    def test_boundedness(self):
        produced = []
        pf = tio.DevicePrefetcher(_gen(50, produced=produced), depth=2,
                                  device="cpu")
        time.sleep(0.5)  # the consumer never pulls
        # the queue holds `depth`; at most one more is in flight in _put
        assert len(produced) <= 3
        pf.close()

    def test_exception_after_prior_batches(self):
        pf = tio.DevicePrefetcher(_gen(6, fail_at=3), depth=2, device="cpu")
        got = []
        with pytest.raises(RuntimeError, match="loader died"):
            for b in pf:
                got.append(b["i"])
        assert got == [0, 1, 2]

    def test_maybe_prefetch_flag_gate_and_close(self):
        src = [np.zeros(2)]
        assert tio.maybe_prefetch(src, device="cpu") is src
        tflags.set_flags({"io_device_prefetch": True})
        try:
            wrapped = tio.maybe_prefetch(iter(src), device="cpu")
            assert isinstance(wrapped, tio.DevicePrefetcher)
            wrapped.close()
        finally:
            tflags.set_flags({"io_device_prefetch": False})
        pf = tio.DevicePrefetcher(_gen(4), depth=1, device="cpu")
        next(pf)
        pf.close()
        pf.close()


def test_epoch_boundary_forks_with_prefetcher_writer_and_server_alive(
        tmp_path, monkeypatch):
    """Three epochs of a process-mode loader (workers forked anew each
    epoch) consumed through a DevicePrefetcher, whose thread therefore does
    the forking, while an async checkpoint write is held open in its
    thread and the metrics server's thread serves: every epoch completes,
    in order, well inside the time limit (a child deadlocked on a lock
    held by another thread at the fork would hang it)."""
    release = threading.Event()
    fsync = tckpt._fsync_file

    def held_fsync(f):      # the writer thread waits here, file open
        release.wait(60)
        fsync(f)

    monkeypatch.setattr(tckpt, "_fsync_file", held_fsync)
    server = tserve.start_metrics_server(0)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, {"w": torch.ones(1024)})
    loader = tio.DataLoader(Rows(24), places="cpu", batch_size=4,
                            shuffle=True, num_workers=2)
    want = [_flat(tio.DataLoader(Rows(24), places="cpu", batch_size=4,
                                 shuffle=True)) for _ in range(1)]
    result, err = [], []

    def drive():
        try:
            for _ in range(3):
                with tio.DevicePrefetcher(loader, depth=2,
                                          device="cpu") as pf:
                    result.append(_flat(pf))
        except BaseException as e:  # surfaced below
            err.append(e)

    t = threading.Thread(target=drive, daemon=True)
    try:
        t.start()
        t.join(60)
        alive = [mgr._thread is not None and mgr._thread.is_alive(),
                 server._thread.is_alive()]
    finally:
        release.set()
        mgr.wait()
        tserve.reset()
    assert not t.is_alive(), "an epoch boundary hung"
    assert not err, err
    assert alive == [True, True]
    assert len(result) == 3 and all(len(e) == 6 for e in result)
    for g, w in zip(result[0], want[0]):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)
    assert mgr.restore_latest().step == 1


# ------------------------------------------------------------- guards
def test_entry_points_raise_without_a_gpu_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.DataLoader(Rows())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.DevicePrefetcher(iter([]), depth=1)
    tflags.set_flags({"io_device_prefetch": True})
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tio.maybe_prefetch([np.zeros(2)])
    finally:
        tflags.set_flags({"io_device_prefetch": False})
    tio.DataLoader(Rows(), places="cpu")
    tio.DevicePrefetcher(iter([]), depth=1, device="cpu").close()


def test_new_modules_import_neither_jax_nor_the_reference():
    """Every module of the port is walked and imported in a fresh process
    (the existing guard's walk); the slice's new modules are among them
    and nothing of jax or paddle_tpu comes in."""
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(n for n in new if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(sorted(n for n in new\n"
        "                      if n.startswith('paddle_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    seen = set(out.stdout.split())
    for mod in ("resilience", "resilience.retry", "resilience.chaos",
                "resilience.preemption", "resilience.checkpoint_manager",
                "resilience.trainer", "framework", "framework.io",
                "distributed", "distributed.fleet",
                "distributed.fleet.recompute", "io.dataset", "io.sampler",
                "io.worker", "io.dataloader", "io.prefetch", "profiler",
                "profiler.timer"):
        assert "paddle_tpu_torch." + mod in seen, mod
