"""Reader and step cost accounting (counterpart of
paddle_tpu/profiler/timer.py, whole).

`benchmark()` returns the process-wide Benchmark. DataLoader iterators and
the DevicePrefetcher report the time the consumer spends blocked waiting
for each batch (reader_cost); training loops call `step(n_samples)` after
each optimizer step so batch_cost and ips (samples/sec) come from the same
clock. A reader_cost close to batch_cost means the input pipeline, not the
device, is the bottleneck.
"""
from __future__ import annotations

import time


class _Avg:
    __slots__ = ("total", "count", "last")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.last = 0.0

    def update(self, v):
        self.total += v
        self.count += 1
        self.last = v

    @property
    def avg(self):
        return self.total / self.count if self.count else 0.0


class Benchmark:
    def __init__(self):
        self.reset()

    def reset(self):
        self.reader = _Avg()
        self.batch = _Avg()
        self._samples = 0
        self._step_start = None

    # --- reader side (called by DataLoader iterators) -----------------------
    def record_reader(self, seconds):
        self.reader.update(seconds)
        if self._step_start is None:
            self._step_start = time.perf_counter()

    # --- training-loop side -------------------------------------------------
    def step(self, num_samples=None):
        """Mark one optimizer step; batch_cost spans step->step."""
        now = time.perf_counter()
        if self._step_start is not None:
            self.batch.update(now - self._step_start)
        self._step_start = now
        if num_samples:
            self._samples += num_samples

    @property
    def reader_cost(self):
        return self.reader.avg

    @property
    def batch_cost(self):
        return self.batch.avg

    @property
    def ips(self):
        """Average samples/sec over recorded steps."""
        t = self.batch.total
        return self._samples / t if t > 0 else 0.0

    def summary(self):
        return {
            "reader_cost_avg_s": round(self.reader.avg, 6),
            "batch_cost_avg_s": round(self.batch.avg, 6),
            "ips": round(self.ips, 2),
            "reader_fraction": round(
                self.reader.avg / self.batch.avg, 4) if self.batch.count else 0.0,
        }


_benchmark = Benchmark()


def benchmark() -> Benchmark:
    return _benchmark
