"""Profiling helpers (counterpart of paddle_tpu/profiler): the reader and
step cost accounting the data feed reports to."""
from .timer import Benchmark, benchmark

__all__ = ["Benchmark", "benchmark"]
