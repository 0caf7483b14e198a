"""Fault-tolerant training runtime (counterpart of paddle_tpu/resilience,
single process).

Pieces (wired together by ResilientTrainer, each usable alone):
  - CheckpointManager  : crash-consistent commit (tmp dir -> manifest with
                         per-array checksums -> atomic rename), keep-last-N
                         GC that never drops the last valid checkpoint, and
                         restore_latest() with corruption fallback.
  - PreemptionHandler  : SIGTERM/SIGINT latched into one flag the training
                         loop polls.
  - RetryPolicy        : backoff/jitter/deadline retries, adopted by the
                         DataLoader worker respawn path and the process
                         replicas' respawns.
  - chaos              : fault injection (crash points inside checkpoint
                         writes, NaN batch poisoning, worker kills, fake
                         preemption signals, SIGKILL/SIGSTOP/SIGCONT of a
                         process, store partitions) backing the tests and
                         chip_smoke.py.
The elastic trainer and the multi-rank pieces wait for the distributed
slice.
"""
from __future__ import annotations

from . import chaos  # noqa: F401
from .checkpoint_manager import (  # noqa: F401
    CheckpointCorrupt, CheckpointManager, RestoredCheckpoint,
)
from .preemption import PreemptionHandler  # noqa: F401
from .retry import RetryError, RetryPolicy, retrying  # noqa: F401

__all__ = [
    "CheckpointManager", "CheckpointCorrupt", "RestoredCheckpoint",
    "PreemptionHandler", "RetryPolicy", "RetryError", "retrying",
    "ResilientTrainer", "chaos",
]


def __getattr__(name):
    # ResilientTrainer pulls in jit.trainer and the observability stack;
    # resolved lazily, as the reference does
    if name == "ResilientTrainer":
        from .trainer import ResilientTrainer

        return ResilientTrainer
    raise AttributeError(name)
