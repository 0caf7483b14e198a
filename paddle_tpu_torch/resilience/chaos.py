"""Fault injection for the resilience subsystem (counterpart of
paddle_tpu/resilience/chaos.py, cut to the single-process helpers).

Production code calls `crash_point("name")` at chosen spots of checkpoint
writes and file commits; tests and chip_smoke.py arm those points with
`inject_crash(...)` to simulate a process dying mid-save. The harness also
poisons training batches with NaNs (to exercise TrainStep's NaN guard),
kills DataLoader worker processes and delivers fake preemption signals.
The rank, process-hang and store-partition helpers wait for the
distributed slice.

Standard library only: framework/io.py and forked DataLoader workers
import it.
"""
from __future__ import annotations

import os
import signal as _signal
import threading
from typing import Dict, Iterable, Optional

__all__ = [
    "InjectedCrash", "inject_crash", "crash_point", "clear", "armed",
    "poison_steps", "should_poison", "note_poisoned", "kill_worker",
    "fake_preemption", "stats", "reset_stats", "scope",
]


class InjectedCrash(RuntimeError):
    """Raised at an armed crash point; simulates the process dying there."""

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


_lock = threading.Lock()
_crash_points: Dict[str, dict] = {}   # name -> {"after": int, "mode": str}
_poison_steps: set = set()

stats = {
    "crashes_injected": 0,
    "steps_poisoned": 0,
    "workers_killed": 0,
    "signals_sent": 0,
}


def reset_stats():
    for k in stats:
        stats[k] = 0


def clear():
    """Disarm every crash point and poison schedule (stats are kept)."""
    with _lock:
        _crash_points.clear()
        _poison_steps.clear()


def armed(point: Optional[str] = None) -> bool:
    with _lock:
        if point is None:
            return bool(_crash_points)
        return point in _crash_points


def inject_crash(point: str, after: int = 0, mode: str = "raise"):
    """Arm `point`: the (after+1)-th hit fires. mode="raise" raises
    InjectedCrash (the write path really stops mid-flight); mode="exit"
    calls os._exit(23), for subprocess tests where not even finally-blocks
    may run."""
    if mode not in ("raise", "exit"):
        raise ValueError(f"unknown crash mode {mode!r}")
    with _lock:
        _crash_points[point] = {"after": int(after), "mode": mode}


def crash_point(name: str):
    """Instrumentation hook called by production code. No-op unless armed."""
    with _lock:
        entry = _crash_points.get(name)
        if entry is None:
            return
        if entry["after"] > 0:
            entry["after"] -= 1
            return
        del _crash_points[name]  # one-shot: the "process" died here once
        mode = entry["mode"]
        stats["crashes_injected"] += 1
    if mode == "exit":  # pragma: no cover - subprocess tests only
        os._exit(23)
    raise InjectedCrash(name)


# -- NaN poisoning ----------------------------------------------------------

def poison_steps(steps: Iterable[int]):
    """Schedule global step indices whose batch gets a NaN planted (the
    ResilientTrainer consults this before each step)."""
    with _lock:
        _poison_steps.update(int(s) for s in steps)


def should_poison(step: int) -> bool:
    with _lock:
        return int(step) in _poison_steps


def note_poisoned(step: int):
    with _lock:
        _poison_steps.discard(int(step))
        stats["steps_poisoned"] += 1


# -- process-level faults ---------------------------------------------------

def kill_worker(pool, wid: int = 0, sig: int = _signal.SIGKILL):
    """Hard-kill one DataLoader worker process (io/worker.py WorkerPool)."""
    proc = pool.procs[wid]
    os.kill(proc.pid, sig)
    stats["workers_killed"] += 1


def fake_preemption(sig: int = _signal.SIGTERM):
    """Deliver a real signal to this process: exercises the installed
    PreemptionHandler as a scheduler's SIGTERM would."""
    stats["signals_sent"] += 1
    os.kill(os.getpid(), sig)


class scope:
    """Context manager: arm injections inside, guaranteed clear() on exit."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        clear()
        return False
