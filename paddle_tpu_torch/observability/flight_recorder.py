"""Flight recorder: bounded rings of recent step records, events and
anomalies, with the span tail and a metrics snapshot, dumped atomically on
a trigger (counterpart of paddle_tpu/observability/flight_recorder.py).

Training feeds the step ring through telemetry (one record a TrainStep
call, FLAGS_flight_recorder_steps deep); the NaN guard's skip
(`on_nan_skip`) and an exception escaping a training loop
(`on_exception`) and a latched preemption (`on_preemption`) dump it;
the serving arm in serving/observability.py dumps
through it when a serving anomaly fires. A dump is written to a temporary
file, fsynced and renamed into place, so a crash mid-dump never leaves a
torn file. Dumps land in FLAGS_metrics_dir/flight/ (or ./flight_recorder
when no metrics dir is set). The triggers do nothing while FLAGS_metrics
is off. The cluster view and the membership trigger wait for the
distributed slice.
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from . import spans
from .registry import counter, default_registry, metrics_enabled
from .sinks import _json_default
from ..core.flags import define_flag, get_flag

define_flag(
    "flight_recorder_steps", 64,
    "Ring-buffer capacity of the crash flight recorder: how many of the "
    "most recent per-step telemetry records survive into a crash dump.")

_DUMPS = counter("flight_recorder_dumps_total",
                 "Flight-recorder dumps written, by trigger reason.",
                 labelnames=("reason",), always=True)

_EVENT_RING = 256
_SPAN_TAIL = 200
_ANOMALY_RING = 32

# a process-wide sequence keeps two dumps in one second apart
_DUMP_SEQ = itertools.count()


def safe_reason(reason: str) -> str:
    """Filesystem-safe dump-name suffix from a trigger reason."""
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(reason))[:48]


def dump_filename(reason: str, n: int) -> str:
    """flight_<wall clock>_<pid>_<instance count>_<process seq>_<reason>
    .json: unique within the process across recorder resets."""
    seq = next(_DUMP_SEQ)
    return (f"flight_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}"
            f"_{int(n):03d}_{seq:04d}_{safe_reason(reason)}.json")


def note_anomaly(event: Dict[str, Any]) -> None:
    """Record one anomaly into the recorder's bounded anomaly ring."""
    get_flight_recorder().record_anomaly(event)


class FlightRecorder:
    """Bounded in-memory black box; `dump()` writes it atomically."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = max(int(get_flag("flight_recorder_steps")), 1)
        self.capacity = capacity
        self._lock = threading.Lock()
        self._steps: deque = deque(maxlen=capacity)
        self._events: deque = deque(maxlen=_EVENT_RING)
        self._anomalies: deque = deque(maxlen=_ANOMALY_RING)
        self._dump_count = 0

    def record_step(self, record: Dict[str, Any]) -> None:
        """Push one step record (kept by reference, so a phase merged into
        it after the step still shows in a later dump)."""
        with self._lock:
            self._steps.append(record)

    def note(self, kind: str, **data) -> None:
        """Record an irregular event."""
        ev = {"kind": str(kind), "ts": time.time()}
        ev.update(data)
        with self._lock:
            self._events.append(ev)

    def record_anomaly(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._anomalies.append(dict(event))

    def steps(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._steps)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def anomalies(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._anomalies)

    def _dump_dir(self, directory: Optional[str]) -> str:
        if directory:
            return os.path.abspath(directory)
        mdir = str(get_flag("metrics_dir") or "")
        if mdir:
            return os.path.join(os.path.abspath(mdir), "flight")
        return os.path.abspath("flight_recorder")

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             directory: Optional[str] = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the black box to disk atomically; returns the path.
        `extra` keys join the payload (the serving arm attaches the
        anomaly, the request records and the tick snapshots)."""
        with self._lock:
            self._dump_count += 1
            n = self._dump_count
            steps = list(self._steps)
            events = list(self._events)
            anomalies = list(self._anomalies)
        payload: Dict[str, Any] = {
            "kind": "flight_recorder_dump", "reason": str(reason),
            "ts": time.time(), "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "pid": os.getpid(), "capacity": self.capacity, "steps": steps,
            "events": events, "anomalies": anomalies,
            "spans": spans.tail(_SPAN_TAIL),
            "metrics": default_registry().snapshot(),
        }
        for k, v in (extra or {}).items():
            payload.setdefault(k, v)
        if exc is not None:
            payload["exception"] = {
                "type": type(exc).__name__, "message": str(exc),
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))[-8000:]}
        d = self._dump_dir(directory)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, dump_filename(reason, n))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=_json_default)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        _DUMPS.inc(reason=safe_reason(reason) or "manual")
        return path


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def reset() -> None:
    """Drop the singleton."""
    global _recorder
    with _recorder_lock:
        _recorder = None


# -- training triggers (called by jit.TrainStep and training loops) ----------
def on_nan_skip(step: int, loss: Optional[float] = None) -> Optional[str]:
    """The NaN guard skipped a step: note it and dump. Returns the dump's
    path, or None while metrics are off (the guard skips either way)."""
    if not metrics_enabled():
        return None
    rec = get_flight_recorder()
    rec.note("nan_skip", step=int(step), loss=loss)
    return rec.dump("nan_guard")


def on_exception(exc: BaseException) -> Optional[str]:
    """An exception escaped a training loop: note it and dump it with its
    traceback. None while metrics are off."""
    if not metrics_enabled():
        return None
    rec = get_flight_recorder()
    rec.note("exception", type=type(exc).__name__, message=str(exc)[:500])
    return rec.dump("exception", exc=exc)


def on_preemption(reason: str) -> Optional[str]:
    """PreemptionHandler latched (SIGTERM, SIGINT or a manual trigger)."""
    if not metrics_enabled():
        return None
    rec = get_flight_recorder()
    rec.note("preemption", reason=str(reason))
    return rec.dump(f"preemption_{reason}")
