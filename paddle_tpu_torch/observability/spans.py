"""Span tracing: one process-wide bounded ring of completed spans
(counterpart of paddle_tpu/observability/spans.py, pure Python: the
reference's native-tracer mirror is not ported).

Producers: `span("name")` (TrainStep wraps each call in
"jit.train_step") and `record_span`, which the serving request traces
(serving/observability.py) call with their own timestamps. A span records
while FLAGS_metrics is on or a profiler session is open (`session(True)`);
otherwise `span()` is two checks and no clock read. Consumers: the flight
recorder, whose dumps carry `tail(n)`, and a session's reader, who takes
`mark()` when it opens and `since(mark)` when it closes. Clock:
time.monotonic_ns().
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .registry import metrics_enabled

_MAX_SPANS = 65536

_lock = threading.Lock()
_ring: deque = deque(maxlen=_MAX_SPANS)
_seq = 0
_session_depth = 0  # profiler sessions currently open


def session(on: bool) -> None:
    """Open (True) or close (False) a profiler recording session."""
    global _session_depth
    with _lock:
        _session_depth = max(_session_depth + (1 if on else -1), 0)


def enabled() -> bool:
    return _session_depth > 0 or metrics_enabled()


def mark() -> int:
    """Sequence watermark: `since(mark())` later returns the spans
    recorded after this point."""
    with _lock:
        return _seq


def record_span(name: str, begin_ns: int, end_ns: int, cat: str = "span",
                args: Optional[Dict] = None) -> None:
    """Append one completed span (monotonic_ns timestamps)."""
    global _seq
    span_d = {"name": str(name), "begin_ns": int(begin_ns),
              "end_ns": int(end_ns), "tid": threading.get_ident() & 0xFFFF,
              "cat": cat}
    if args:
        span_d["args"] = args
    with _lock:
        _seq += 1
        _ring.append((_seq, span_d))


def since(watermark: int) -> List[Dict]:
    with _lock:
        return [s for q, s in _ring if q > watermark]


def tail(n: int = 200) -> List[Dict]:
    with _lock:
        items = list(_ring)[-int(n):]
    return [s for _, s in items]


def clear() -> None:
    global _seq
    with _lock:
        _ring.clear()
        _seq = 0



class span:
    """Context manager recording one span into the ring while `enabled()`:

        with span("ckpt.commit", cat="io", args={"step": 7}):
            ...
    """

    __slots__ = ("name", "cat", "args", "_t0", "_on")

    def __init__(self, name: str, cat: str = "span",
                 args: Optional[Dict] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0
        self._on = False

    def __enter__(self):
        self._on = enabled()
        if self._on:
            self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        if self._on:
            record_span(self.name, self._t0, time.monotonic_ns(),
                        cat=self.cat, args=self.args)
        return False
