"""Span tracing: one process-wide bounded ring of completed spans
(counterpart of paddle_tpu/observability/spans.py, pure Python: the
reference's native-tracer mirror is not ported).

Consumers: the serving request traces (serving/observability.py), which
record through `record_span` while `enabled()` (FLAGS_metrics on), and the
flight recorder, whose dumps carry `tail(n)`. Clock: time.monotonic_ns().
The reference's `span` context manager, profiler sessions and watermarks
wait for the profiler's port.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from .registry import metrics_enabled

_MAX_SPANS = 65536

_lock = threading.Lock()
_ring: deque = deque(maxlen=_MAX_SPANS)
_seq = 0


def enabled() -> bool:
    return metrics_enabled()


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


def tail(n: int = 200) -> List[Dict]:
    with _lock:
        items = list(_ring)[-int(n):]
    return [s for _, s in items]


def clear() -> None:
    global _seq
    with _lock:
        _ring.clear()
        _seq = 0

