"""Process-wide metrics registry: labeled Counter and Gauge.

Counterpart of paddle_tpu/observability/registry.py, cut to the surface the
serving slice uses (the allocator's and scheduler's gauges and counters and
the engine's per-instance event counters): register, set or increment,
read one label set's value. Every metric the slice registers records
unconditionally, as the reference's `always=True` metrics do, so there is no
FLAGS_metrics switch here. Histograms, sinks, snapshots and resets wait for
the observability slice.
"""
from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple


class _Metric:
    """One named metric holding per-label-set values."""

    kind = "untyped"

    def __init__(self, name: str, doc: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class MetricsRegistry:
    """Name -> metric table. Registration is idempotent: re-registering the
    same (name, kind) returns the existing metric."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, doc, labelnames):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = self._metrics[name] = cls(name, doc, labelnames)
            return m

    def counter(self, name: str, doc: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, doc, labelnames)

    def gauge(self, name: str, doc: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, doc, labelnames)


REGISTRY = MetricsRegistry()


def counter(name: str, doc: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, doc, labelnames)


def gauge(name: str, doc: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, doc, labelnames)
