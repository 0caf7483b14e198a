"""Process-wide metrics registry: Counter, Gauge and Histogram with labels
(counterpart of paddle_tpu/observability/registry.py).

Every subsystem registers through one registry, so a live process exports
one consistent snapshot (Prometheus text, sinks.py). Recording is a dict
lookup and a float add under a per-metric lock. Metrics respect
FLAGS_metrics ("off" makes `inc`, `set` and `observe` return at once);
those whose counts must hold regardless (every serving_* metric: the
engine's stats() and the allocator's gauges read through them) register
with `always=True`.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.flags import define_flag, get_flag

define_flag(
    "metrics", "off",
    "Observability layer (observability/): 'on' enables metric sinks, span "
    "recording, request traces, per-tick serving gauges and the flight "
    "recorder; 'off' reduces them to near-zero-overhead no-ops (the "
    "always-on serving counters keep counting).")
define_flag(
    "metrics_dir", "",
    "Directory for metric sinks: events.jsonl (append-only event log), "
    "paddle_tpu.prom (Prometheus textfile) and flight/ (flight-recorder "
    "dumps). Empty = in memory only.")

_TRUE = ("1", "on", "true", "yes")


def metrics_enabled() -> bool:
    return str(get_flag("metrics")).lower() in _TRUE


# default histogram bounds: latencies in seconds, 100 us .. 100 s
_DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3,
                    1.0, 3.0, 10.0, 30.0, 100.0)


class _Metric:
    """One named metric holding per-label-set values."""

    kind = "untyped"

    def __init__(self, name: str, doc: str = "",
                 labelnames: Sequence[str] = (), always: bool = False):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self.always = bool(always)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def labels(self, **labels) -> "_Bound":
        return _Bound(self, self._key(labels))

    def _enabled(self) -> bool:
        return self.always or metrics_enabled()

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def total(self) -> float:
        """Sum across all label sets (0.0 when never recorded)."""
        with self._lock:
            return sum(self._values.values())

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        with self._lock:
            items = list(self._values.items())
        return [(dict(zip(self.labelnames, k)), v) for k, v in items]

    def _set_raw(self, value: float, key: Tuple[str, ...] = ()):
        with self._lock:
            self._values[key] = float(value)

    def _add_raw(self, amount: float, key: Tuple[str, ...] = ()):
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def reset(self):
        with self._lock:
            self._values.clear()


class _Bound:
    """A metric bound to one label set (`metric.labels(x=...)`)."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: _Metric, key: Tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0):
        if self._metric._enabled():
            self._metric._add_raw(float(amount), self._key)

    def set(self, value: float):
        if self._metric._enabled():
            self._metric._set_raw(float(value), self._key)

    def observe(self, value: float):
        self._metric.observe(value, **dict(
            zip(self._metric.labelnames, self._key)))

    def value(self) -> float:
        with self._metric._lock:
            return self._metric._values.get(self._key, 0.0)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        if self._enabled():
            self._add_raw(float(amount), self._key(labels))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        if self._enabled():
            self._set_raw(float(value), self._key(labels))


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics): per label set,
    bucket counts for the `le` bounds plus _sum and _count."""

    kind = "histogram"

    def __init__(self, name: str, doc: str = "",
                 labelnames: Sequence[str] = (), always: bool = False,
                 buckets: Iterable[float] = _DEFAULT_BUCKETS):
        super().__init__(name, doc, labelnames, always)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label key: [bucket counts..., +Inf count, sum]
        self._hist: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, **labels):
        if not self._enabled():
            return
        key = self._key(labels)
        v = float(value)
        with self._lock:
            row = self._hist.get(key)
            if row is None:
                row = self._hist[key] = [0.0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    row[i] += 1
            row[-2] += 1
            row[-1] += v
            self._values[key] = row[-2]     # value() reads the count

    def stats(self, **labels) -> Dict[str, float]:
        key = self._key(labels)
        with self._lock:
            row = self._hist.get(key)
            if row is None:
                return {"count": 0, "sum": 0.0}
            return {"count": row[-2], "sum": row[-1]}

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Quantile from the cumulative buckets (linear inside a bucket,
        Prometheus histogram_quantile): nan with no observation, the
        observation itself with one, the last finite bound past it."""
        q = min(max(float(q), 0.0), 1.0)
        key = self._key(labels)
        with self._lock:
            row = self._hist.get(key)
            row = list(row) if row is not None else None
        return self._row_quantile(row, q)

    def _row_quantile(self, row: Optional[List[float]],
                      q: float) -> Optional[float]:
        if row is None or row[-2] <= 0:
            return float("nan")
        if row[-2] == 1:
            return row[-1]
        rank = q * row[-2]
        lo = prev_count = 0.0
        for i, b in enumerate(self.buckets):
            if row[i] >= rank:
                in_bucket = row[i] - prev_count
                if in_bucket <= 0:
                    return b
                return lo + (b - lo) * (rank - prev_count) / in_bucket
            lo, prev_count = b, row[i]
        return self.buckets[-1] if self.buckets else None

    def rollup_quantiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[str, float]:
        """Quantiles over the merge of every label set's row (bucket counts
        and sums add), keyed "p50", "p95", ...; {} when nothing was
        observed (the fleet's SLO rollups)."""
        with self._lock:
            rows = [list(r) for r in self._hist.values() if r[-2] > 0]
        if not rows:
            return {}
        merged = [sum(col) for col in zip(*rows)]
        return {f"p{int(round(float(q) * 100))}":
                self._row_quantile(merged, float(q)) for q in qs}

    def samples(self):
        """(labels, value, series) triples, the text writer's expansion."""
        with self._lock:
            items = [(k, list(r)) for k, r in self._hist.items()]
        out = []
        for key, row in items:
            base = dict(zip(self.labelnames, key))
            for i, b in enumerate(self.buckets):
                out.append((dict(base, le=repr(b)), row[i],
                            self.name + "_bucket"))
            out.append((dict(base, le="+Inf"), row[-2],
                        self.name + "_bucket"))
            out.append((base, row[-1], self.name + "_sum"))
            out.append((dict(base), row[-2], self.name + "_count"))
        return out

    def reset(self):
        with self._lock:
            self._values.clear()
            self._hist.clear()


class MetricsRegistry:
    """Name -> metric table. Registration is idempotent: re-registering the
    same (name, kind) returns the existing metric."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, doc, labelnames, always, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = self._metrics[name] = cls(name, doc, labelnames, always,
                                          **kw)
            return m

    def counter(self, name: str, doc: str = "",
                labelnames: Sequence[str] = (),
                always: bool = False) -> Counter:
        return self._get_or_create(Counter, name, doc, labelnames, always)

    def gauge(self, name: str, doc: str = "", labelnames: Sequence[str] = (),
              always: bool = False) -> Gauge:
        return self._get_or_create(Gauge, name, doc, labelnames, always)

    def histogram(self, name: str, doc: str = "",
                  labelnames: Sequence[str] = (), always: bool = False,
                  buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, doc, labelnames, always,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{metric: {"label=a|label2=b": value}}, what a flight dump
        embeds (a histogram row is {"count", "sum"})."""
        out: Dict[str, Dict[str, float]] = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                with m._lock:
                    out[m.name] = {
                        "|".join(f"{n}={v}" for n, v in
                                 zip(m.labelnames, key)) or "_":
                        {"count": row[-2], "sum": row[-1]}
                        for key, row in m._hist.items()}
                continue
            out[m.name] = {
                "|".join(f"{n}={v}" for n, v in lbls.items()) or "_": val
                for lbls, val in m.samples()}
        return out

    def reset(self):
        """Zero every metric; registrations survive."""
        for m in self.metrics():
            m.reset()


REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY


def counter(name: str, doc: str = "", labelnames: Sequence[str] = (),
            always: bool = False) -> Counter:
    return REGISTRY.counter(name, doc, labelnames, always)


def gauge(name: str, doc: str = "", labelnames: Sequence[str] = (),
          always: bool = False) -> Gauge:
    return REGISTRY.gauge(name, doc, labelnames, always)


def histogram(name: str, doc: str = "", labelnames: Sequence[str] = (),
              always: bool = False,
              buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, doc, labelnames, always, buckets=buckets)
