"""Metric sinks: an append-only JSONL event log and the Prometheus text
exposition (counterpart of paddle_tpu/observability/sinks.py).

  * JsonlEventLog: one JSON object per line, flushed per write, so a crash
    loses at most the last partial line.
  * prometheus_text renders the registry; write_prometheus_textfile
    rewrites a textfile atomically (tmp + os.replace), so a scraper never
    reads a torn file; parse_prometheus_text reads the text back.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, Optional, Tuple

from .registry import Histogram, MetricsRegistry, default_registry

PROM_FILENAME = "paddle_tpu.prom"
EVENTS_FILENAME = "events.jsonl"


class JsonlEventLog:
    """Append-only JSONL writer; thread-safe; flushes every record."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._lock = threading.Lock()
        self._f = None

    def emit(self, record: Dict) -> None:
        line = json.dumps(record, default=_json_default)
        with self._lock:
            if self._f is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._f = open(self.path, "a", encoding="utf-8")
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _json_default(obj):
    """Records may carry numpy or torch scalars: write them as floats."""
    try:
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry in the Prometheus text exposition format."""
    registry = registry or default_registry()
    lines = []
    for m in sorted(registry.metrics(), key=lambda m: m.name):
        if m.doc:
            lines.append(f"# HELP {m.name} {m.doc}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            for labels, value, series in m.samples():
                lines.append(_sample_line(series, labels, value))
            continue
        samples = m.samples()
        if not samples:        # registered, never recorded: expose the 0
            lines.append(_sample_line(m.name, {}, 0.0))
        for labels, value in samples:
            lines.append(_sample_line(m.name, labels, value))
    return "\n".join(lines) + "\n"


def _sample_line(series: str, labels: Dict[str, str], value: float) -> str:
    if labels:
        lbl = ",".join(f'{k}="{_escape(v)}"'
                       for k, v in sorted(labels.items()))
        return f"{series}{{{lbl}}} {_fmt(value)}"
    return f"{series} {_fmt(value)}"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def write_prometheus_textfile(path: str,
                              registry: Optional[MetricsRegistry] = None
                              ) -> str:
    """Atomically (re)write the full exposition at `path`."""
    text = prometheus_text(registry)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".prom.tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def parse_prometheus_text(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str],
                                                              ...]], float]:
    """Inverse of prometheus_text:
    {(series, ((label, value), ...sorted)): sample value}."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, val_part = line.rpartition(" ")
        if "{" not in name_part:
            out[(name_part, ())] = float(val_part)
            continue
        series, _, rest = name_part.partition("{")
        parts, cur, in_q = [], "", False
        for ch in rest.rstrip("}"):      # split on commas outside quotes
            if ch == '"' and not cur.endswith("\\"):
                in_q = not in_q
            if ch == "," and not in_q:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        if cur:
            parts.append(cur)
        lbls = []
        for p in parts:
            k, _, v = p.partition("=")
            v = v.strip('"').replace(r"\"", '"').replace(r"\n", "\n") \
                 .replace(r"\\", "\\")
            lbls.append((k, v))
        out[(series, tuple(sorted(lbls)))] = float(val_part)
    return out
