"""The process's event channel and the card's peak rate (the part of
paddle_tpu/observability/telemetry.py that the anomaly engine and the
scrape endpoint read; the per-step training record waits for the training
slice's observability).

`StepTelemetry.event` writes an irregular event (an anomaly, say) to the
JSONL log under FLAGS_metrics_dir and notes it in the flight recorder.
`peak_flops` gives the MFU denominator of the card the port runs on.
Everything is inert while FLAGS_metrics is off.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

from . import flight_recorder, sinks
from .registry import metrics_enabled
from ..core.flags import get_flag

#: bf16 dense peak of one NVIDIA H100 SXM (NVIDIA's data sheet, no
#: sparsity, at its 700 W limit); the port's MFU denominator on that card
H100_BF16_PEAK_FLOPS = 989e12


def enabled() -> bool:
    return metrics_enabled()


def peak_flops(device_name: str) -> Optional[float]:
    """bf16 dense peak FLOP/s of the named card (torch.cuda.
    get_device_name), or None for a card whose peak the port does not
    state."""
    return H100_BF16_PEAK_FLOPS if "H100" in str(device_name) else None


class StepTelemetry:
    """Process-wide event channel (get_telemetry() singleton)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._jsonl: Optional[sinks.JsonlEventLog] = None
        self._jsonl_dir: Optional[str] = None
        self.records_emitted = 0

    def _metrics_dir(self) -> str:
        return str(get_flag("metrics_dir") or "")

    def _sink(self) -> Optional[sinks.JsonlEventLog]:
        d = self._metrics_dir()
        if not d:
            return None
        with self._lock:
            if self._jsonl is None or self._jsonl_dir != d:
                if self._jsonl is not None:
                    self._jsonl.close()
                self._jsonl = sinks.JsonlEventLog(
                    os.path.join(d, sinks.EVENTS_FILENAME))
                self._jsonl_dir = d
            return self._jsonl

    def event(self, kind: str, **data) -> None:
        """An irregular event: written to the event log at once and noted
        in the flight recorder."""
        if not enabled():
            return
        rec = {"kind": str(kind), "ts": time.time()}
        rec.update(data)
        sink = self._sink()
        if sink is not None:
            sink.emit(rec)
            self.records_emitted += 1
        flight_recorder.get_flight_recorder().note(kind, **data)

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


_telemetry: Optional[StepTelemetry] = None
_telemetry_lock = threading.Lock()


def get_telemetry() -> StepTelemetry:
    global _telemetry
    with _telemetry_lock:
        if _telemetry is None:
            _telemetry = StepTelemetry()
        return _telemetry


def reset() -> None:
    """A fresh singleton; closes the open event log."""
    global _telemetry
    with _telemetry_lock:
        if _telemetry is not None:
            _telemetry.close()
        _telemetry = None
