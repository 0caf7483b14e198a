"""Per-step training telemetry and the process's event channel
(counterpart of paddle_tpu/observability/telemetry.py).

`jit.TrainStep(telemetry=True)` emits one record a call: loss, the
pre-clip gradient global norm, learning rate, skipped, the phases' wall
times (data / compute / reduce / save), samples and tokens a second and the
estimated MFU. The assembly protocol is the reference's:

  * a training loop times its data wait before the step and calls
    `pre_phase("data", dt)`: it lands on the NEXT record;
  * TrainStep calls `on_step(core)` with the loss, norm, lr and compute
    time measured around its own call; this STAGES the record (and pushes
    it, by reference, into the flight recorder's step ring);
  * the loop times a save after the step and calls `post_phase("save",
    dt)`: merged into the staged record;
  * the NEXT `on_step` (or `finalize()`) writes the completed record to the
    JSONL event log under FLAGS_metrics_dir.

`reduce` is the data-parallel TrainStep's `reduce_s`, the time of its
comm-only probe, carved out of compute as the reference does; it stays
0 without data parallelism. The MFU's
denominator is `peak_flops` of the card the process runs on, the H100's
bf16 dense peak, not the reference's TPU figure; where no CUDA card is
present (or its peak is not stated) the record carries no MFU.

`StepTelemetry.event` writes an irregular event (an anomaly, say) to the
log at once and notes it in the flight recorder. Everything is inert while
FLAGS_metrics is off.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from . import flight_recorder, sinks
from .registry import (counter, default_registry, gauge, histogram,
                       metrics_enabled)
from ..core.flags import get_flag

#: bf16 dense peak of one NVIDIA H100 SXM (NVIDIA's data sheet, no
#: sparsity, at its 700 W limit); the port's MFU denominator on that card
H100_BF16_PEAK_FLOPS = 989e12

PHASES = ("data", "compute", "reduce", "save")

_STEPS = counter("training_steps_total", "Optimizer steps executed.")
_SKIPPED = counter("training_steps_skipped_total",
                   "Steps skipped by the NaN/Inf step-guard.")
_LOSS = gauge("training_loss", "Loss of the most recent step.")
_GNORM = gauge("training_grad_norm",
               "Gradient global-norm of the most recent step (pre-clip).")
_LR = gauge("training_lr", "Learning rate of the most recent step.")
_SPS = gauge("training_samples_per_second", "Recent-step throughput.")
_TPS = gauge("training_tokens_per_second", "Recent-step token throughput.")
_MFU = gauge("training_mfu",
             "Estimated model FLOPs utilization of the most recent step.")
_PHASE_S = counter("training_phase_seconds_total",
                   "Cumulative wall time per step phase.",
                   labelnames=("phase",))
_PHASE_H = histogram("training_phase_seconds",
                     "Per-step wall time by phase.", labelnames=("phase",))

_PROM_EVERY = 50  # steps between Prometheus textfile rewrites (finalize()
                  # always writes one, so short runs still get a file)
_MEM_EVERY = 20   # steps between device/host memory-gauge refreshes


def enabled() -> bool:
    return metrics_enabled()


def peak_flops(device_name: str) -> Optional[float]:
    """bf16 dense peak FLOP/s of the named card (torch.cuda.
    get_device_name), or None for a card whose peak the port does not
    state."""
    return H100_BF16_PEAK_FLOPS if "H100" in str(device_name) else None


@functools.cache
def _card_peak() -> Optional[float]:
    if not torch.cuda.is_available():
        return None
    return peak_flops(torch.cuda.get_device_name())


class StepTelemetry:
    """Process-wide per-step record assembler and event channel
    (get_telemetry() singleton)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._staged: Optional[Dict[str, Any]] = None
        self._pending_phases: Dict[str, float] = {}
        self._last_step_t: Optional[float] = None
        self._jsonl: Optional[sinks.JsonlEventLog] = None
        self._jsonl_dir: Optional[str] = None
        self._flushed = 0
        self.records_emitted = 0
        self._totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._last: Dict[str, Any] = {}

    # -- sinks -------------------------------------------------------------
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

    def export_prometheus(self) -> Optional[str]:
        d = self._metrics_dir()
        if not d:
            return None
        return sinks.write_prometheus_textfile(
            os.path.join(d, sinks.PROM_FILENAME), default_registry())

    # -- phase accounting --------------------------------------------------
    def pre_phase(self, name: str, seconds: float) -> None:
        """Phase time measured BEFORE the step it belongs to (data wait)."""
        if not enabled():
            return
        with self._lock:
            self._pending_phases[name] = \
                self._pending_phases.get(name, 0.0) + float(seconds)

    def post_phase(self, name: str, seconds: float) -> None:
        """Phase time measured AFTER its step (a checkpoint save): merged
        into the staged record so it ships with the right step."""
        if not enabled():
            return
        s = float(seconds)
        with self._lock:
            staged = self._staged
            if staged is not None:
                staged["phases"][name] = staged["phases"].get(name, 0.0) + s
        _PHASE_S.inc(s, phase=name)
        _PHASE_H.observe(s, phase=name)
        self._totals[name] = self._totals.get(name, 0.0) + s

    # -- per-step core (called by jit.TrainStep) ---------------------------
    def on_step(self, core: Dict[str, Any]) -> Dict[str, Any]:
        """Stage the record for one completed step; flush the previous one.
        `core` carries step, loss, lr, compute_s; optionally grad_norm,
        skipped, samples, tokens, flops."""
        now = time.perf_counter()
        with self._lock:
            prev, self._staged = self._staged, None
            phases = {p: 0.0 for p in PHASES}
            phases.update(self._pending_phases)
            self._pending_phases = {}
        if prev is not None:
            self._write(prev)

        compute_s = float(core.get("compute_s", 0.0))
        # the data-parallel step's probed reduce time, attributed out of
        # its measured wall so the phases still sum to it
        reduce_s = min(float(core.get("reduce_s", 0.0) or 0.0), compute_s)
        if reduce_s > 0.0:
            phases["reduce"] = phases.get("reduce", 0.0) + reduce_s
            compute_s -= reduce_s
        phases["compute"] = phases.get("compute", 0.0) + compute_s
        # step to step wall time covers data + compute + save; throughput
        # and MFU use it when there is one (first step: compute only)
        step_wall = (now - self._last_step_t) if self._last_step_t else \
            max(compute_s, 1e-9)
        self._last_step_t = now

        rec: Dict[str, Any] = {
            "kind": "step",
            "ts": time.time(),
            "step": int(core["step"]),
            "loss": _f(core.get("loss")),
            "grad_norm": _f(core.get("grad_norm")),
            "lr": _f(core.get("lr")),
            "skipped": bool(core.get("skipped", False)),
            "phases": phases,
            "step_wall_s": round(step_wall, 6),
            "reduce_overlapped": bool(core.get("reduce_overlapped", True)),
        }
        samples = core.get("samples")
        tokens = core.get("tokens")
        if samples:
            rec["samples"] = int(samples)
            rec["samples_per_s"] = round(samples / step_wall, 3)
        if tokens:
            rec["tokens"] = int(tokens)
            rec["tokens_per_s"] = round(tokens / step_wall, 3)
        flops = core.get("flops")
        peak = _card_peak()
        if flops and peak:
            rec["mfu"] = round(float(flops) / step_wall / peak, 6)

        # registry mirrors
        _STEPS.inc()
        if rec["skipped"]:
            _SKIPPED.inc()
        for g, key in ((_LOSS, "loss"), (_GNORM, "grad_norm"), (_LR, "lr"),
                       (_SPS, "samples_per_s"), (_TPS, "tokens_per_s"),
                       (_MFU, "mfu")):
            if rec.get(key) is not None:
                g.set(rec[key])
        for p in ("data", "compute", "reduce"):
            if phases.get(p):
                _PHASE_S.inc(phases[p], phase=p)
                _PHASE_H.observe(phases[p], phase=p)
                self._totals[p] = self._totals.get(p, 0.0) + phases[p]

        with self._lock:
            self._staged = rec
            self._last = rec
        flight_recorder.get_flight_recorder().record_step(rec)
        if rec["step"] % _MEM_EVERY == 0:
            from . import memory

            memory.update_memory_gauges()
        return rec

    def last_record(self) -> Optional[Dict[str, Any]]:
        """The most recent staged step record (late phase merges mutate it
        in place)."""
        with self._lock:
            return self._last or None

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

    # -- flushing ----------------------------------------------------------
    def _write(self, rec: Dict[str, Any]) -> None:
        sink = self._sink()
        if sink is not None:
            sink.emit(rec)
        self.records_emitted += 1
        self._flushed += 1
        if self._flushed % _PROM_EVERY == 0:
            try:
                self.export_prometheus()
            except OSError:
                pass

    def finalize(self) -> None:
        """Write the staged record and rewrite the Prometheus textfile: call
        at the end of a run."""
        with self._lock:
            staged, self._staged = self._staged, None
        if staged is not None:
            self._write(staged)
        try:
            self.export_prometheus()
        except OSError:
            pass

    flush = finalize

    # -- summaries ---------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Mean ms a phase over the records, and the last step's figures."""
        n = max(self.records_emitted +
                (1 if self._staged is not None else 0), 1)
        out: Dict[str, Any] = {
            "records": self.records_emitted,
            "phase_ms_avg": {p: round(self._totals.get(p, 0.0) / n * 1e3, 3)
                             for p in PHASES},
        }
        last = dict(self._last)
        for k in ("step", "loss", "grad_norm", "samples_per_s",
                  "tokens_per_s", "mfu"):
            if last.get(k) is not None:
                out[f"last_{k}"] = last[k]
        return out

    def close(self) -> None:
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


def _f(v) -> Optional[float]:
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


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
