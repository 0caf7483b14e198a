"""Online anomaly detection over per-step and per-tick records
(counterpart of paddle_tpu/observability/anomaly.py: the rolling-window
engine, the training detectors and the serving detectors; the fleet
detectors wait for that slice).

Detectors consume the records telemetry (training) and the serving arm
(serving/observability.py) already assemble and turn a regression into a
structured `anomaly` event: counted, written to the event log, noted in
the flight recorder and, unless disarmed, dumped with it. They fire only
once warm (min_points) and re-arm after `cooldown` records, so one bad
phase gives one anomaly, not one per step. Inert unless FLAGS_metrics=on;
the ResilientTrainer builds the training engine only when FLAGS_anomaly is
on too (`from_flags`). The reference's compile-cache collapse detector is
left out: the port compiles no programs whose cache could collapse, and
its step records carry no compile-cache counters.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import flight_recorder, telemetry
from .registry import counter, metrics_enabled
from ..core.flags import define_flag, get_flag

define_flag(
    "anomaly", "off",
    "Online anomaly engine: 'on' runs the rolling detectors and dumps the "
    "flight recorder when one fires. Needs FLAGS_metrics=on.")

_ANOMALIES = counter("anomaly_events_total",
                     "Anomalies detected by the online engine, by kind.",
                     labelnames=("kind",))

_TRUE = ("1", "on", "true", "yes")


def anomaly_enabled() -> bool:
    return metrics_enabled() and str(get_flag("anomaly")).lower() in _TRUE

class RollingDetector:
    """Keeps a bounded window of one scalar field; subclasses decide."""

    kind = "anomaly"
    field = "loss"

    def __init__(self, window: int = 32, min_points: int = 8,
                 cooldown: int = 25):
        self.window = deque(maxlen=int(window))
        self.min_points = int(min_points)
        self.cooldown = int(cooldown)
        self._cooldown_until = -1

    def value(self, rec: Dict[str, Any]) -> Optional[float]:
        v = rec.get(self.field)
        try:
            return float(v) if v is not None else None
        except (TypeError, ValueError):
            return None

    def check(self, v: float, rec: Dict[str, Any]) -> Optional[Dict]:
        raise NotImplementedError

    def observe(self, rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        v = self.value(rec)
        if v is None:
            return None
        step = int(rec.get("step", -1))
        out = None
        if len(self.window) >= self.min_points and \
                step > self._cooldown_until:
            out = self.check(v, rec)
            if out is not None:
                self._cooldown_until = step + self.cooldown
                out.setdefault("kind", self.kind)
                out.setdefault("field", self.field)
                out["step"] = step
                out["value"] = round(v, 6)
        self.window.append(v)
        return out


class _ZSpike(RollingDetector):
    """value > mean + z*sigma AND > factor*mean: both a statistical outlier
    and materially larger (sigma floors keep flat phases from firing)."""

    z = 6.0
    factor = 1.5

    def check(self, v, rec):
        vals = list(self.window)
        n = len(vals)
        mean = sum(vals) / n
        var = sum((x - mean) ** 2 for x in vals) / n
        sigma = max(var ** 0.5, abs(mean) * 0.02, 1e-12)
        if v > mean + self.z * sigma and v > self.factor * abs(mean):
            return {"mean": round(mean, 6), "sigma": round(sigma, 6),
                    "zscore": round((v - mean) / sigma, 3)}
        return None


class LossSpike(_ZSpike):
    kind = "loss_spike"
    field = "loss"


class GradNormSpike(_ZSpike):
    kind = "grad_norm_spike"
    field = "grad_norm"


class _SustainedRatio(RollingDetector):
    """value / rolling median past a bound for `patience` consecutive
    records (one hiccup is not a regression)."""

    ratio = 2.0
    patience = 3
    direction = "above"  # or "below"

    def __init__(self, window: int = 32, min_points: int = 8,
                 cooldown: int = 25, patience: Optional[int] = None):
        super().__init__(window, min_points, cooldown)
        if patience is not None:
            self.patience = int(patience)
        self._streak = 0

    def _median(self) -> float:
        s = sorted(self.window)
        n = len(s)
        return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0

    def check(self, v, rec):
        med = self._median()
        if med <= 0:
            return None
        r = v / med
        bad = r > self.ratio if self.direction == "above" \
            else r < self.ratio
        if not bad:
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self.patience:
            return None
        self._streak = 0
        return {"median": round(med, 6), "ratio": round(r, 3),
                "patience": self.patience}


class StepTimeRegression(_SustainedRatio):
    kind = "step_time_regression"
    field = "step_wall_s"
    ratio = 2.0
    direction = "above"


class ThroughputCollapse(_SustainedRatio):
    kind = "throughput_collapse"
    field = "tokens_per_s"
    ratio = 0.5
    direction = "below"

    def value(self, rec):
        v = rec.get("tokens_per_s", rec.get("samples_per_s"))
        try:
            return float(v) if v is not None else None
        except (TypeError, ValueError):
            return None


def default_detectors(**kw) -> List[RollingDetector]:
    """The training detectors over TrainStep's step records."""
    return [LossSpike(**kw), GradNormSpike(**kw), StepTimeRegression(**kw),
            ThroughputCollapse(**kw)]


class TTFTRegression(_SustainedRatio):
    """Mean TTFT of a tick's admissions > ratio x rolling median for
    `patience` consecutive ticks with admissions."""

    kind = "ttft_regression"
    field = "ttft_s"
    ratio = 3.0
    direction = "above"


class GoodputCollapse(_SustainedRatio):
    """Windowed decoded tokens/s < ratio x rolling median while work is
    queued or running."""

    kind = "goodput_collapse"
    field = "goodput_tokens_per_s"
    ratio = 0.5
    direction = "below"

    def value(self, rec):
        v = super().value(rec)
        if v is None or not (rec.get("running") or rec.get("waiting")):
            return None            # an idle engine is not a collapse
        return v


class CacheHitCollapse(_SustainedRatio):
    """Rolling prefix-cache hit rate < ratio x its own median."""

    kind = "cache_hit_collapse"
    field = "prefix_hit_rate"
    ratio = 0.5
    direction = "below"


class KVConservationBreach(RollingDetector):
    """The allocator's conservation law (live + evictable + free ==
    num_blocks - 1) broken: fires on the first breached tick."""

    kind = "kv_conservation_breach"
    field = "kv_conservation_breach"

    def __init__(self, window: int = 32, cooldown: int = 25):
        super().__init__(window, min_points=0, cooldown=cooldown)

    def check(self, v, rec):
        return {} if v > 0 else None


def serving_default_detectors(**kw) -> List[RollingDetector]:
    return [TTFTRegression(**kw), GoodputCollapse(**kw),
            CacheHitCollapse(**kw), KVConservationBreach()]


# the fleet's detectors bound absolute values: the healthy baseline of
# hedges, re-dispatches and breaker transitions is zero, so a detector
# relative to a median would never warm up into firing
class _SustainedThreshold(RollingDetector):
    """The value past an absolute bound for `patience` records in a row;
    no warm-up history (the records' fields are windowed rates)."""

    bound = 1.0
    patience = 1
    direction = "above"  # or "below"

    def __init__(self, window: int = 32, min_points: int = 0,
                 cooldown: int = 25, patience: Optional[int] = None,
                 bound: Optional[float] = None):
        super().__init__(window, min_points, cooldown)
        if patience is not None:
            self.patience = int(patience)
        if bound is not None:
            self.bound = float(bound)
        self._streak = 0

    def check(self, v, rec):
        bad = v > self.bound if self.direction == "above" \
            else v < self.bound
        if not bad:
            self._streak = 0
            return None
        self._streak += 1
        if self._streak < self.patience:
            return None
        self._streak = 0
        return {"bound": self.bound, "patience": self.patience}


class HedgeRateSpike(_SustainedThreshold):
    """Hedges fired over placements in the tick window past the bound: a
    hedge storm (replicas slow across the board, or a deadline under an
    honest TTFT); every hedge doubles the load."""

    kind = "hedge_rate_spike"
    field = "hedge_rate"
    bound = 0.3
    patience = 1


class RedispatchStorm(_SustainedThreshold):
    """Re-dispatches over placements in the tick window past the bound:
    replicas dying (or declared dead) faster than one failure explains."""

    kind = "redispatch_storm"
    field = "redispatch_rate"
    bound = 0.3
    patience = 1


class BreakerFlap(_SustainedThreshold):
    """A replica's breaker transitions in the window at or past the bound
    (two open -> half_open -> open cycles): probes keep succeeding into a
    replica that keeps failing real traffic."""

    kind = "breaker_flap"
    field = "breaker_flaps"
    bound = 4.0
    patience = 1

    def check(self, v, rec):
        if v < self.bound:
            self._streak = 0
            return None
        return {"bound": self.bound, "patience": self.patience}


class ReplicaSkew(_SustainedThreshold):
    """The largest replica p95 TTFT over the smallest past the bound,
    sustained: one replica is slower than the rest."""

    kind = "replica_skew"
    field = "ttft_skew"
    bound = 3.0
    patience = 3


def fleet_default_detectors(**kw) -> List[RollingDetector]:
    return [HedgeRateSpike(**kw), RedispatchStorm(**kw),
            BreakerFlap(**kw), ReplicaSkew(**kw)]


class AnomalyEngine:
    """Feeds records through every detector; on a hit emits the `anomaly`
    event (counter, event log, flight-recorder note) and, unless
    disarmed, dumps the flight recorder with the anomaly attached.
    `recent()` is safe to read from another thread."""

    def __init__(self, detectors: Optional[List[RollingDetector]] = None,
                 *, dump: bool = True, dump_cooldown_steps: int = 50):
        self.detectors = list(detectors if detectors is not None
                              else default_detectors())
        self.dump = bool(dump)
        self.dump_cooldown_steps = int(dump_cooldown_steps)
        self._dump_armed_at = -1
        self._lock = threading.Lock()
        self._recent: deque = deque(maxlen=64)
        self.dumps: List[str] = []

    def observe(self, record: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Run every detector over one record; returns the anomalies."""
        found = [ev for ev in (d.observe(record) for d in self.detectors)
                 if ev is not None]
        for ev in found:
            self._emit(ev)
        return found

    def _emit(self, ev: Dict[str, Any]) -> None:
        ev = dict(ev, ts=time.time())
        with self._lock:
            self._recent.append(ev)
        _ANOMALIES.inc(kind=ev["kind"])
        telemetry.get_telemetry().event(
            "anomaly", anomaly_kind=ev["kind"],
            **{k: v for k, v in ev.items() if k not in ("ts", "kind")})
        flight_recorder.note_anomaly(ev)
        step = int(ev.get("step", -1))
        if self.dump and step > self._dump_armed_at:
            self._dump_armed_at = step + self.dump_cooldown_steps
            self.dumps.append(flight_recorder.get_flight_recorder().dump(
                f"anomaly_{ev['kind']}", extra={"anomaly": ev}))

    def recent(self, n: int = 16) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._recent)[-int(n):]


def from_flags(**kw) -> Optional[AnomalyEngine]:
    """A training engine when FLAGS_metrics=on and FLAGS_anomaly=on, else
    None (the ResilientTrainer's one-liner)."""
    return AnomalyEngine(**kw) if anomaly_enabled() else None
