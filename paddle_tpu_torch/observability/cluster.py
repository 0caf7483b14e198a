"""Cross-rank telemetry aggregation and straggler detection (counterpart
of paddle_tpu/observability/cluster.py).

Each rank publishes a slim record of its step (phase timings, loss, grad
norm, throughput) into the process-group store (native.TCPStore across
processes, distributed.env.InProcStore for threads acting as ranks), and
rank 0 aggregates:

  * per-phase min / median / max / p95 across ranks -> `cluster_*` gauges
    and one `cluster_step` event per step;
  * straggler flags: a rank whose `compute` or `reduce` phase exceeds
    FLAGS_straggler_k x the cross-rank median for FLAGS_straggler_m
    consecutive steps is flagged, with a `straggler` event to the event
    log and the registry, and in the flight recorder's cluster snapshot,
    so a later crash dump says which rank was dragging and since when.

The store is the transport: one small JSON value a rank and step, deleted
once aggregated; a silent rank turns into a `cluster_timeout` event after
`timeout_s`, not a hang.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from . import flight_recorder, telemetry
from .registry import counter, gauge
from ..core.flags import define_flag, get_flag

define_flag(
    "straggler_k", 2.0,
    "Cluster straggler threshold: a rank is straggling when its compute or "
    "reduce phase exceeds k x the cross-rank median of that phase.")
define_flag(
    "straggler_m", 3,
    "Cluster straggler persistence: consecutive over-threshold steps before "
    "a rank is flagged (debounces one-off scheduler hiccups).")

# the per-rank fields worth shipping cross-host (keep the value tiny: it
# crosses the store once per rank per step)
_SLIM_FIELDS = ("step", "loss", "grad_norm", "step_wall_s",
                "samples_per_s", "tokens_per_s", "skipped")
_STATS = ("min", "median", "max", "p95")
_STRAGGLER_PHASES = ("compute", "reduce")

_PHASE_G = gauge("cluster_phase_seconds",
                 "Cross-rank per-step phase time distribution.",
                 labelnames=("phase", "stat"))
_LOSS_G = gauge("cluster_loss", "Cross-rank loss distribution of the last "
                "aggregated step.", labelnames=("stat",))
_TPS_G = gauge("cluster_tokens_per_second_total",
               "Summed tokens/s across all ranks (last aggregated step).")
_SPS_G = gauge("cluster_samples_per_second_total",
               "Summed samples/s across all ranks (last aggregated step).")
_WALL_G = gauge("cluster_step_wall_seconds",
                "Cross-rank step wall-time distribution.",
                labelnames=("stat",))
_STRAGGLERS = counter("cluster_straggler_events_total",
                      "Straggler flag events by rank and phase.",
                      labelnames=("rank", "phase"))
_AGG_STEPS = counter("cluster_aggregated_steps_total",
                     "Steps rank 0 fully aggregated across ranks.")


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile over a sorted list."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


def _dist(vals: Sequence[float]) -> Dict[str, float]:
    s = sorted(float(v) for v in vals)
    return {
        "min": s[0] if s else 0.0,
        "median": _percentile(s, 0.5),
        "max": s[-1] if s else 0.0,
        "p95": _percentile(s, 0.95),
    }


class ClusterTelemetry:
    """Per-rank publisher + (on rank 0) cross-rank aggregator.

    Args:
        store: TCPStore-compatible object (set/get/delete). Blocking `get`
            must accept the key's eventual arrival; InProcStore and the
            native TCPStore both qualify.
        rank / world_size: this process's coordinates.
        k / m: straggler threshold and persistence; None reads the
            FLAGS_straggler_k / FLAGS_straggler_m knobs.
        timeout_s: per-rank record wait during aggregation — a rank silent
            for this long turns into a `cluster_timeout` event, not a hang.
    """

    def __init__(self, store, rank: int, world_size: int, *,
                 k: Optional[float] = None, m: Optional[int] = None,
                 prefix: str = "/pt/cluster", timeout_s: float = 60.0,
                 phases: Sequence[str] = telemetry.PHASES):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.k = float(get_flag("straggler_k") if k is None else k)
        self.m = max(int(get_flag("straggler_m") if m is None else m), 1)
        self.prefix = prefix.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.phases = tuple(phases)
        self._lock = threading.Lock()
        # rank -> phase -> consecutive over-threshold steps
        self._streaks: Dict[int, Dict[str, int]] = {}
        self._flagged: Dict[int, Dict[str, int]] = {}  # rank->phase->step
        self.straggler_events: List[Dict[str, Any]] = []
        self.aggregates: List[Dict[str, Any]] = []  # bounded below
        self._max_kept = 64

    # -- publishing (every rank) -------------------------------------------
    def _key(self, step: int, rank: int) -> str:
        return f"{self.prefix}/{int(step)}/{int(rank)}"

    def slim(self, record: Dict[str, Any]) -> Dict[str, Any]:
        out = {f: record[f] for f in _SLIM_FIELDS if record.get(f) is not None}
        out["rank"] = self.rank
        out["phases"] = {p: float(record.get("phases", {}).get(p, 0.0))
                         for p in self.phases}
        return out

    def publish(self, record: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Publish this rank's record for its step; on rank 0 additionally
        collect all ranks and aggregate. Returns the aggregate (rank 0)."""
        step = int(record["step"])
        self.store.set(self._key(step, self.rank),
                       json.dumps(self.slim(record)))
        if self.rank == 0:
            return self.aggregate(step)
        return None

    # -- aggregation (rank 0) ----------------------------------------------
    def _collect(self, step: int) -> List[Dict[str, Any]]:
        recs = []
        for r in range(self.world_size):
            key = self._key(step, r)
            try:
                raw = self.store.get(key, timeout_s=self.timeout_s)
            except Exception as e:  # timeout / dead rank: event, not a hang
                telemetry.get_telemetry().event(
                    "cluster_timeout", step=step, rank=r,
                    error=f"{type(e).__name__}: {e}")
                continue
            if raw is None:
                continue
            try:
                recs.append(json.loads(raw))
            except (ValueError, TypeError):
                continue
            # aggregated: the store should not accumulate history
            try:
                self.store.delete(key)
            except Exception:  # noqa: BLE001 — GC is best-effort
                pass
        return recs

    def aggregate(self, step: int) -> Optional[Dict[str, Any]]:
        recs = self._collect(step)
        if not recs:
            return None
        agg: Dict[str, Any] = {"kind": "cluster_step", "ts": time.time(),
                               "step": int(step), "ranks": len(recs),
                               "phases": {}}
        for p in self.phases:
            vals = [r["phases"].get(p, 0.0) for r in recs]
            d = _dist(vals)
            agg["phases"][p] = {k: round(v, 6) for k, v in d.items()}
            for stat in _STATS:
                _PHASE_G.set(d[stat], phase=p, stat=stat)
        losses = [r["loss"] for r in recs if r.get("loss") is not None]
        if losses:
            d = _dist(losses)
            agg["loss"] = {k: round(v, 6) for k, v in d.items()}
            for stat in _STATS:
                _LOSS_G.set(d[stat], stat=stat)
        walls = [r["step_wall_s"] for r in recs
                 if r.get("step_wall_s") is not None]
        if walls:
            d = _dist(walls)
            agg["step_wall_s"] = {k: round(v, 6) for k, v in d.items()}
            for stat in _STATS:
                _WALL_G.set(d[stat], stat=stat)
        tps = sum(r.get("tokens_per_s") or 0.0 for r in recs)
        sps = sum(r.get("samples_per_s") or 0.0 for r in recs)
        if tps:
            agg["tokens_per_s_total"] = round(tps, 3)
            _TPS_G.set(tps)
        if sps:
            agg["samples_per_s_total"] = round(sps, 3)
            _SPS_G.set(sps)
        agg["stragglers"] = self._detect_stragglers(step, recs)
        _AGG_STEPS.inc()
        telemetry.get_telemetry().event(
            "cluster_step", **{k: v for k, v in agg.items()
                               if k not in ("kind", "ts")})
        with self._lock:
            self.aggregates.append(agg)
            del self.aggregates[:-self._max_kept]
        flight_recorder.set_cluster_snapshot(self.snapshot())
        return agg

    def _detect_stragglers(self, step: int,
                           recs: List[Dict[str, Any]]) -> List[Dict]:
        flagged = []
        for p in _STRAGGLER_PHASES:
            if p not in self.phases:
                continue
            vals = {int(r["rank"]): float(r["phases"].get(p, 0.0))
                    for r in recs}
            med = _percentile(sorted(vals.values()), 0.5)
            if med <= 0.0:
                continue  # phase not measured this step (e.g. overlapped
                # reduce is honestly 0.0) — no meaningful ratio exists
            for rank, v in vals.items():
                streaks = self._streaks.setdefault(rank, {})
                if v > self.k * med:
                    streaks[p] = streaks.get(p, 0) + 1
                else:
                    streaks[p] = 0
                    continue
                if streaks[p] >= self.m:
                    ev = {
                        "rank": rank, "phase": p, "step": int(step),
                        "value_s": round(v, 6), "median_s": round(med, 6),
                        "ratio": round(v / med, 3), "streak": streaks[p],
                        "k": self.k, "m": self.m,
                    }
                    flagged.append(ev)
                    first = streaks[p] == self.m  # rising edge
                    self._flagged.setdefault(rank, {})[p] = int(step)
                    if first:
                        self.straggler_events.append(
                            dict(ev, ts=time.time()))
                        del self.straggler_events[:-self._max_kept]
                        _STRAGGLERS.inc(rank=str(rank), phase=p)
                        telemetry.get_telemetry().event("straggler", **ev)
        return flagged

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Current cluster view — embedded into flight-recorder dumps."""
        with self._lock:
            last = self.aggregates[-1] if self.aggregates else None
            return {
                "world_size": self.world_size,
                "k": self.k, "m": self.m,
                "last_aggregate": last,
                "active_streaks": {
                    str(r): {p: s for p, s in ph.items() if s}
                    for r, ph in self._streaks.items()
                    if any(ph.values())},
                "flagged": {str(r): dict(ph)
                            for r, ph in self._flagged.items()},
                "straggler_events": list(self.straggler_events[-8:]),
            }


def from_env(**kwargs) -> ClusterTelemetry:
    """ClusterTelemetry over the process-group store and this process's
    rank/world (distributed/env.py)."""
    from ..distributed import env as _env

    world = _env.get_world_size()
    return ClusterTelemetry(_env.get_store(world), _env.get_rank(), world,
                            **kwargs)
