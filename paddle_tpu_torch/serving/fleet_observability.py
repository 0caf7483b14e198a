"""Fleet-wide tracing and attempt-attributed SLOs (counterpart of
paddle_tpu/serving/fleet_observability.py), the router's half of the
fleet's observability:

  * trace context: the router stamps every engine placement with
    ``{fleet_request_id, attempt, cause}`` (``ServingEngine.submit(
    trace_ctx=...)``), and each replica's ``RequestTrace`` bakes it into
    its spans;
  * router spans: route decisions (with the per-replica ``peek_match``
    probes behind them), the queue at the router between an orphan's
    detection and its re-placement, breaker transitions, hedge fire, win
    and cancel, KV transfers, migrations and scale events, in the spans
    ring and the fleet request's own ``RequestTrace``;
  * the merged trace: ``export_fleet_trace`` writes router spans and every
    attempt's per-replica trace as one chrome trace (pid 0 the router, pid
    i + 1 replica i, tid the decode slot), losing arms marked
    ``cancelled``;
  * attempt-attributed SLOs: always-on histograms labelled ``{tier,
    replica, cause}`` (``fleet_attempt_{route,queue,ttft,e2e}_seconds``),
    ``fleet_wasted_decode_tokens_total``, and fleet p50/p95/p99 rollups as
    ``fleet_slo_seconds{metric,quantile}`` gauges;
  * fleet anomaly detectors (hedge-rate spike, re-dispatch storm, breaker
    flap, replica p95-TTFT skew; observability/anomaly.py) fed one record
    per router poll; a detection dumps a flight record with the router's
    state and the recent requests' merged traces.

The ``on_*`` hooks run from the router's paths; HTTP readers come through
``trace_payload`` and ``router_state``, which take snapshot locks only.
Span timestamps are real ``monotonic_ns`` whatever the router's clock (a
fake clock's tests assert tags and counts, never durations).
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..core.flags import define_flag, get_flag
from ..observability import anomaly as _anomaly
from ..observability import flight_recorder as _flight
from ..observability import spans as _spans
from ..observability.registry import (
    counter as _counter,
    gauge as _gauge,
    histogram as _histogram,
    metrics_enabled,
)
from .observability import chrome_trace_events

define_flag("fleet_flight_requests", 64,
            "Fleet flight-recorder arm: how many settled fleet-request "
            "records (attempt summaries + merged cross-replica traces) "
            "ride along in a fleet anomaly dump, and how far back "
            "GET /trace?id= can answer for finished requests.")
define_flag("fleet_anomaly", "auto",
            "Fleet anomaly detectors (hedge-rate spike, re-dispatch "
            "storm, breaker flap, replica p95-TTFT skew) over per-poll "
            "router records: 'auto' follows FLAGS_anomaly, 'on'/'off' "
            "override it. Needs FLAGS_metrics=on either way.")
define_flag("fleet_detector_window", 16,
            "Rolling window, in router polls, for the fleet anomaly "
            "detectors — breaker transitions are counted per replica "
            "inside this window, and the rate fields feed detectors "
            "bounded by this history.")

_TRUE = ("1", "on", "true", "yes")

# ------------------------------------------------------------- metrics
# Attempt-attributed SLOs: always-on like every fleet_* metric, labeled
# by {tier, replica, cause} so a p95 regression can be blamed on the
# replica AND on why the attempt existed (a slow hedge arm is a very
# different pathology from a slow primary).
_ATT_ROUTE = _histogram("fleet_attempt_route_seconds",
                        "Routing-decision entry to engine arrival, per "
                        "attempt (includes the peek_match probes).",
                        labelnames=("tier", "replica", "cause"),
                        always=True)
_ATT_QUEUE = _histogram("fleet_attempt_queue_seconds",
                        "Engine arrival to prefill start, per attempt.",
                        labelnames=("tier", "replica", "cause"),
                        always=True)
_ATT_TTFT = _histogram("fleet_attempt_ttft_seconds",
                       "Engine arrival to first token, per attempt.",
                       labelnames=("tier", "replica", "cause"),
                       always=True)
_ATT_E2E = _histogram("fleet_attempt_e2e_seconds",
                      "Engine arrival to finish for the WINNING attempt.",
                      labelnames=("tier", "replica", "cause"),
                      always=True)
_WASTED = _counter("fleet_wasted_decode_tokens_total",
                   "Decode tokens thrown away by cancelled attempts "
                   "(losing hedge arms, dead-replica orphans), by "
                   "replica and cancellation cause.",
                   labelnames=("replica", "cause"), always=True)
_SLO_ROLLUP = _gauge("fleet_slo_seconds",
                     "Fleet-level latency rollups: quantiles over the "
                     "merge of every {tier,replica,cause} row of the "
                     "fleet_attempt_*_seconds histograms.",
                     labelnames=("metric", "quantile"), always=True)
_KV_BLOCKS = _counter("fleet_kv_streamed_blocks_total",
                      "KV blocks on the chain-hash transfer wire "
                      "(disaggregated prefill->decode streaming and live "
                      "migration), by ingest outcome: imported (fresh), "
                      "dedup (already resident), rejected (chain-hash "
                      "mismatch), skipped (pool full / after a break).",
                      labelnames=("result",), always=True)
_KV_BYTES = _counter("fleet_kv_streamed_bytes_total",
                     "Raw KV page bytes admitted over the transfer wire "
                     "(fresh imports only — dedups move nothing).",
                     always=True)
_MIGRATIONS = _counter("fleet_migrations_total",
                       "In-flight sessions live-migrated off a draining "
                       "replica onto a survivor.", always=True)
_SCALE_EVENTS = _counter("fleet_scale_events_total",
                         "Elastic fleet membership changes, by "
                         "direction (up = replica joined, down = replica "
                         "retired).", labelnames=("direction",),
                         always=True)

_ROLLUP_SOURCES = (("route", _ATT_ROUTE), ("queue", _ATT_QUEUE),
                   ("ttft", _ATT_TTFT), ("e2e", _ATT_E2E))


def fleet_anomaly_on() -> bool:
    """Fleet detectors run when FLAGS_metrics=on and FLAGS_fleet_anomaly
    says so ('auto' defers to FLAGS_anomaly)."""
    if not metrics_enabled():
        return False
    mode = str(get_flag("fleet_anomaly")).lower()
    if mode in _TRUE:
        return True
    if mode == "auto":
        return str(get_flag("anomaly")).lower() in _TRUE
    return False


def trace_context(fleet_request_id: str, attempt: int,
                  cause: str) -> Dict[str, Any]:
    """The context dict stamped onto every engine placement."""
    return {"fleet_request_id": str(fleet_request_id),
            "attempt": int(attempt), "cause": str(cause)}


class FleetObservability:
    """Router-side observability hub: the FleetRouter calls the ``on_*``
    hooks from its routing/supervision paths; ``tick`` runs once per
    poll and feeds the fleet anomaly detectors."""

    #: per-replica TTFT samples kept for the skew signal
    TTFT_WINDOW = 64
    #: replicas need this many samples before their p95 enters the skew
    SKEW_MIN_SAMPLES = 5

    def __init__(self, router, *, dump: bool = True,
                 dump_cooldown_ticks: int = 50):
        self.router = router
        self.dump = bool(dump)
        self.dump_cooldown_ticks = int(dump_cooldown_ticks)
        self.window = max(int(get_flag("fleet_detector_window")), 1)
        n = max(int(get_flag("fleet_flight_requests")), 1)
        self._lock = threading.Lock()
        self._settled: deque = deque(maxlen=n)   # finished fleet records
        self._breaker_log: deque = deque(maxlen=256)
        self._scale_log: deque = deque(maxlen=256)   # membership changes
        self._ttft: Dict[str, deque] = {}        # rid -> recent TTFTs
        self._tick_n = 0
        self._win_dispatch = 0    # placements since the last tick
        self._win_hedge = 0
        self._win_redispatch = 0
        self._anomaly: Optional[_anomaly.AnomalyEngine] = None
        self._dump_armed_at = -1
        self.dumps: List[str] = []

    # -- dispatch / hedge / breaker hooks (router lock held) ---------------
    def on_dispatch(self, freq, att, probes: List[Dict[str, Any]],
                    t0_ns: int) -> None:
        """One successful engine placement: the route-decision span
        (probe results included) plus, for a re-dispatch, the
        queue-at-router span covering orphan-detection -> re-placement."""
        with self._lock:
            self._win_dispatch += 1
            if att.kind == "redispatch":
                self._win_redispatch += 1
            elif att.kind == "hedge":
                self._win_hedge += 1
        tr = freq.trace
        if tr is None:
            return
        now = time.monotonic_ns()
        if att.kind == "redispatch" and freq._orphan_ns is not None:
            tr.add("fleet.queue", freq._orphan_ns, t0_ns,
                   attempt=att.index, cause=att.kind,
                   fleet_request_id=freq.request_id)
        tr.add("fleet.route", t0_ns, now, attempt=att.index,
               cause=att.kind, chosen=att.replica.rid, probes=probes,
               fleet_request_id=freq.request_id)
        if att.kind == "hedge":
            tr.add("fleet.hedge_fire", now, now, attempt=att.index,
                   hedge_replica=att.replica.rid,
                   fleet_request_id=freq.request_id)

    def on_hedge_win(self, freq, winner) -> None:
        tr = freq.trace
        if tr is not None:
            now = time.monotonic_ns()
            tr.add("fleet.hedge_win", now, now, attempt=winner.index,
                   cause=winner.kind, winner=winner.replica.rid,
                   fleet_request_id=freq.request_id)

    def on_cancelled(self, freq, att, tokens: int, reason: str) -> None:
        """An attempt's partial output was thrown away (losing hedge arm
        or dead-replica orphan): wasted-work accounting + the cancel
        marker span."""
        if tokens > 0:
            _WASTED.inc(int(tokens), replica=att.replica.rid,
                        cause=str(reason))
        tr = freq.trace
        if tr is not None:
            now = time.monotonic_ns()
            tr.add("fleet.hedge_cancel" if reason == "hedge_lost"
                   else "fleet.cancel", now, now, attempt=att.index,
                   cause=att.kind, replica=att.replica.rid,
                   reason=str(reason), wasted_tokens=int(tokens),
                   fleet_request_id=freq.request_id)

    # -- disaggregation / migration / scaling hooks ------------------------
    def on_kv_transfer(self, freq, src: str, dst: str, stats: dict,
                       kind: str = "prefill") -> None:
        """One KV-block transfer over the chain-hash wire (prefill
        streaming or migration): counters by outcome plus a router-lane
        span carrying the full stats."""
        for key in ("imported", "dedup", "rejected", "skipped"):
            n = int(stats.get(key, 0))
            if n:
                _KV_BLOCKS.inc(n, result=key)
        nbytes = int(stats.get("bytes", 0))
        if nbytes:
            _KV_BYTES.inc(nbytes)
        tr = freq.trace
        if tr is not None:
            now = time.monotonic_ns()
            tr.add("fleet.kv_transfer", now, now, src=src, dst=dst,
                   kind=str(kind),
                   **{k: int(stats.get(k, 0)) for k in
                      ("imported", "dedup", "rejected", "skipped",
                       "bytes")},
                   fleet_request_id=freq.request_id)

    def on_migrate(self, freq, src: str, dst: str,
                   stats: Optional[dict]) -> None:
        _MIGRATIONS.inc()
        tr = freq.trace
        if tr is not None:
            now = time.monotonic_ns()
            tr.add("fleet.migrate", now, now, src=src, dst=dst,
                   streamed_blocks=int((stats or {}).get("imported", 0)
                                       + (stats or {}).get("dedup", 0)),
                   fleet_request_id=freq.request_id)

    def on_scale(self, direction: str, rid: str, *, role: str = "any",
                 replicas: int = 0) -> None:
        """Elastic membership change: counter + the scale log merged
        into cross-replica traces as router-lane instants (the breaker
        pattern), + a global span so scrapes and dumps see it."""
        _SCALE_EVENTS.inc(direction=str(direction))
        now_ns = time.monotonic_ns()
        with self._lock:
            self._scale_log.append({
                "ts_ns": now_ns, "ts": time.time(), "tick": self._tick_n,
                "direction": str(direction), "replica": str(rid),
                "role": str(role), "replicas": int(replicas)})
        if _spans.enabled():
            _spans.record_span("fleet.scale", now_ns, now_ns, cat="fleet",
                               args={"direction": str(direction),
                                     "replica": str(rid),
                                     "role": str(role),
                                     "replicas": int(replicas)})

    def scale_log(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{k: v for k, v in ev.items() if k != "ts_ns"}
                    for ev in self._scale_log]

    def on_breaker(self, rid: str, old: Optional[str], new: str) -> None:
        """Breaker state transition (detected at the router's record
        sites and once per poll for time-driven open -> half_open)."""
        now_ns = time.monotonic_ns()
        with self._lock:
            self._breaker_log.append({
                "ts_ns": now_ns, "ts": time.time(), "tick": self._tick_n,
                "replica": rid, "from": old, "to": new})
        if _spans.enabled():
            _spans.record_span("fleet.breaker", now_ns, now_ns,
                               cat="fleet", args={"replica": rid,
                                                  "from": old, "to": new})

    # -- settle -----------------------------------------------------------
    def on_settle(self, freq, winner) -> None:
        """A fleet request finished: attempt-attributed SLO observes for
        every attempt, per-replica TTFT windows for the skew signal, and
        the bounded settled-record ring (merged trace included) that
        backs GET /trace?id= and the fleet flight dumps."""
        with freq._lock:
            atts = list(freq.attempts)
        for att in atts:
            r = att.req
            labels = {"tier": freq.tier, "replica": att.replica.rid,
                      "cause": att.kind}
            if att.route_t0 is not None:
                _ATT_ROUTE.observe(max(0.0, r.arrival_time - att.route_t0),
                                   **labels)
            q = r.queue_seconds()
            if q is not None:
                _ATT_QUEUE.observe(max(0.0, q), **labels)
            t = r.ttft_seconds()
            if t is not None:
                _ATT_TTFT.observe(max(0.0, t), **labels)
                with self._lock:
                    w = self._ttft.get(att.replica.rid)
                    if w is None:
                        w = self._ttft[att.replica.rid] = deque(
                            maxlen=self.TTFT_WINDOW)
                    w.append(float(t))
            if att is winner and r.finish_time is not None:
                _ATT_E2E.observe(max(0.0, r.finish_time - r.arrival_time),
                                 **labels)
        rec: Dict[str, Any] = {
            "kind": "fleet_request", "request_id": freq.request_id,
            "tier": freq.tier, "ts": time.time(),
            "finish_reason": freq.finish_reason,
            "redispatches": freq.redispatches, "hedged": freq.hedged,
            "output_tokens": len(freq.output_tokens),
            "attempts": [dict(att.req.telemetry(), replica=att.replica.rid,
                              cause=att.kind, attempt=att.index,
                              cancelled=att.failed) for att in atts],
        }
        if freq.trace is not None:
            # Keep the freq reference; the merged trace is assembled
            # lazily on first access (GET /trace or a flight dump) so the
            # settle path stays off the serving hot loop.
            rec["_freq"] = freq
        with self._lock:
            self._settled.append(rec)

    # -- per-poll tick -----------------------------------------------------
    def tick(self) -> List[Dict[str, Any]]:
        """One fleet supervision record per router poll: windowed
        hedge/re-dispatch rates, per-replica breaker flap counts, and
        the cross-replica p95-TTFT skew, fed through the fleet anomaly
        detectors (flight dump on detection)."""
        with self._lock:
            self._tick_n += 1
            n = self._tick_n
            dispatches = self._win_dispatch
            hedges = self._win_hedge
            redis = self._win_redispatch
            self._win_dispatch = self._win_hedge = self._win_redispatch = 0
            lo = n - self.window
            flaps: Dict[str, int] = {}
            for ev in self._breaker_log:
                if ev["tick"] >= lo:
                    flaps[ev["replica"]] = flaps.get(ev["replica"], 0) + 1
        rec: Dict[str, Any] = {
            "kind": "fleet_tick", "step": n, "ts": time.time(),
            "inflight": self.router.inflight(),
            "dispatches": dispatches,
            "hedge_rate": hedges / max(1, dispatches),
            "redispatch_rate": redis / max(1, dispatches),
            "breaker_flaps": float(max(flaps.values()) if flaps else 0),
        }
        skew = self._ttft_skew()
        if skew is not None:
            rec["ttft_skew"] = skew
        if n % 8 == 1 and metrics_enabled():
            self.publish_rollups()
        return self.observe_record(rec)

    def observe_record(self, rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Feed one fleet record through the detectors; dump on
        detection. Public seam — tests and obsbench inject synthetic
        records through the same path tick() uses."""
        engine = self._anomaly_engine()
        if engine is None:
            return []
        events = engine.observe(rec)
        if events and self.dump:
            self._maybe_dump(events)
        return events

    def _anomaly_engine(self) -> Optional[_anomaly.AnomalyEngine]:
        if self._anomaly is None and fleet_anomaly_on():
            self._anomaly = _anomaly.AnomalyEngine(
                _anomaly.fleet_default_detectors(window=self.window),
                dump=False)
        return self._anomaly

    def anomalies_recent(self, n: int = 16) -> List[Dict[str, Any]]:
        return [] if self._anomaly is None else self._anomaly.recent(n)

    def _ttft_skew(self) -> Optional[float]:
        with self._lock:
            windows = {rid: list(w) for rid, w in self._ttft.items()}
        p95s = []
        for w in windows.values():
            if len(w) < self.SKEW_MIN_SAMPLES:
                continue
            s = sorted(w)
            p95s.append(s[min(len(s) - 1, int(0.95 * len(s)))])
        if len(p95s) < 2:
            return None
        mx, mn = max(p95s), min(p95s)
        if mn <= 0:
            return None
        return mx / mn

    def _maybe_dump(self, events: List[Dict[str, Any]]) -> None:
        if self._tick_n <= self._dump_armed_at:
            return
        self._dump_armed_at = self._tick_n + self.dump_cooldown_ticks
        with self._lock:
            settled = list(self._settled)
            transitions = list(self._breaker_log)
        requests = []
        for rec in settled:
            out = {k: v for k, v in rec.items() if k != "_freq"}
            trace = self._materialize_trace(rec)
            if trace is not None:
                out["trace"] = trace
            requests.append(out)
        extra = {
            "anomaly": events[0],
            "fleet_anomalies": events,
            "router": self.router_state(),
            "fleet_requests": requests,
            "breaker_transitions": [
                {k: v for k, v in t.items() if k != "ts_ns"}
                for t in transitions],
        }
        try:
            path = _flight.get_flight_recorder().dump(
                f"fleet_{events[0]['kind']}", extra=extra)
            self.dumps.append(path)
        except OSError:
            pass

    # -- router state (flight dumps + debugging) ---------------------------
    def router_state(self) -> Dict[str, Any]:
        """Breaker states, registry leases, per-replica loads — the
        'why was the router doing that' context a flight dump embeds."""
        r = self.router
        reps: Dict[str, Any] = {}
        for rid, rep in r.replicas.items():
            age = r.registry.heartbeat_age(rid)
            reps[rid] = {
                "breaker": rep.breaker.state,
                "draining": bool(rep.draining),
                "dead": r.replica_dead(rep),
                "load": rep.load(),
                "queue_depth": rep.queue_depth(),
                "lease_age_s": (round(age, 4) if math.isfinite(age)
                                else None),
            }
        return {"inflight": r.inflight(), "replicas": reps}

    def publish_rollups(self) -> Dict[str, Dict[str, float]]:
        """Fleet-level p50/p95/p99 rollups across every label row of the
        attempt histograms, published as fleet_slo_seconds gauges (the
        FleetServer refreshes them on every /metrics scrape)."""
        out: Dict[str, Dict[str, float]] = {}
        for metric, h in _ROLLUP_SOURCES:
            qs = h.rollup_quantiles()
            clean = {k: v for k, v in qs.items()
                     if v is not None and not math.isnan(v)}
            if clean:
                out[metric] = clean
                for qname, v in clean.items():
                    _SLO_ROLLUP.set(v, metric=metric, quantile=qname)
        return out

    # -- cross-replica trace merge ----------------------------------------
    def merged_trace_events(self, freq) -> List[Dict[str, Any]]:
        """Router spans + every attempt's per-replica RequestTrace as one
        chrome-trace event list: pid 0 = router, pid i+1 = replica-i
        lane, tid = decode slot; cancelled arms (hedge losers, orphans)
        are tagged ``cancelled`` on every span. A synthetic
        ``fleet.attempt`` umbrella span per attempt (engine arrival ->
        finish/cancel) keeps the waterfall contiguous across the engine
        tick gaps."""
        with freq._lock:
            atts = list(freq.attempts)
        rids = list(self.router.replicas.keys())
        events: List[Dict[str, Any]] = []
        procs: Dict[int, str] = {0: "router"}
        if freq.trace is not None:
            events += chrome_trace_events(
                list(freq.trace.spans), pid=0, tid=0,
                extra_args={"fleet_request_id": freq.request_id})
        for att in atts:
            rid = att.replica.rid
            pid = rids.index(rid) + 1 if rid in rids else len(rids) + 1
            procs[pid] = rid
            tr = att.req.trace
            extra = {"fleet_request_id": freq.request_id,
                     "attempt": att.index, "cause": att.kind}
            if att.failed:
                extra["cancelled"] = True
            tid = tr.slot if (tr is not None and tr.slot is not None) else 0
            if tr is not None:
                events += chrome_trace_events(list(tr.spans), pid=pid,
                                              tid=tid, extra_args=extra)
            r = att.req
            b_ns = int(r.arrival_time * 1e9)
            end = (r.finish_time if r.finish_time is not None
                   else time.monotonic())
            e_ns = int(end * 1e9)
            if tr is not None and tr.spans:
                # the engine's finish/cancel hook can run a beat after
                # finish_time (end of the tick): keep the umbrella over
                # every span the attempt actually recorded
                e_ns = max(e_ns, max(s["end_ns"] for s in tr.spans))
                b_ns = min(b_ns, min(s["begin_ns"] for s in tr.spans))
            events.append({
                "name": "fleet.attempt", "ph": "X", "cat": "fleet",
                "ts": b_ns / 1e3, "dur": max(e_ns - b_ns, 0) / 1e3,
                "pid": pid, "tid": tid,
                "args": dict(extra, request_id=freq.request_id,
                             replica=rid, state=r.state,
                             finish_reason=r.finish_reason)})
        # breaker transitions on replicas this request touched, inside
        # its own time window, land on the router lane as instants
        if events:
            lo = min(e["ts"] for e in events)
            hi = max(e["ts"] + e["dur"] for e in events)
            att_rids = {a.replica.rid for a in atts}
            with self._lock:
                translog = list(self._breaker_log)
                scalelog = list(self._scale_log)
            for ev in translog:
                ts = ev["ts_ns"] / 1e3
                if ev["replica"] in att_rids and lo <= ts <= hi:
                    events.append({
                        "name": "fleet.breaker", "ph": "X", "cat": "fleet",
                        "ts": ts, "dur": 0.0, "pid": 0, "tid": 0,
                        "args": {"fleet_request_id": freq.request_id,
                                 "replica": ev["replica"],
                                 "from": ev["from"], "to": ev["to"]}})
            # scale events are fleet-wide: any membership change inside
            # this request's window lands on its router lane
            for ev in scalelog:
                ts = ev["ts_ns"] / 1e3
                if lo <= ts <= hi:
                    events.append({
                        "name": "fleet.scale", "ph": "X", "cat": "fleet",
                        "ts": ts, "dur": 0.0, "pid": 0, "tid": 0,
                        "args": {"fleet_request_id": freq.request_id,
                                 "direction": ev["direction"],
                                 "replica": ev["replica"],
                                 "replicas": ev["replicas"]}})
        for pid in sorted(procs):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": procs[pid]}})
        return events

    def trace_payload(self, request_id: str) -> Optional[Dict[str, Any]]:
        """The merged chrome trace for one fleet request id — assembled
        live for in-flight requests, served from the settled ring for
        finished ones. None when unknown (or the request was never
        traced)."""
        rid = str(request_id)
        freq = None
        with self.router._lock:
            freq = self.router._inflight.get(rid)
        if freq is not None and freq.trace is not None:
            return {"traceEvents": self.merged_trace_events(freq),
                    "displayTimeUnit": "ms"}
        with self._lock:
            target = None
            for rec in reversed(self._settled):
                if rec["request_id"] == rid:
                    target = rec
                    break
        if target is not None:
            trace = self._materialize_trace(target)
            if trace is not None:
                return {"traceEvents": trace, "displayTimeUnit": "ms"}
        return None

    def _materialize_trace(
            self, rec: Dict[str, Any]) -> Optional[List[Dict[str, Any]]]:
        """Assemble (and cache) a settled record's merged trace from the
        retained freq reference. None when the request was never traced."""
        trace = rec.get("trace")
        if trace is None and rec.get("_freq") is not None:
            trace = self.merged_trace_events(rec["_freq"])
            with self._lock:
                rec["trace"] = trace
        return trace


def export_fleet_trace(router, request_id: str, path: str) -> str:
    """Write one fleet request's merged cross-replica chrome trace
    (chrome://tracing / Perfetto). Raises ValueError when the request is
    unknown or was never traced (FLAGS_metrics off at submit)."""
    import json

    payload = router.obs.trace_payload(request_id)
    if payload is None:
        raise ValueError(
            f"fleet request {request_id!r} has no merged trace (unknown id, "
            "evicted from the settled ring, or FLAGS_metrics was off at "
            "submit)")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    return path


def coverage_of(events: List[Dict[str, Any]]) -> float:
    """Fraction of a merged trace's wall window (first span begin ->
    last span end) covered by the union of its span intervals — the
    obsbench completeness gate ('no invisible time')."""
    ivals = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X")
    if not ivals:
        return 0.0
    lo = ivals[0][0]
    hi = max(e for _, e in ivals)
    if hi <= lo:
        return 1.0
    covered = 0.0
    cur_lo, cur_hi = ivals[0]
    for b, e in ivals[1:]:
        if b > cur_hi:
            covered += cur_hi - cur_lo
            cur_lo, cur_hi = b, e
        else:
            cur_hi = max(cur_hi, e)
    covered += cur_hi - cur_lo
    return covered / (hi - lo)


def unparented_spans(events: List[Dict[str, Any]],
                     request_id: str) -> List[Dict[str, Any]]:
    """Spans in a merged trace that lost their attribution: every real
    span must name the fleet request it belongs to, and every
    replica-lane span must carry attempt/cause tags."""
    bad = []
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        owner = args.get("fleet_request_id", args.get("request_id"))
        if owner != request_id:
            bad.append(e)
        elif e.get("pid", 0) != 0 and ("attempt" not in args
                                       or "cause" not in args):
            bad.append(e)
    return bad
