"""Serving observability: request traces, SLO metrics, tick gauges and the
serving flight-recorder arm (counterpart of
paddle_tpu/serving/observability.py).

  * RequestTrace: per-request lifecycle spans (queue wait, admission, each
    prefill chunk, decode ticks, speculative verify, rollback, finish),
    recorded through the process-wide span ring (observability/spans.py);
    export_request_trace writes one request's spans as a chrome trace.
  * SLO metrics on the shared registry, labelled by admission tier: TTFT,
    TPOT, queue and end-to-end latency histograms; goodput token and shed
    request counters. All always=True like every serving_* metric.
  * Tick gauges sampled every TICK_SAMPLE ticks (FLAGS_metrics-gated):
    slot occupancy, batch size, rolling prefix-cache hit rate,
    speculative acceptance, windowed goodput.
  * The serving flight arm: bounded rings of finished request records and
    tick snapshots, dumped through flight_recorder.dump when a serving
    anomaly detector fires (TTFT regression, goodput collapse, cache-hit
    collapse, KV conservation breach).

Hooks run under the engine's lock; the HTTP handlers read through the
snapshot methods, which take it themselves. EngineStats, the per-engine
event counters behind the engine's stats(), live here too.
"""
from __future__ import annotations

import itertools
import json
import os
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

define_flag("serving_metrics_port", 0,
            "Also serve the process-wide GET /metrics (Prometheus text) + "
            "/healthz on this dedicated port from the serving process "
            "(observability/serve.py machinery); 0 disables. The "
            "ServingServer's own port always answers GET /metrics and "
            "/healthz regardless.")
define_flag("serving_flight_requests", 64,
            "Serving flight-recorder arm: how many finished request "
            "records (telemetry + trace) and engine tick snapshots ride "
            "along in an anomaly dump.")
define_flag("serving_anomaly", "auto",
            "Serving anomaly detectors (TTFT regression, goodput collapse, "
            "cache-hit collapse, KV conservation breach) over per-tick "
            "records: 'auto' follows FLAGS_anomaly, 'on'/'off' override it. "
            "Needs FLAGS_metrics=on either way.")

_TRUE = ("1", "on", "true", "yes")

#: healthz: engine has work but no tick for this long => status "stale"
STALE_AFTER_S = 60.0
#: healthz: anomalies within this window => status "anomalous"
ANOMALY_RECENT_S = 300.0

# ---------------------------------------------------------------- metrics
# SLO histograms and counters are labelled by admission tier and always=True
# like every other serving_* metric: stats() and /stats read them whatever
# FLAGS_metrics says.
_TTFT_H = _histogram("serving_ttft_seconds",
                     "Arrival -> first token, per request.",
                     labelnames=("tier",), always=True)
_QUEUE_H = _histogram("serving_queue_seconds",
                      "Arrival -> prefill start, per request.",
                      labelnames=("tier",), always=True)
_TPOT_H = _histogram("serving_tpot_seconds",
                     "Mean inter-token latency (time per output token "
                     "after the first), per request.",
                     labelnames=("tier",), always=True)
_E2E_H = _histogram("serving_e2e_seconds",
                    "Arrival -> finish, per request.",
                    labelnames=("tier",), always=True)
_TOKRATE_H = _histogram("serving_decode_tokens_per_s",
                        "Per-request steady-state decode rate.",
                        labelnames=("tier",), always=True)
_GEN_TOKENS = _counter("serving_generated_tokens_total",
                       "Tokens generated across all requests.", always=True)
PREFILL_TOKENS = _counter("serving_prefill_tokens_total",
                           "Prompt tokens actually computed by prefill "
                           "(cache hits skip theirs).", always=True)
_GOODPUT_TOKENS = _counter("serving_goodput_tokens_total",
                           "Tokens delivered by requests that finished "
                           "normally (stop/length) — shed, cancelled and "
                           "timed-out work excluded.",
                           labelnames=("tier",), always=True)
_SHED = _counter("serving_shed_requests_total",
                 "Requests evicted before normal completion, by reason "
                 "(timeout, disconnect, cancelled, shed).",
                 labelnames=("tier", "reason"), always=True)

# per-tick engine gauges: FLAGS_metrics-gated (stats() is the always-on
# view of the same numbers)
_SLOT_OCC = _gauge("serving_slot_occupancy",
                   "Running sequences / decode slots, sampled per tick.")
_BATCH = _gauge("serving_batch_size",
                "Sequences in the decode batch, sampled per tick.")
_HIT_RATE = _gauge("serving_prefix_hit_rate",
                   "Rolling prefix-cache hit rate (cached prompt tokens / "
                   "prompt tokens over recent admissions).")
_SPEC_ACC = _gauge("serving_spec_acceptance",
                   "Cumulative speculative acceptance (accepted / "
                   "proposed draft tokens), sampled per tick.")
_GOODPUT_G = _gauge("serving_goodput_tokens_per_s",
                    "Decoded tokens per second over the recent tick "
                    "window, sampled per tick.")

#: finish reasons that count as delivered work (everything else is shed).
#: "prefill_complete" is the disaggregated prefill-only finish: the KV it
#: computed is the product, not the (zero) output tokens.
_GOOD_REASONS = ("stop", "length", "prefill_complete")

_ENGINE_SEQ = itertools.count()


def new_engine_id() -> str:
    """Unique per-process engine label for serving_engine_events_total."""
    return f"engine{next(_ENGINE_SEQ)}"

_ENGINE_EVENTS = _counter(
    "serving_engine_events_total",
    "Per-engine serving counters (prefill calls and tokens, cache "
    "admissions, speculation ticks, ticks and CUDA graph replays by kind), "
    "labelled by engine instance: the registry backing of ServingEngine's "
    "counter attributes.",
    labelnames=("engine", "event"), always=True)

#: the engine's graph bodies (engine.py): greedy decode steps, a sampled
#: step, the speculative verify window, a prefill chunk
GRAPH_KINDS = ("decode", "sampled", "verify", "prefill", "batched_prefill")

GRAPH_POOL_BYTES = _gauge(
    "serving_graph_pool_bytes",
    "Bytes each kind of an engine's CUDA graph captures added to the "
    "engine's shared graph memory pool.",
    labelnames=("engine", "kind"), always=True)


class EngineStats:
    """Dict-shaped view over serving_engine_events_total{engine=...}.

    ServingEngine's counter attributes (prefill_programs, cow_admissions,
    replays_decode, ...) read through this, so one scrape carries every
    engine's counters while stats() keeps its int values; the engine label
    keeps engines apart."""

    _KEYS = ("prefill_programs", "batched_prefills", "prefill_tokens",
             "cow_admissions", "dedup_admissions", "spec_ticks",
             "spec_proposed", "spec_accepted", "spec_rollbacks",
             "prefill_chunks", "decode_ticks", "sampled_ticks",
             *(f"replays_{kind}" for kind in GRAPH_KINDS))

    __slots__ = ("_eid",)

    def __init__(self, engine_id: str):
        self._eid = str(engine_id)

    @property
    def eid(self) -> str:
        return self._eid

    def inc(self, key: str, amount: int = 1) -> None:
        if key not in self._KEYS:
            raise KeyError(key)
        _ENGINE_EVENTS.inc(amount, engine=self._eid, event=key)

    def __getitem__(self, key: str) -> int:
        if key not in self._KEYS:
            raise KeyError(key)
        return int(_ENGINE_EVENTS.value(engine=self._eid, event=key))


def serving_anomaly_on() -> bool:
    """Serving detectors run when FLAGS_metrics=on and FLAGS_serving_anomaly
    says so ('auto' defers to FLAGS_anomaly)."""
    if not metrics_enabled():
        return False
    mode = str(get_flag("serving_anomaly")).lower()
    if mode in _TRUE:
        return True
    if mode == "auto":
        return str(get_flag("anomaly")).lower() in _TRUE
    return False


class RequestTrace:
    """Per-request span list, mirrored into the global spans ring.

    Attached to a Request at submit when span recording is enabled
    (FLAGS_metrics=on). Request-scoped
    spans go through ``add`` (ring + local list); batch-scoped spans the
    engine records once for everyone land in each participant's list via
    ``note`` without re-recording. Bounded so one long-running request
    cannot grow without bound."""

    MAX_SPANS = 1024

    __slots__ = ("request_id", "tier", "spans", "ctx", "slot")

    def __init__(self, request_id: str, tier: str = "default",
                 ctx: Optional[Dict[str, Any]] = None):
        self.request_id = str(request_id)
        self.tier = str(tier)
        # distributed trace context (Request.trace_ctx): baked into every
        # request-scoped span's args. Batch-scoped spans (one shared dict,
        # see on_decode) are tagged at export time, on copies.
        self.ctx = dict(ctx) if ctx else None
        # decode slot, captured at admission (the scheduler clears
        # req.slot at finish)
        self.slot: Optional[int] = None
        self.spans: deque = deque(maxlen=self.MAX_SPANS)

    def _span(self, name: str, begin_ns: int, end_ns: int,
              **args) -> Dict[str, Any]:
        base = {"request_id": self.request_id}
        if self.ctx:
            base.update(self.ctx)
        base.update(args)
        return {"name": str(name), "begin_ns": int(begin_ns),
                "end_ns": int(end_ns), "cat": "serving",
                "tid": threading.get_ident() & 0xFFFF,
                "args": base}

    def add(self, name: str, begin_ns: int, end_ns: int, **args) -> None:
        """Record a request-scoped span (local list + global ring)."""
        d = self._span(name, begin_ns, end_ns, **args)
        self.spans.append(d)
        _spans.record_span(name, begin_ns, end_ns, cat="serving",
                           args=d["args"])

    def note(self, name: str, begin_ns: int, end_ns: int, **args) -> None:
        """Attach a batch-scoped span (already in the ring) to this
        request's list only."""
        self.spans.append(self._span(name, begin_ns, end_ns, **args))

    def names(self) -> List[str]:
        return [s["name"] for s in self.spans]


def chrome_trace_events(span_dicts, *, pid: Optional[int] = None,
                        tid: Optional[int] = None,
                        extra_args: Optional[Dict[str, Any]] = None
                        ) -> List[Dict[str, Any]]:
    """Ring-format span dicts as chrome-trace complete events.

    Every event gets its own args dict (copied from the span): the engine
    appends one shared per-tick span dict by reference to every traced
    participant (on_decode), so tagging export-time fields on the original
    would touch every other request's trace. `pid` and `tid` override the
    lane; `extra_args` fills keys the span does not already carry."""
    default_pid = os.getpid() if pid is None else pid
    out = []
    for s in span_dicts:
        begin = int(s.get("begin_ns", 0))
        args = dict(s.get("args") or {})
        if extra_args:
            for k, v in extra_args.items():
                args.setdefault(k, v)
        out.append({"name": s.get("name", "?"), "ph": "X",
                    "cat": s.get("cat", "serving"),
                    "ts": begin / 1e3,
                    "dur": max(int(s.get("end_ns", begin)) - begin, 0) / 1e3,
                    "pid": default_pid,
                    "tid": s.get("tid", 0) if tid is None else tid,
                    "args": args})
    return out


def export_request_trace(req, path: str) -> str:
    """Write one request's lifecycle spans as a standalone chrome trace
    (chrome://tracing / Perfetto). ``req`` is a Request with an attached
    trace, or a RequestTrace directly. Raises ValueError when the request
    was never traced (metrics were off at submit)."""
    trace = req if isinstance(req, RequestTrace) else getattr(req, "trace",
                                                              None)
    if trace is None:
        raise ValueError("request has no trace (was FLAGS_metrics on when "
                         "it was submitted?)")
    payload = {"traceEvents": chrome_trace_events(list(trace.spans)),
               "displayTimeUnit": "ms"}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    return path


class ServingObservability:
    """Per-engine observability hub: the engine calls the ``on_*`` hooks
    under its own lock; HTTP handlers read through ``health_snapshot``.

    Cheap when FLAGS_metrics is off: ``tick_begin``/``on_tick`` reduce to
    a flag check and one attribute write, and traces are never attached;
    the always-on SLO observes cost a few dict updates a request."""

    #: samples in the rolling goodput window
    GOODPUT_WINDOW = 16
    #: recent admissions in the rolling prefix-hit-rate window
    ADMIT_WINDOW = 64
    #: gauge/record sampling stride: the tick hot path only accumulates
    #: decoded-token counts; gauges, the tick snapshot and the anomaly
    #: detectors run every TICK_SAMPLE-th engine step
    TICK_SAMPLE = 4

    def __init__(self, engine, *, dump: bool = True,
                 dump_cooldown_steps: int = 50):
        self.engine = engine
        self.dump = bool(dump)
        self.dump_cooldown_steps = int(dump_cooldown_steps)
        n = max(int(get_flag("serving_flight_requests")), 1)
        self._records: deque = deque(maxlen=n)   # finished request records
        self._ticks: deque = deque(maxlen=n)     # engine tick snapshots
        self._tok_window: deque = deque(maxlen=self.GOODPUT_WINDOW)
        self._admit_window: deque = deque(maxlen=self.ADMIT_WINDOW)
        self._admit_matched = 0   # running sums over _admit_window
        self._admit_total = 0
        self._decoded_acc = 0     # decoded tokens since the last sample
        self._tick_n = 0          # sampling stride counter (first tick
        #                           always samples: short runs still
        #                           produce a snapshot + anomaly record)
        self._ttft_acc: List[float] = []
        self._on = False          # metrics enabled, refreshed per tick
        self._trace_on = False    # span recording enabled, per tick
        self._anomaly: Optional[_anomaly.AnomalyEngine] = None
        self._dump_armed_at = -1
        self.last_tick_ts: Optional[float] = None
        self.dumps: List[str] = []
        self.dump_errors: List[str] = []

    def now(self) -> Optional[int]:
        """Span start timestamp, or None when nothing records this tick
        (the engine brackets its dispatches with now()/on_* pairs; a None
        t0 makes the matching hook a no-op)."""
        return time.monotonic_ns() if self._trace_on else None

    # -- request lifecycle hooks (engine lock held) ------------------------
    def on_submit(self, req) -> None:
        if _spans.enabled():
            req.trace = RequestTrace(req.request_id, req.tier,
                                     ctx=getattr(req, "trace_ctx", None))

    def on_shed(self, req, reason: str) -> None:
        """Request rejected at admission (never entered the queue): shed
        accounting only — no trace, no SLO samples, it did no work."""
        _SHED.inc(tier=req.tier, reason=str(reason))

    def on_admitted(self, req) -> None:
        """Queued -> prefill: close the queue-wait span, feed the rolling
        prefix-hit window (running sums — the tick path must not re-sum
        the window)."""
        m, p = req.prefix_matched, len(req.prompt)
        w = self._admit_window
        if len(w) == w.maxlen:
            om, op = w[0]
            self._admit_matched -= om
            self._admit_total -= op
        w.append((m, p))
        self._admit_matched += m
        self._admit_total += p
        tr = req.trace
        if tr is not None:
            tr.slot = req.slot
            if req.prefill_start is not None:
                tr.add("serving.queue", int(req.arrival_time * 1e9),
                       int(req.prefill_start * 1e9),
                       prompt_tokens=len(req.prompt),
                       prefix_matched=req.prefix_matched)

    def on_prefill_chunk(self, req, t0_ns: Optional[int],
                         tokens: int, batched: bool = False) -> None:
        if t0_ns is None:
            return
        tr = req.trace
        if tr is not None:
            tr.add("serving.prefill_chunk", t0_ns, time.monotonic_ns(),
                   tokens=int(tokens), batched=bool(batched))

    def on_first_token(self, req) -> None:
        """Prefill -> running (all three admission-completion sites): SLO
        queue/TTFT observes + the admission span."""
        q = req.queue_seconds()
        if q is not None:
            _QUEUE_H.observe(q, tier=req.tier)
        t = req.ttft_seconds()
        if t is not None:
            _TTFT_H.observe(t, tier=req.tier)
            if self._on:
                self._ttft_acc.append(float(t))
        tr = req.trace
        if tr is not None and req.prefill_start is not None \
                and req.first_token_time is not None:
            tr.add("serving.admit", int(req.prefill_start * 1e9),
                   int(req.first_token_time * 1e9),
                   cached=req._cow_src is not None)

    def on_decode(self, t0_ns: Optional[int], running, k: int = 1,
                  kind: str = "decode", **args) -> None:
        """One decode / speculative-verify dispatch over the batch: one
        ring span, attached to every traced participant. The participants
        share ONE span dict by reference — this runs every engine tick for
        every running request, so per-request dict construction is exactly
        the overhead the <=3% budget forbids."""
        if t0_ns is None:
            return
        t1 = time.monotonic_ns()
        name = f"serving.{kind}"
        span_args = {"batch": len(running), "steps": int(k), **args}
        _spans.record_span(name, t0_ns, t1, cat="serving", args=span_args)
        shared = None
        for _, req in running:
            tr = req.trace
            if tr is not None:
                if shared is None:
                    shared = {"name": name, "begin_ns": int(t0_ns),
                              "end_ns": int(t1), "cat": "serving",
                              "tid": threading.get_ident() & 0xFFFF,
                              "args": span_args}
                tr.spans.append(shared)

    def on_rollback(self, req, rejected: int) -> None:
        tr = req.trace
        if tr is not None:
            now = time.monotonic_ns()
            tr.add("serving.rollback", now, now, rejected=int(rejected))

    def on_finish(self, req, reason: str) -> None:
        """Any terminal transition (stop/length/cancel/timeout/disconnect):
        SLO e2e + TPOT + goodput/shed accounting, the finish span, and the
        flight-arm request record."""
        tier = req.tier
        n = len(req.output_tokens)
        _GEN_TOKENS.inc(n)
        rate = req.decode_tokens_per_s()
        if rate is not None:
            _TOKRATE_H.observe(rate, tier=tier)
        if req.finish_time is not None:
            _E2E_H.observe(req.finish_time - req.arrival_time, tier=tier)
        if req.first_token_time is not None and req.finish_time is not None \
                and n > 1:
            _TPOT_H.observe((req.finish_time - req.first_token_time)
                            / (n - 1), tier=tier)
        if reason in _GOOD_REASONS:
            _GOODPUT_TOKENS.inc(n, tier=tier)
        else:
            _SHED.inc(tier=tier, reason=str(reason))
        tr = req.trace
        if tr is not None:
            now = time.monotonic_ns()
            tr.add("serving.finish", now, now, reason=str(reason),
                   output_tokens=n)
        if self._on or tr is not None:
            self._records.append(self._request_record(req))

    # -- per-tick sampling -------------------------------------------------
    def tick_begin(self) -> Optional[int]:
        """Start-of-tick: refresh the cached enable flags; returns the
        tick's start timestamp when anything records, else None."""
        self._on = metrics_enabled()
        self._trace_on = _spans.enabled()
        if self._on or self._trace_on:
            return time.monotonic_ns()
        return None

    def on_tick(self, t0_ns: Optional[int], out: Dict[str, Any]) -> None:
        """End-of-tick: tick span, then — every TICK_SAMPLE-th step —
        engine gauges, the tick snapshot record, and anomaly detection
        (+ flight dump). Between samples the hot path is one liveness
        timestamp and a decoded-token accumulate. Called under the engine
        lock."""
        eng = self.engine
        now = time.monotonic()
        self.last_tick_ts = now
        if t0_ns is not None and self._trace_on:
            _spans.record_span(
                "serving.tick", t0_ns, time.monotonic_ns(), cat="serving",
                args={"step": eng.steps, "decoded": out["decoded_tokens"],
                      "running": out["running"]})
        if not self._on:
            return
        self._decoded_acc += int(out["decoded_tokens"])
        n = self._tick_n
        self._tick_n = n + 1
        if n % self.TICK_SAMPLE:
            return
        running = int(out["running"])
        _SLOT_OCC.set(running / eng.max_slots if eng.max_slots else 0.0)
        _BATCH.set(running)
        self._tok_window.append((now, self._decoded_acc))
        rec: Dict[str, Any] = {
            "kind": "serving_tick", "step": eng.steps, "ts": time.time(),
            "decoded_tokens": self._decoded_acc,
            "running": running, "waiting": int(out["waiting"]),
            "kv_conservation_breach":
                0.0 if eng.allocator.conservation_ok() else 1.0,
        }
        self._decoded_acc = 0
        goodput = self._windowed_goodput()
        if goodput is not None:
            rec["goodput_tokens_per_s"] = goodput
            _GOODPUT_G.set(goodput)
        if self._admit_total:
            rate = self._admit_matched / self._admit_total
            rec["prefix_hit_rate"] = rate
            _HIT_RATE.set(rate)
        proposed = eng.spec_proposed
        if proposed:
            _SPEC_ACC.set(eng.spec_accepted / proposed)
        if self._ttft_acc:
            rec["ttft_s"] = sum(self._ttft_acc) / len(self._ttft_acc)
            self._ttft_acc = []
        self._ticks.append(rec)
        self.observe_record(rec)

    def observe_record(self, rec: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Feed one tick record through the serving anomaly detectors;
        dumps the flight arm on detection. Public seam: tests inject
        synthetic records through the same path on_tick uses."""
        engine = self._anomaly_engine()
        if engine is None:
            return []
        events = engine.observe(rec)
        if events and self.dump:
            self._maybe_dump(events)
        return events

    def _windowed_goodput(self) -> Optional[float]:
        if len(self._tok_window) < 2:
            return None
        t_first = self._tok_window[0][0]
        t_last = self._tok_window[-1][0]
        dt = t_last - t_first
        if dt <= 0:
            return None
        # tokens of every tick after the window's first timestamp
        toks = sum(n for _, n in list(self._tok_window)[1:])
        return toks / dt

    def _anomaly_engine(self) -> Optional[_anomaly.AnomalyEngine]:
        """Lazy: detectors arm the first tick the flags allow it (dump
        handled here, so the shared engine runs with dump=False)."""
        if self._anomaly is None and serving_anomaly_on():
            self._anomaly = _anomaly.AnomalyEngine(
                _anomaly.serving_default_detectors(), dump=False)
        return self._anomaly

    def _maybe_dump(self, events: List[Dict[str, Any]]) -> None:
        step = self.engine.steps
        if step <= self._dump_armed_at:
            return
        self._dump_armed_at = step + self.dump_cooldown_steps
        sched = self.engine.sched
        inflight = [self._request_record(r)
                    for r in list(sched.prefilling)
                    + list(sched.running.values())]
        extra = {
            "anomaly": events[0],
            "serving_anomalies": events,
            "serving_requests": list(self._records) + inflight,
            "serving_ticks": list(self._ticks),
        }
        try:
            path = _flight.get_flight_recorder().dump(
                f"serving_{events[0]['kind']}", extra=extra)
        except OSError as e:
            # an unwritable dump directory must not stop serving: keep
            # the error where health_snapshot readers and tests see it
            self.dump_errors.append(f"{type(e).__name__}: {e}")
            return
        self.dumps.append(path)

    def _request_record(self, req) -> Dict[str, Any]:
        rec = dict(req.telemetry())
        rec["ts"] = time.time()
        tr = req.trace
        if tr is not None:
            rec["trace"] = list(tr.spans)
        return rec

    # -- snapshots (HTTP handlers; takes the engine lock itself) -----------
    def health_snapshot(self, loop_alive: bool = True,
                        stale_after_s: float = STALE_AFTER_S
                        ) -> Dict[str, Any]:
        """The serving /healthz body: one consistent engine snapshot taken
        under the engine lock (load-balancer semantics — 'ok' False means
        take this replica out of rotation; the body says why)."""
        now = time.monotonic()
        eng = self.engine
        with eng._lock:
            counts = eng.sched.counts()
            steps = eng.steps
            has_work = eng.sched.has_work()
            draining = bool(getattr(eng, "_draining", False))
            last_tick = self.last_tick_ts
            anomaly = self._anomaly
        out: Dict[str, Any] = {
            "status": "ok", "ok": True, "steps": steps,
            "last_tick_age_s": (round(now - last_tick, 3)
                                if last_tick is not None else None),
            **counts,
        }
        if not loop_alive:
            out["status"], out["ok"] = "dead", False
            return out
        recent = []
        if anomaly is not None:
            wall = time.time()
            recent = [a for a in anomaly.recent()
                      if wall - float(a.get("ts", 0)) <= ANOMALY_RECENT_S]
        out["anomalies_recent"] = len(recent)
        if recent:
            out["status"], out["ok"] = "anomalous", False
            out["last_anomaly"] = {k: v for k, v in recent[-1].items()
                                   if k in ("kind", "step", "value")}
        elif has_work and last_tick is not None \
                and now - last_tick > float(stale_after_s):
            out["status"], out["ok"] = "stale", False
        elif draining:
            # deliberate drain: not a fault, but ok=False so a load
            # balancer stops routing here while in-flight work finishes
            out["status"], out["ok"] = "draining", False
        elif steps == 0 and not has_work:
            out["status"] = "idle"
        return out
