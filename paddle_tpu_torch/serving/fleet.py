"""FleetRouter: fault-tolerant routing across N ServingEngine replicas
(counterpart of paddle_tpu/serving/fleet.py).

One engine is one replica and one point of failure; the fleet puts a
router in front of N of them. A replica is a thread of this process over
its own engine (model, KV pool and CUDA graphs), or a supervised process
of its own (serving/fleet_proc.py's ProcessReplica, built from a
ProcessReplicaSpec). Discovery and liveness go through a process-group
store (distributed/env.py's InProcStore or native.TCPStore, and its
ReplicaRegistry):

  * prefix-cache-aware routing: the chain hashes of serving/blocks.py are
    content addresses, so the router asks each healthy replica how many
    prompt tokens its cache would serve (allocator.peek_match, no side
    effects) and routes to the longest match, then the least load.
  * health: every replica loop heartbeats a store lease; a replica whose
    lease expired or whose loop thread died is dead. A consecutive-error
    circuit breaker (open -> half-open probe -> closed) takes a replica
    that keeps failing submissions or ticks out of rotation first.
  * re-dispatch: requests in flight on a dead replica are resubmitted
    (same request id, full prompt) onto a survivor; greedy decode is
    deterministic, so the output equals a run without the failure.
  * hedged retries: a request past a TTFT deadline with no token is
    duplicated onto a second replica; the first to produce a token wins
    and the loser is cancelled (ServingEngine.cancel frees its slot and KV
    reservation).
  * graceful drain: drain(rid) stops admissions to one replica while its
    in-flight work completes (/healthz says `draining`).
  * load shedding: when every healthy replica's queue is full the router
    raises QueueFullError with a jittered Retry-After.
  * disaggregated prefill/decode: FLAGS_fleet_roles splits the fleet into
    prefill and decode replicas. A request first runs prefill-only on a
    prefill replica; its full KV blocks stream to the best decode replica
    (engine.export_kv_blocks / ingest_kv_blocks: chain-hash keyed,
    idempotent, the records /kv/export and /kv/ingest carry), and the
    decode attempt admits them as prefix-cache hits. "symmetric" (the
    default) keeps every replica in both roles.
  * live KV migration: drain(rid, migrate=True) ships each in-flight
    session's resident prompt blocks to a survivor over the same records
    and re-places the attempt there, which re-decodes without prefilling
    any full block again.
  * elastic autoscaling: FleetAutoscaler compares offered load with the
    fleet's slots and adds replicas (add_replica) or retires them (a
    migrating drain, then remove_replica) under hysteresis and a cooldown.

One deliberate difference: between a finished prefill-only attempt and
the decode attempt the handoff places (the KV stream in between), a
request has no live attempt. The reference's monitor, polling from its own
thread meanwhile, takes it for an orphan and re-dispatches it, a full
prefill on a decode replica beside the decode attempt that then lands too;
the port marks the request `_advancing` for that window, so neither the
orphan re-dispatch nor a hedge fires. Stepped by hand in one thread, both
routers decide alike.

A replica loop turns an exception in a tick into a breaker strike, as the
reference does; `CircuitBreaker.failures` counts every strike and
`Replica.last_error` keeps the last tick's traceback, so a caller can tell
an injected fault from a real one. Every poll runs each replica's
supervision turn (`Replica.supervise`: nothing for a thread, the exit,
lease, respawn and fence state machine for a process).
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Dict, List, Optional

from ..core import flags as _flags
from ..distributed.env import InProcStore, ReplicaRegistry
from ..observability import spans as _spans
from ..observability.registry import counter as _counter
from ..observability.registry import gauge as _gauge
from ..observability.registry import histogram as _histogram
from . import fleet_observability as _fobs
from .engine import EngineDrainingError, QueueFullError, ServingEngine
from .observability import RequestTrace

_flags.define_flag("fleet_replicas", 2,
                   "Serving replicas a fleet front end builds when not "
                   "given explicit engines (tools/servebench.py fleet "
                   "mode; FleetServer).")
_flags.define_flag("fleet_hedge_ttft_ms", 0.0,
                   "Hedged-retry TTFT deadline in milliseconds: a request "
                   "with no first token past this age is duplicated onto "
                   "a second healthy replica; first token wins and the "
                   "loser is cancelled (slot + KV reservation freed). "
                   "0 (default) disables hedging.")
_flags.define_flag("fleet_breaker_errors", 3,
                   "Consecutive submission/tick errors that open a "
                   "replica's circuit breaker (replica leaves the routing "
                   "set until a half-open probe succeeds).")
_flags.define_flag("fleet_breaker_cooldown_s", 2.0,
                   "Seconds an open circuit breaker waits before allowing "
                   "one half-open probe request through.")
_flags.define_flag("fleet_roles", "symmetric",
                   "Replica role layout for disaggregated serving: "
                   "'symmetric' (default — every replica both prefils and "
                   "decodes, exactly the pre-disagg behavior) or a "
                   "'role:count,...' spec like 'prefill:1,decode:3' "
                   "assigned to replicas in construction order. Prefill "
                   "replicas only run prefill-only attempts and stream "
                   "their finished KV blocks; decode replicas only host "
                   "decode attempts.")
_flags.define_flag("fleet_drain_migrate", False,
                   "When on, drain(rid) also live-migrates in-flight "
                   "sessions: their resident prompt KV blocks stream to a "
                   "survivor and the attempts re-place there instead of "
                   "finishing on the draining replica. Off keeps the plain "
                   "drain (in-flight work completes in place).")
_flags.define_flag("fleet_scale_min", 1,
                   "FleetAutoscaler floor: scalable replicas are never "
                   "drained below this count.")
_flags.define_flag("fleet_scale_max", 8,
                   "FleetAutoscaler ceiling: never spawn past this many "
                   "scalable replicas.")
_flags.define_flag("fleet_scale_hi", 0.85,
                   "Scale-up threshold: utilization (offered load / fleet "
                   "slot capacity) at or above this spawns a replica once "
                   "the cooldown allows.")
_flags.define_flag("fleet_scale_lo", 0.25,
                   "Scale-down threshold: utilization at or below this "
                   "drains (migration-assisted) and retires the least "
                   "loaded scalable replica.")
_flags.define_flag("fleet_scale_cooldown_s", 5.0,
                   "Minimum seconds between autoscaler actions, so a "
                   "bursty curve cannot flap the fleet.")

# fleet-level SLO + routing telemetry: always-on like the engine's tier
# histograms. The engine-level serving_* histograms are registry-global,
# so they already aggregate across every replica in the process; the
# fleet_* ones below measure the REQUEST as the client saw it (arrival at
# the router to first token / finish, across re-dispatches and hedges).
_ROUTED = _counter("fleet_requests_routed_total",
                   "Requests dispatched to a replica (first placement).",
                   labelnames=("replica",), always=True)
_REDISPATCHED = _counter("fleet_requests_redispatched_total",
                         "In-flight requests resubmitted to a survivor "
                         "after their replica died.", always=True)
_HEDGED = _counter("fleet_requests_hedged_total",
                   "Requests duplicated onto a second replica past the "
                   "TTFT hedge deadline.", always=True)
_HEDGE_WINS = _counter("fleet_hedge_wins_total",
                       "Hedged requests resolved, by which attempt "
                       "produced the first token.",
                       labelnames=("winner",), always=True)
_FLEET_SHED = _counter("fleet_requests_shed_total",
                       "Requests rejected fleet-wide (503 + Retry-After).",
                       labelnames=("reason",), always=True)
_REPLICA_UP = _gauge("fleet_replica_health",
                     "Routable health per replica: 1 healthy, 0.5 "
                     "draining, 0.25 breaker open, 0 dead.",
                     labelnames=("replica",), always=True)
_FLEET_TTFT = _histogram("fleet_ttft_seconds",
                         "Router arrival to first token, across "
                         "re-dispatches and hedges.",
                         labelnames=("tier",), always=True)
_FLEET_E2E = _histogram("fleet_e2e_seconds",
                        "Router arrival to finish, across re-dispatches "
                        "and hedges.", labelnames=("tier",), always=True)

_GOOD_REASONS = ("stop", "length")

_fleet_req_lock = threading.Lock()
_fleet_req_counter = 0


def _next_fleet_id() -> str:
    global _fleet_req_counter
    with _fleet_req_lock:
        _fleet_req_counter += 1
        return f"fleet-{_fleet_req_counter}"


_ROLES = ("prefill", "decode", "any")


def parse_fleet_roles(spec: Optional[str], n_replicas: int) -> List[str]:
    """Expand a FLAGS_fleet_roles spec to one role per replica, in
    construction order. 'symmetric' / empty -> all 'any' (the pre-disagg
    behavior); otherwise 'role:count,...' must cover every replica."""
    spec = (spec or "symmetric").strip().lower()
    if spec in ("", "symmetric"):
        return ["any"] * n_replicas
    roles: List[str] = []
    for part in spec.split(","):
        name, _, count = part.partition(":")
        name = name.strip()
        if name not in _ROLES:
            raise ValueError(f"unknown fleet role {name!r} "
                             f"(want one of {_ROLES})")
        roles.extend([name] * int(count or 1))
    if len(roles) != n_replicas:
        raise ValueError(f"fleet_roles covers {len(roles)} replicas, "
                         f"fleet has {n_replicas}")
    return roles


class CircuitBreaker:
    """Consecutive-error breaker: closed -> open after `max_errors`
    failures in a row -> half-open after `cooldown_s` (ONE probe allowed
    through) -> closed on probe success, re-open on probe failure."""

    def __init__(self, max_errors: int, cooldown_s: float,
                 clock=time.monotonic):
        self.max_errors = int(max_errors)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._errors = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        # every strike since construction (the streak resets on success)
        self.failures = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """May a request be sent through right now? In half-open exactly
        one caller wins the probe token; the rest stay rejected until the
        probe resolves via record_success/record_failure."""
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return True
            if st == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._errors = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self):
        with self._lock:
            self.failures += 1
            self._errors += 1
            if self._probing or self._errors >= self.max_errors:
                self._opened_at = self._clock()
                self._probing = False


class _Attempt:
    """One engine-level placement of a fleet request."""
    __slots__ = ("replica", "req", "kind", "failed", "index", "route_t0")

    def __init__(self, replica: "Replica", req, kind: str,
                 index: int = 0, route_t0: Optional[float] = None):
        self.replica = replica
        self.req = req
        self.kind = kind            # "primary" | "redispatch" | "hedge"
        self.failed = False
        self.index = int(index)     # position in FleetRequest.attempts
        self.route_t0 = route_t0    # monotonic s at routing-decision entry


class FleetRequest:
    """Router-level request handle: survives replica death (the engine
    request it maps to may be replaced by a re-dispatch or raced by a
    hedge; callers only ever see this object)."""

    def __init__(self, prompt: List[int], *, max_new_tokens: int,
                 temperature: float, eos_token_id: Optional[int],
                 request_id: Optional[str], tier: str, router: "FleetRouter",
                 submit_ts: float):
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.request_id = request_id or _next_fleet_id()
        self.tier = tier
        self.submit_ts = submit_ts
        self.first_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self.output_tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.attempts: List[_Attempt] = []
        self.hedged = False
        self.redispatches = 0
        # disaggregation bookkeeping: the last KV-block transfer this
        # request rode ({src, dst, imported, dedup, ...}) and how many
        # times it was live-migrated off a draining replica
        self.kv_streamed: Optional[dict] = None
        self.migrations = 0
        # router-lane RequestTrace (route decisions, queue-at-router,
        # hedge fire/win/cancel); None when spans were off at submit
        self.trace: Optional[RequestTrace] = None
        self._orphan_ns: Optional[int] = None  # orphan-detection instant
        # set from a finished prefill-only attempt until its decode attempt
        # is placed: no live attempt then, and no orphan either
        self._advancing = False
        self._router = router
        self._lock = threading.Lock()
        self._settled = False
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def live_attempts(self) -> List[_Attempt]:
        with self._lock:
            return [a for a in self.attempts if not a.failed]

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request finishes (on ANY replica). Driven by
        the engine-level done events of the current attempts, with the
        router's settle logic run from the waiter's thread — completion
        does not wait for the monitor tick."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while True:
            if self._done.is_set():
                return True
            self._router._settle(self)
            if self._done.is_set():
                return True
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                return False
            slice_s = 0.05 if remaining is None else min(0.05, remaining)
            atts = self.live_attempts()
            if atts:
                atts[0].req.wait(slice_s)
            else:
                # between death and re-dispatch: nothing to wait on
                time.sleep(min(slice_s, 0.005))


class Replica:
    """One ServingEngine plus its loop thread, heartbeat lease, breaker,
    and drain flag. kill() simulates a crash (loop exits, heartbeats
    stop, nothing cleaned up); pause() simulates a hang (loop alive and
    heartbeating but not stepping — the hedging target).

    A replica with real isolation (serving/fleet_proc.ProcessReplica)
    overrides the lifecycle and liveness surface: dead(), warming(),
    supervise() and the routing probes. The router only talks to this
    interface, so threads and processes share one placement path."""

    def __init__(self, rid: str, engine: ServingEngine, *,
                 registry: ReplicaRegistry, heartbeat_s: float,
                 breaker: CircuitBreaker, clock=time.monotonic,
                 idle_sleep_s: float = 0.002):
        self.rid = rid
        self.engine = engine
        self.registry = registry
        self.heartbeat_s = float(heartbeat_s)
        self.breaker = breaker
        self.draining = False
        # disaggregation role: "any" (dual: the symmetric default),
        # "prefill" (prefill-only attempts; KV streams out), "decode"
        # (decode attempts only; KV streams in)
        self.role = "any"
        # supervision surface (constant for thread replicas; live for
        # process replicas): incarnation fence, host pid, respawn count,
        # last exit record {incarnation, pid, exit_code, reason, ...}
        self.incarnation = 0
        self.pid: Optional[int] = os.getpid()
        self.respawns = 0
        self.last_exit: Optional[dict] = None
        self._clock = clock
        self._idle_sleep_s = float(idle_sleep_s)
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._killed = False
        self._thread: Optional[threading.Thread] = None
        # the traceback of the last tick that raised
        self.last_error: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self.registry.heartbeat(self.rid)
        self._thread = threading.Thread(
            target=self._loop, name=f"fleet-{self.rid}", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def kill(self):
        """Simulated crash: the loop exits without any cleanup and the
        heartbeat lease is left to expire."""
        self._killed = True
        self._stop.set()

    def pause(self):
        self._pause.set()

    def unpause(self):
        self._pause.clear()

    def loop_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- liveness / supervision (overridden by process replicas) ----------
    def dead(self, lease_ttl_s: float) -> bool:
        """Is this replica dead right now? Thread replicas die when
        killed, when their loop thread exited, or when their store lease
        lapsed."""
        if self._killed:
            return True
        if self._thread is not None and not self._thread.is_alive():
            return True
        return not self.registry.alive(self.rid, float(lease_ttl_s))

    def warming(self) -> bool:
        """True while the replica exists but must not take traffic yet.
        A thread replica never is; a process replica is until its
        warm-up probe passes."""
        return False

    def supervise(self, router: "FleetRouter") -> None:
        """One supervision turn, called from every router poll. A thread
        replica has no supervisor (a dead thread stays dead); a process
        replica detects death and runs its backoff, fence and respawn
        state machine here."""

    def _loop(self):
        hb_last = -float("inf")
        while not self._stop.is_set():
            now = self._clock()
            if now - hb_last >= self.heartbeat_s:
                self.registry.heartbeat(self.rid)
                hb_last = now
            if self._pause.is_set():
                time.sleep(self._idle_sleep_s)
                continue
            try:
                if self.engine.sched.has_work():
                    self.engine.step()
                    self.breaker.record_success()
                else:
                    time.sleep(self._idle_sleep_s)
            except Exception:  # noqa: BLE001 — a tick fault is a breaker
                self.last_error = traceback.format_exc()
                self.breaker.record_failure()  # strike, not a loop crash
                time.sleep(self._idle_sleep_s)

    # -- routing inputs ----------------------------------------------------
    def load(self) -> int:
        s = self.engine.sched
        return len(s.waiting) + len(s.prefilling) + len(s.running)

    def affinity(self, prompt: List[int]) -> int:
        """Prompt tokens this replica's cache would serve (content-
        addressed chain match; consistent read under the engine lock)."""
        if not self.engine.prefix_cache:
            return 0
        with self.engine._lock:
            return int(self.engine.allocator.peek_match(prompt))

    def queue_depth(self) -> int:
        return len(self.engine.sched.waiting)


class FleetRouter:
    """Routes requests across replicas; detects failures via store
    heartbeat leases + circuit breakers; re-dispatches, hedges, drains
    and sheds. Replica engine loops and the monitor are daemon threads
    owned by the router (start()/stop())."""

    def __init__(self, engines: Optional[List[ServingEngine]] = None, *,
                 replica_specs: Optional[List] = None,
                 store=None, prefix: str = "/pt/fleet",
                 roles: Optional[str] = None,
                 hedge_ttft_ms: Optional[float] = None,
                 breaker_errors: Optional[int] = None,
                 breaker_cooldown_s: Optional[float] = None,
                 heartbeat_s: float = 0.05, lease_ttl_s: float = 0.5,
                 poll_interval_s: float = 0.02,
                 idle_sleep_s: float = 0.002, clock=time.monotonic):
        engines = list(engines or [])
        replica_specs = list(replica_specs or [])
        if not engines and not replica_specs:
            raise ValueError("FleetRouter needs at least one engine or "
                             "replica spec")
        self._clock = clock
        self.lease_ttl_s = float(lease_ttl_s)
        self.poll_interval_s = float(poll_interval_s)
        self._heartbeat_s = float(heartbeat_s)
        self._idle_sleep_s = float(idle_sleep_s)
        self.hedge_ttft_s = float(
            _flags.get_flag("fleet_hedge_ttft_ms")
            if hedge_ttft_ms is None else hedge_ttft_ms) / 1000.0
        max_errors = int(_flags.get_flag("fleet_breaker_errors")
                         if breaker_errors is None else breaker_errors)
        cooldown = float(_flags.get_flag("fleet_breaker_cooldown_s")
                         if breaker_cooldown_s is None else
                         breaker_cooldown_s)
        self._breaker_cfg = (max_errors, cooldown)
        self.registry = ReplicaRegistry(store if store is not None
                                        else InProcStore(),
                                        prefix=prefix, clock=clock)
        # add_replica/remove_replica change this dict (under _lock) from
        # the autoscaler's thread: every scan iterates a snapshot of it
        self.replicas: Dict[str, Replica] = {}
        for i, eng in enumerate(engines):
            rid = f"replica-{i}"
            rep = Replica(rid, eng, registry=self.registry,
                          heartbeat_s=heartbeat_s,
                          breaker=CircuitBreaker(max_errors, cooldown,
                                                 clock=clock),
                          clock=clock, idle_sleep_s=idle_sleep_s)
            self.replicas[rid] = rep
            self.registry.register(rid, meta={
                "slots": eng.max_slots, "blocks": eng.num_blocks})
        # replicas in processes of their own: each spec builds a Replica
        # subclass (fleet_proc.ProcessReplicaSpec -> ProcessReplica) on the
        # same placement and poll path as the threads
        for j, spec in enumerate(replica_specs):
            rid = f"replica-{len(engines) + j}"
            self.replicas[rid] = spec.build(
                rid, registry=self.registry, heartbeat_s=heartbeat_s,
                breaker=CircuitBreaker(max_errors, cooldown, clock=clock),
                clock=clock, idle_sleep_s=idle_sleep_s)
            self.registry.register(rid, meta={"kind": "process"})
        role_spec = (str(_flags.get_flag("fleet_roles"))
                     if roles is None else roles)
        for rep, role in zip(self.replicas.values(),
                             parse_fleet_roles(role_spec,
                                               len(self.replicas))):
            rep.role = role
        self._next_rid = len(self.replicas)
        self._started = False
        self.autoscaler = None          # attach_autoscaler() ticks in poll
        self._inflight: Dict[str, FleetRequest] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        # fleet observability hub: trace merge, attempt SLOs, anomaly
        # detectors + flight dumps (serving/fleet_observability.py)
        self.obs = _fobs.FleetObservability(self)
        # last breaker state seen per replica, to turn the breakers'
        # implicit (time-derived) transitions into explicit events
        self._breaker_seen: Dict[str, str] = {
            rid: "closed" for rid in self.replicas}

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._started = True
        for rep in list(self.replicas.values()):
            rep.start()
        if self._monitor is None:
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-monitor", daemon=True)
            self._monitor.start()
        return self

    def stop(self):
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
            self._monitor = None
        for rep in list(self.replicas.values()):
            rep.stop()

    def _monitor_loop(self):
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception:  # noqa: BLE001 — the monitor must survive
                pass
            time.sleep(self.poll_interval_s)

    # -- health ------------------------------------------------------------
    def replica_dead(self, rep: Replica) -> bool:
        return rep.dead(self.lease_ttl_s)

    def routable(self, rep: Replica) -> bool:
        """May NEW work be placed on this replica right now? (Breaker
        half-open counts: allow() hands out the probe token at submit.)"""
        return (not self.replica_dead(rep) and not rep.draining
                and not rep.warming() and rep.breaker.state != "open")

    def _breaker_event(self, rep: Replica):
        """Surface a breaker state change as an observability event.
        Called after every record_success/record_failure on the router
        path and once per poll per replica (the engine loop strikes the
        breaker from its own thread, and open -> half_open is
        time-derived, so poll-time sampling catches both)."""
        new = rep.breaker.state
        old = self._breaker_seen.get(rep.rid)
        if new != old:
            self._breaker_seen[rep.rid] = new
            self.obs.on_breaker(rep.rid, old, new)

    def _refresh_health_gauges(self):
        for rep in list(self.replicas.values()):
            self._breaker_event(rep)
            if self.replica_dead(rep):
                v = 0.0
            elif rep.draining:
                v = 0.5
            elif rep.breaker.state == "open":
                v = 0.25
            else:
                v = 1.0
            _REPLICA_UP.set(v, replica=rep.rid)

    # -- admission / routing -----------------------------------------------
    def _ranked(self, prompt: List[int],
                exclude: Optional[set] = None) -> List[Replica]:
        """Healthy replicas, best first: longest cached prefix chain,
        then least load, then stable id order."""
        scored = []
        for rep in list(self.replicas.values()):
            if exclude and rep.rid in exclude:
                continue
            if not self.routable(rep):
                continue
            scored.append((-rep.affinity(prompt), rep.load(), rep.rid, rep))
        scored.sort(key=lambda t: t[:3])
        return [t[3] for t in scored]

    def _role_ok(self, rep: Replica, cause: str) -> bool:
        """May a `cause` attempt land on this replica's role? Prefill-only
        attempts go to prefill replicas, everything else to decode ones;
        'any' (the symmetric default) hosts both."""
        if cause == "prefill":
            return rep.role in ("prefill", "any")
        return rep.role in ("decode", "any")

    def _place(self, freq: FleetRequest, cause: str,
               exclude: Optional[set] = None,
               prefer: Optional[str] = None):
        """Place ONE attempt of `freq` on the best healthy replica —
        the single routing path behind primary submit, re-dispatch,
        hedge, disaggregated prefill/decode and migration. Probes every
        role-compatible candidate (affinity + load; `prefer` pins a
        replica to the front, e.g. the KV-transfer target), stamps the
        engine placement with the distributed trace context
        ``{fleet_request_id, attempt, cause}``, and records the
        route-decision span (probe results included) through the fleet
        observability hub. A ``cause="prefill"`` placement submits
        prefill-only: the engine computes + keeps the prompt KV and
        finishes with "prefill_complete" instead of decoding. Returns
        ``(attempt, saw_queue_full)`` with ``attempt is None`` when no
        replica accepted."""
        t0_ns = time.monotonic_ns()
        probes = []
        scored = []
        for rep in list(self.replicas.values()):
            if exclude and rep.rid in exclude:
                continue
            if not self.routable(rep) or not self._role_ok(rep, cause):
                continue
            aff = rep.affinity(freq.prompt)
            load = rep.load()
            probes.append({"replica": rep.rid, "affinity": int(aff),
                           "load": int(load)})
            scored.append((0 if rep.rid == prefer else 1, -aff, load,
                           rep.rid, rep))
        scored.sort(key=lambda t: t[:4])
        saw_queue_full = None
        for *_key, rep in scored:
            if not rep.breaker.allow():
                continue
            idx = len(freq.attempts)
            extra_kw = {"prefill_only": True} if cause == "prefill" else {}
            try:
                req = rep.engine.submit(
                    freq.prompt, max_new_tokens=freq.max_new_tokens,
                    temperature=freq.temperature,
                    eos_token_id=freq.eos_token_id,
                    request_id=freq.request_id, tier=freq.tier,
                    trace_ctx=_fobs.trace_context(freq.request_id, idx,
                                                  cause),
                    **extra_kw)
            except QueueFullError as e:
                # load, not fault: no breaker strike
                rep.breaker.record_success()
                self._breaker_event(rep)
                saw_queue_full = e
                continue
            except EngineDrainingError:
                rep.breaker.record_success()
                self._breaker_event(rep)
                continue
            except ValueError:
                raise                   # bad request, not a replica fault
            except Exception:  # noqa: BLE001 — replica fault
                rep.breaker.record_failure()
                self._breaker_event(rep)
                continue
            rep.breaker.record_success()
            self._breaker_event(rep)
            att = _Attempt(rep, req, cause, index=idx,
                           route_t0=t0_ns / 1e9)
            with freq._lock:
                freq.attempts.append(att)
            self.obs.on_dispatch(freq, att, probes, t0_ns)
            freq._orphan_ns = None
            _ROUTED.inc(replica=rep.rid)
            return att, saw_queue_full
        return None, saw_queue_full

    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None,
               tier: str = "default") -> FleetRequest:
        """Route a request to the best healthy replica. Raises
        QueueFullError (with a jittered Retry-After) when every healthy
        replica's queue is full — fleet-level load shedding."""
        freq = FleetRequest(prompt, max_new_tokens=max_new_tokens,
                            temperature=temperature,
                            eos_token_id=eos_token_id,
                            request_id=request_id, tier=tier, router=self,
                            submit_ts=self._clock())
        if _spans.enabled():
            freq.trace = RequestTrace(freq.request_id, freq.tier)
        att = saw_queue_full = None
        if self._disagg_active():
            # stage 1 of the disaggregated pipeline: prefill-only on a
            # prefill replica. _settle() advances the request to the KV
            # transfer + decode placement when it finishes. Falls through
            # to a direct decode placement when no prefill replica can
            # take it (all dead/full) — disagg degrades, never rejects.
            att, saw_queue_full = self._place(freq, "prefill")
        if att is None:
            att, saw_queue_full = self._place(freq, "primary")
        if att is None:
            if saw_queue_full is not None:
                _FLEET_SHED.inc(reason="queue_full")
                raise QueueFullError(saw_queue_full.depth,
                                     saw_queue_full.limit)
            _FLEET_SHED.inc(reason="no_healthy_replica")
            raise QueueFullError(0, 0)
        with self._lock:
            self._inflight[freq.request_id] = freq
        return freq

    # -- monitor pass (public so tests can drive it deterministically) -----
    def poll(self):
        """One supervision pass: run each replica's supervision turn
        (death detection and the respawn state machine of a process
        replica; nothing for a thread), refresh health, settle finished
        requests, re-dispatch orphans of dead replicas, resolve and fire
        hedges."""
        for rep in list(self.replicas.values()):
            try:
                rep.supervise(self)
            except Exception:  # noqa: BLE001 — supervision must survive
                pass
        self._refresh_health_gauges()
        if self.autoscaler is not None:
            try:
                self.autoscaler.tick()
            except Exception:  # noqa: BLE001 — scaling must not wound poll
                pass
        now = self._clock()
        with self._lock:
            pending = list(self._inflight.values())
        for freq in pending:
            if self._settle(freq):
                continue
            self._redispatch_if_orphaned(freq)
            self._resolve_hedge(freq)
            self._maybe_hedge(freq, now)
        self.obs.tick()

    def _settle(self, freq: FleetRequest) -> bool:
        """Complete the fleet request if any attempt finished cleanly;
        cancel the losers. Returns True when the request is done. A
        finished prefill-only attempt never wins: it advances the
        disaggregated pipeline (KV stream + decode placement) instead."""
        advance = None
        with freq._lock:
            if freq._settled:
                return True
            winner = None
            for att in freq.attempts:
                if att.failed:
                    continue
                toks, state, reason = \
                    att.replica.engine.snapshot_output(att.req)
                if state == "finished":
                    if att.kind == "prefill":
                        # consumed either way: on prefill_complete the KV
                        # streams to a decode replica; on anything else
                        # (cancel, error) the decode placement below
                        # simply won't find streamed blocks
                        att.failed = True
                        freq._advancing = True
                        advance = (att, reason)
                        continue
                    if reason in _GOOD_REASONS:
                        winner = (att, toks, reason)
                        break
                    att.failed = True    # cancelled out from under us
            if winner is None:
                if advance is None:
                    return False
            else:
                att, toks, reason = winner
                freq.output_tokens = list(toks)
                freq.finish_reason = reason
                if freq.first_token_ts is None \
                        and att.req.first_token_time is not None:
                    freq.first_token_ts = att.req.first_token_time
                freq.finish_ts = self._clock()
                losers = [a for a in freq.attempts
                          if a is not att and not a.failed]
                for a in losers:
                    a.failed = True
                if freq.hedged:
                    _HEDGE_WINS.inc(
                        winner="hedge" if att.kind == "hedge" else "primary")
                freq._settled = True
        if winner is None:
            self._advance_disagg(freq, advance[0], advance[1])
            return False
        for a in losers:
            toks_lost, _s, _r = a.replica.engine.snapshot_output(a.req)
            a.replica.engine.cancel(a.req, "hedge_lost")
            self.obs.on_cancelled(freq, a, len(toks_lost), "hedge_lost")
        if freq.hedged and losers:
            # hedge raced all the way to the finish (first token and
            # completion arrived in the same tick) — _resolve_hedge
            # never got to declare the winner
            self.obs.on_hedge_win(freq, att)
        if freq.first_token_ts is not None:
            _FLEET_TTFT.observe(max(0.0, freq.first_token_ts
                                    - freq.submit_ts), tier=freq.tier)
        _FLEET_E2E.observe(max(0.0, freq.finish_ts - freq.submit_ts),
                           tier=freq.tier)
        self.obs.on_settle(freq, att)
        with self._lock:
            self._inflight.pop(freq.request_id, None)
        freq._done.set()
        return True

    # -- disaggregated prefill/decode pipeline ------------------------------
    def _disagg_active(self) -> bool:
        """Run the two-stage pipeline only while a prefill replica can
        actually take work — otherwise requests place directly on the
        decode pool (full prefill there, symmetric behavior)."""
        return any(rep.role == "prefill" and self.routable(rep)
                   for rep in list(self.replicas.values()))

    def _pick_decode_target(self, freq: FleetRequest,
                            exclude: Optional[set] = None
                            ) -> Optional[Replica]:
        """Best decode-capable replica for a KV transfer: longest cached
        chain (it may already hold the prefix), then least load."""
        scored = []
        for rep in list(self.replicas.values()):
            if exclude and rep.rid in exclude:
                continue
            if not self.routable(rep) or not self._role_ok(rep, "decode"):
                continue
            scored.append((-rep.affinity(freq.prompt), rep.load(),
                           rep.rid, rep))
        scored.sort(key=lambda t: t[:3])
        return scored[0][3] if scored else None

    def _stream_kv(self, freq: FleetRequest, src: Replica,
                   dst: Replica, kind: str) -> Optional[dict]:
        """Ship `freq`'s resident prompt blocks src -> dst over the
        chain-hash wire. Best-effort: a failed transfer only costs the
        prefix hit (the decode replica re-prefils), never the request.
        The stats carry each half's seconds (`export_s`, `ingest_s`)."""
        try:
            t0 = time.perf_counter()
            recs = src.engine.export_kv_blocks(freq.prompt)
            if not recs:
                return None
            t1 = time.perf_counter()
            stats = dst.engine.ingest_kv_blocks(recs)
            t2 = time.perf_counter()
        except Exception:  # noqa: BLE001 — replica died mid-transfer
            return None
        stats = dict(stats, src=src.rid, dst=dst.rid, kind=kind,
                     export_s=t1 - t0, ingest_s=t2 - t1)
        freq.kv_streamed = stats
        self.obs.on_kv_transfer(freq, src.rid, dst.rid, stats, kind=kind)
        return stats

    def _advance_disagg(self, freq: FleetRequest, att: _Attempt,
                        reason: str) -> None:
        """Stage 2: the prefill-only attempt finished. Stream its KV
        blocks to the best decode replica, then place the decode attempt
        — preferring the transfer target, though affinity would find it
        anyway (the streamed chain IS the prefix-cache content the
        ranking probes). On a failed prefill (cancel/error) this is a
        plain decode placement: full prefill on the decode replica."""
        prefer = None
        try:
            if reason == "prefill_complete":
                target = self._pick_decode_target(freq,
                                                  exclude={att.replica.rid})
                if target is not None:
                    self._stream_kv(freq, att.replica, target, "prefill")
                    prefer = target.rid
            att2, _ = self._place(freq, "decode", prefer=prefer)
        finally:
            # another thread's poll may now re-dispatch or hedge it
            freq._advancing = False
        if att2 is None and freq._orphan_ns is None:
            # decode pool full/dead this pass: the next poll's orphan
            # re-dispatch keeps retrying — accepted requests never drop
            freq._orphan_ns = time.monotonic_ns()

    def _redispatch_if_orphaned(self, freq: FleetRequest):
        """Requests in flight on a dead replica are resubmitted (same id,
        full prompt) onto the best survivor; the dead attempt's partial
        output is discarded. Greedy decode is deterministic, so the
        survivor's output is bitwise what the dead replica would have
        produced."""
        dead = []
        with freq._lock:
            if freq._advancing:
                # between a finished prefill and its decode placement (in
                # another thread): not an orphan. The reference re-dispatches
                # here too, a full prefill on a decode replica beside the
                # decode attempt the handoff then places
                return
            for att in freq.attempts:
                if not att.failed and self.replica_dead(att.replica):
                    att.failed = True
                    dead.append(att)
            tried = {a.replica.rid for a in freq.attempts}
            needs_new = not any(not a.failed for a in freq.attempts)
        for att in dead:
            # bookkeeping on the dead engine is still consistent (its
            # loop died, not the object): free the slot + reservation
            toks_lost = 0
            try:
                toks, _s, _r = att.replica.engine.snapshot_output(att.req)
                toks_lost = len(toks)
                att.replica.engine.cancel(att.req, "replica_dead")
            except Exception:  # noqa: BLE001 — dead replica, best effort
                pass
            self.obs.on_cancelled(freq, att, toks_lost, "replica_dead")
        if not needs_new:
            return
        if dead and freq._orphan_ns is None:
            # queue-at-router span anchor: orphan detected, not yet
            # re-placed (cleared by _place on success)
            freq._orphan_ns = time.monotonic_ns()
        # prefer a replica this request has not touched, but fall back
        # to retrying anywhere rather than dropping an accepted request
        fresh = any(self.routable(r) and r.rid not in tried
                    for r in list(self.replicas.values()))
        att, _ = self._place(freq, "redispatch",
                             exclude=tried if fresh else None)
        if att is not None:
            with freq._lock:
                freq.redispatches += 1
            _REDISPATCHED.inc()
        # else: nowhere to go this pass (everyone full/dead) — the next
        # poll retries; accepted requests are never dropped

    def _resolve_hedge(self, freq: FleetRequest):
        """First token wins: as soon as exactly one live attempt has
        produced output, cancel the rest (don't wait for the finish)."""
        if not freq.hedged:
            return
        with freq._lock:
            live = [a for a in freq.attempts if not a.failed]
            if len(live) < 2:
                return
            holders = []
            for att in live:
                toks, _state, _reason = \
                    att.replica.engine.snapshot_output(att.req)
                if toks:
                    holders.append(att)
            if not holders:
                return
            winner = holders[0]
            if freq.first_token_ts is None \
                    and winner.req.first_token_time is not None:
                freq.first_token_ts = winner.req.first_token_time
            losers = [a for a in live if a is not winner]
            for a in losers:
                a.failed = True
        self.obs.on_hedge_win(freq, winner)
        for a in losers:
            toks_lost, _s, _r = a.replica.engine.snapshot_output(a.req)
            a.replica.engine.cancel(a.req, "hedge_lost")
            self.obs.on_cancelled(freq, a, len(toks_lost), "hedge_lost")

    def _maybe_hedge(self, freq: FleetRequest, now: float):
        if self.hedge_ttft_s <= 0 or freq.hedged or freq._advancing:
            return
        if now - freq.submit_ts < self.hedge_ttft_s:
            return
        with freq._lock:
            live = [a for a in freq.attempts if not a.failed]
            hosting = {a.replica.rid for a in live}
        if any(a.kind == "prefill" for a in live):
            return          # still in the prefill stage: nothing to hedge
        for att in live:
            toks, _state, _reason = \
                att.replica.engine.snapshot_output(att.req)
            if toks:
                return                  # first token already arrived
        att, _ = self._place(freq, "hedge", exclude=hosting)
        if att is not None:
            with freq._lock:
                freq.hedged = True
            _HEDGED.inc()

    # -- drain / chaos -----------------------------------------------------
    def drain(self, rid: str, migrate: Optional[bool] = None):
        """Rolling-restart drain: stop routing to `rid`, stop its engine
        admitting. With `migrate` (default FLAGS_fleet_drain_migrate,
        off) in-flight sessions live-migrate to a survivor — their
        resident prompt KV blocks stream over the chain-hash wire and
        the attempts re-place there, so the survivor re-decodes (greedy:
        bitwise identical) without re-prefilling any already-full block.
        Without it they finish in place."""
        with self._lock:
            rep = self.replicas[rid]
            rep.draining = True
            rep.engine.drain()
        if (bool(_flags.get_flag("fleet_drain_migrate"))
                if migrate is None else bool(migrate)):
            self.migrate_from(rid)

    def migrate_from(self, rid: str) -> int:
        """Live KV migration: for every in-flight attempt on `rid`, ship
        the session's resident prompt blocks to the best survivor,
        cancel the attempt locally and re-place it pinned to the
        survivor. Returns how many attempts moved; sessions with no
        routable survivor stay and finish on the draining replica."""
        rep = self.replicas[rid]
        with self._lock:
            pending = list(self._inflight.values())
        moved = 0
        for freq in pending:
            with freq._lock:
                if freq._settled:
                    continue
                atts = [a for a in freq.attempts
                        if not a.failed and a.replica is rep]
            for att in atts:
                target = self._pick_decode_target(freq, exclude={rid})
                if target is None:
                    break
                stats = self._stream_kv(freq, rep, target, "migrate")
                with freq._lock:
                    if att.failed or freq._settled:
                        continue
                # place the survivor attempt BEFORE failing the old one:
                # the poll thread re-dispatches any request whose attempts
                # are all failed, and would race in a duplicate decode
                new_att, _qf = self._place(freq, "migrate",
                                           prefer=target.rid)
                if new_att is None:
                    continue    # no capacity — finish on the drainer
                with freq._lock:
                    if freq._settled:
                        continue
                    att.failed = True
                    freq.migrations += 1
                toks_lost = 0
                try:
                    toks, _s, _r = rep.engine.snapshot_output(att.req)
                    toks_lost = len(toks)
                    rep.engine.cancel(att.req, "migrated")
                except Exception:  # noqa: BLE001 — dying replica
                    pass
                self.obs.on_cancelled(freq, att, toks_lost, "migrated")
                self.obs.on_migrate(freq, rid, target.rid, stats)
                moved += 1
        return moved

    def resume(self, rid: str):
        with self._lock:
            rep = self.replicas[rid]
            rep.engine.resume()
            rep.draining = False

    def drained(self, rid: str) -> bool:
        return self.replicas[rid].engine.drained()

    def kill_replica(self, rid: str):
        """Chaos hook (tests / servebench): crash one replica."""
        self.replicas[rid].kill()

    # -- elastic fleet membership ------------------------------------------
    def add_replica(self, engine: Optional[ServingEngine] = None, *,
                    spec=None, role: str = "any") -> str:
        """Scale-up: join a new replica, a thread over `engine` or a
        supervised process from `spec` (a ProcessReplicaSpec, unroutable
        while it warms up). Started immediately when the router is
        running."""
        if (engine is None) == (spec is None):
            raise ValueError("add_replica wants exactly one of engine= "
                             "or spec=")
        if role not in _ROLES:
            raise ValueError(f"unknown fleet role {role!r}")
        max_errors, cooldown = self._breaker_cfg
        with self._lock:
            rid = f"replica-{self._next_rid}"
            self._next_rid += 1
            breaker = CircuitBreaker(max_errors, cooldown,
                                     clock=self._clock)
            if engine is not None:
                rep = Replica(rid, engine, registry=self.registry,
                              heartbeat_s=self._heartbeat_s,
                              breaker=breaker, clock=self._clock,
                              idle_sleep_s=self._idle_sleep_s)
                meta = {"slots": engine.max_slots,
                        "blocks": engine.num_blocks}
            else:
                rep = spec.build(rid, registry=self.registry,
                                 heartbeat_s=self._heartbeat_s,
                                 breaker=breaker, clock=self._clock,
                                 idle_sleep_s=self._idle_sleep_s)
                meta = {"kind": "process"}
            rep.role = role
            self.replicas[rid] = rep
            self._breaker_seen[rid] = "closed"
            self.registry.register(rid, meta=meta)
            started = self._started
            n = len(self.replicas)
        if started:
            rep.start()
        self.obs.on_scale("up", rid, role=role, replicas=n)
        return rid

    def remove_replica(self, rid: str) -> bool:
        """Scale-down (after a drain — ideally migration-assisted — ran
        the replica dry): detach and stop it. In-flight attempts still
        referencing it settle normally; its health gauge drops to 0."""
        with self._lock:
            rep = self.replicas.pop(rid, None)
            self._breaker_seen.pop(rid, None)
            n = len(self.replicas)
        if rep is None:
            return False
        _REPLICA_UP.set(0.0, replica=rid)
        try:
            rep.stop()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        self.obs.on_scale("down", rid, role=rep.role, replicas=n)
        return True

    def attach_autoscaler(self, scaler) -> None:
        """Tick `scaler` from every poll (FleetAutoscaler or anything
        with .tick())."""
        self.autoscaler = scaler

    # -- introspection -----------------------------------------------------
    def inflight(self) -> int:
        with self._lock:
            return len(self._inflight)

    def health(self) -> dict:
        """Fleet /healthz body: ok while at least one replica can take
        traffic; per-replica engine snapshots say why not. The whole
        body is assembled under the router lock so the router-level
        fields (inflight, draining, breaker) and every replica snapshot
        come from ONE instant — no replica can die or settle between
        rows of the same response."""
        with self._lock:
            out: Dict[str, dict] = {}
            ok_any = False
            for rid, rep in self.replicas.items():
                dead = self.replica_dead(rep)
                snap = rep.engine.obs.health_snapshot(
                    loop_alive=rep.loop_alive() and not dead)
                snap["breaker"] = rep.breaker.state
                snap["dead"] = dead
                snap["draining"] = rep.draining
                snap["warming"] = rep.warming()
                if snap["warming"]:
                    # an incarnation still starting: not a fault
                    snap["status"] = "warming"
                snap["incarnation"] = rep.incarnation
                snap["pid"] = rep.pid
                snap["respawns"] = rep.respawns
                snap["last_exit"] = rep.last_exit
                out[rid] = snap
                if self.routable(rep):
                    ok_any = True
            return {"ok": ok_any, "inflight": len(self._inflight),
                    "replicas": out}

    def stats(self) -> dict:
        """One consistent router + per-replica snapshot (same locking
        contract as health())."""
        with self._lock:
            reps: Dict[str, dict] = {}
            for rid, rep in self.replicas.items():
                s = rep.engine.stats()
                s["breaker"] = rep.breaker.state
                s["draining"] = rep.draining
                s["dead"] = self.replica_dead(rep)
                s["warming"] = rep.warming()
                s["incarnation"] = rep.incarnation
                s["pid"] = rep.pid
                s["respawns"] = rep.respawns
                s["last_exit"] = rep.last_exit
                reps[rid] = s
            return {"inflight": len(self._inflight), "replicas": reps}


class FleetAutoscaler:
    """Elastic replica-count control over one role pool of a FleetRouter.

    Ticked from every router poll (attach_autoscaler). Utilization is
    offered load over slot capacity across the pool's live replicas;
    crossing `hi` spawns one replica (the `spawn` callback returns a
    ServingEngine for a thread replica or a ProcessReplicaSpec for a
    supervised process, unroutable until warm, whose slots count from
    its spawn on), crossing `lo` retires the least-loaded
    one through a migration-assisted drain followed by remove_replica
    once it runs dry. One action per cooldown window; floor/ceiling
    bound the pool. All timing runs on the router's clock, so
    virtual-time benches drive it deterministically."""

    def __init__(self, router: FleetRouter, spawn, *, role: str = "any",
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 hi: Optional[float] = None, lo: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 slots_per_replica: int = 8):
        self.router = router
        self.spawn = spawn
        self.role = str(role)
        self.min_replicas = int(_flags.get_flag("fleet_scale_min")
                                if min_replicas is None else min_replicas)
        self.max_replicas = int(_flags.get_flag("fleet_scale_max")
                                if max_replicas is None else max_replicas)
        self.hi = float(_flags.get_flag("fleet_scale_hi")
                        if hi is None else hi)
        self.lo = float(_flags.get_flag("fleet_scale_lo")
                        if lo is None else lo)
        self.cooldown_s = float(_flags.get_flag("fleet_scale_cooldown_s")
                                if cooldown_s is None else cooldown_s)
        if not (0.0 <= self.lo < self.hi):
            raise ValueError(f"need 0 <= lo < hi, got lo={self.lo} "
                             f"hi={self.hi}")
        self.slots_per_replica = int(slots_per_replica)
        self.last_utilization: Optional[float] = None
        self.events: List[dict] = []    # {ts, dir, replica, utilization}
        self._retiring: Optional[str] = None
        self._last_action = -float("inf")

    def _slots(self, rep: Replica) -> int:
        return int(getattr(rep.engine, "max_slots", 0)
                   or self.slots_per_replica)

    def _pool(self) -> List[Replica]:
        # a warming replica (a process incarnation starting up) counts:
        # the reference leaves it out, so its autoscaler spawns again
        # every cooldown until the first one is up
        return [rep for rep in self.router.replicas.values()
                if rep.role == self.role
                and not rep.draining
                and (rep.warming() or not self.router.replica_dead(rep))]

    def utilization(self) -> float:
        pool = self._pool()
        cap = sum(self._slots(r) for r in pool)
        if cap <= 0:
            return float("inf")
        return sum(r.load() for r in pool) / cap

    def tick(self) -> Optional[str]:
        """One control turn; returns "up"/"down" when an action fired.
        A pending retirement completes (drained -> removed) before any
        new decision — at most one membership change is ever in flight."""
        now = self.router._clock()
        if self._retiring is not None:
            rid = self._retiring
            if rid not in self.router.replicas:
                self._retiring = None
            else:
                try:
                    dry = self.router.drained(rid)
                except Exception:  # noqa: BLE001 — replica died draining
                    dry = True
                if dry:
                    self.router.remove_replica(rid)
                    self._retiring = None
            return None
        u = self.utilization()
        self.last_utilization = u
        if now - self._last_action < self.cooldown_s:
            return None
        pool = self._pool()
        if u >= self.hi and len(pool) < self.max_replicas:
            new = self.spawn()
            kw = ({"spec": new} if hasattr(new, "build") else
                  {"engine": new})
            rid = self.router.add_replica(role=self.role, **kw)
            self._last_action = now
            self.events.append({"ts": now, "dir": "up", "replica": rid,
                                "utilization": round(u, 4),
                                "replicas": len(pool) + 1})
            return "up"
        # only a replica that is up may be retired, and only while enough
        # others are up (a warming one serves nothing yet)
        up = [rep for rep in pool if not rep.warming()]
        if u <= self.lo and len(up) > self.min_replicas:
            victim = min(up, key=lambda r: (r.load(), r.rid))
            self.router.drain(victim.rid, migrate=True)
            self._retiring = victim.rid
            self._last_action = now
            self.events.append({"ts": now, "dir": "down",
                                "replica": victim.rid,
                                "utilization": round(u, 4),
                                "replicas": len(pool) - 1})
            return "down"
        return None


def build_fleet(model_factory, n_replicas: Optional[int] = None, *,
                router_kwargs: Optional[dict] = None,
                **engine_kwargs) -> FleetRouter:
    """Build N independent replicas (each its OWN model instance from
    `model_factory` — no shared mutable state between replica threads;
    seed the factory identically for bitwise-interchangeable replicas)
    and a router over them."""
    n = int(_flags.get_flag("fleet_replicas")
            if n_replicas is None else n_replicas)
    engines = [ServingEngine(model_factory(), **engine_kwargs)
               for _ in range(n)]
    return FleetRouter(engines, **(router_kwargs or {}))
