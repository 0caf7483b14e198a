"""Fleet replicas in processes of their own, under a supervisor
(counterpart of paddle_tpu/serving/fleet_proc.py).

A thread replica (serving/fleet.py) can only simulate a fault: kill() is a
flag, and a "dead" replica's objects stay reachable. Here a replica is a
real OS process, supervised as an agent supervises a pod:

  * ProcessReplica launches ``python -m paddle_tpu_torch.serving.fleet_proc``
    as a child. The child builds its model from a ``module:function``
    factory (which also picks its device: the CUDA card, or the CPU when
    the factory asks for it), runs its own ServingEngine behind a
    ServingServer on an ephemeral port, prints ONE ready line
    ``{"ready": true, "port": P, "pid": Q, ...}`` and heartbeats a lease
    of its incarnation into the shared store (native.TCPStore). Each child
    has a CUDA context, caching allocator and graphs of its own; without
    MPS the card time-slices between contexts.
  * The router speaks to the child over its HTTP surface: _RemoteEngine
    and _RemoteRequest stand in for the ServingEngine and Request
    attributes FleetRouter and fleet_observability touch, so a process
    replica rides the same placement path as a thread (a re-dispatch
    replays the whole prompt on a survivor: bitwise for greedy decode).
  * Death is detected two ways, for two kinds of fault: the exit code
    (SIGKILL, OOM, a bug) and the lease's expiry (SIGSTOP, a network
    partition). A silent child that is still alive gets a heal grace: a
    partition that heals before the respawn deadline revives the
    incarnation with no respawn and no fence bump.
  * A respawn is paced by resilience/retry.RetryPolicy (capped
    exponential backoff, jitter, FLAGS_fleet_respawn_max attempts), and a
    new incarnation is ``warming`` (unroutable, not dead) until its own
    /healthz says ok.
  * Every incarnation carries a fence token, a store counter bumped
    before each spawn. The child reads the counter before every heartbeat
    and exits with FENCED_EXIT the moment it is superseded, so a
    SIGSTOP'd zombie that wakes after its replacement spawned never serves.

ProcessReplica.supervise() holds the supervisor's state machine and runs
from every FleetRouter.poll(): the router stays the one supervision loop
for threads and processes alike.

The port's own additions: `ProcessReplicaSpec(log_dir=)` sends each
child's stderr to a file (the reference discards it), and
`ProcessReplica.spawns` records each incarnation's start-up seconds
(the child's import, weights and engine construction, its ready line, the
warm-up probe).
"""
from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional, Tuple

from ..core import flags as _flags
from ..observability.registry import counter as _counter
from ..resilience.retry import RetryPolicy
from .engine import EngineDrainingError, QueueFullError
from .fleet import Replica

_flags.define_flag("fleet_respawn_max", 3,
                   "Respawn attempts per process replica before the "
                   "supervisor gives up and leaves it dead (the initial "
                   "spawn is not counted).")
_flags.define_flag("fleet_respawn_backoff_s", 0.5,
                   "Base respawn backoff in seconds; actual delays follow "
                   "the shared RetryPolicy schedule (exponential, capped "
                   "at 8x base, jittered). Doubles as the heal-grace "
                   "window for a silent-but-alive child.")
_flags.define_flag("fleet_warmup_timeout_s", 60.0,
                   "Seconds a spawned replica incarnation gets to print "
                   "its ready line AND pass the /healthz warm-up probe "
                   "before the supervisor kills it and tries again.")

_RESPAWNS = _counter("fleet_replica_respawns_total",
                     "Process-replica incarnations respawned by the "
                     "supervisor, per replica id.",
                     labelnames=("replica",), always=True)
_FENCED = _counter("fleet_replica_fenced_total",
                   "Zombie incarnations that self-fenced (woke up already "
                   "superseded and exited rather than serve stale state).",
                   always=True)

# the child's self-fence exit code: told apart from crashes in last_exit
FENCED_EXIT = 43

CHILD_MODULE = "paddle_tpu_torch.serving.fleet_proc"
DEMO_FACTORY = CHILD_MODULE + ":demo_model"

_remote_lock = threading.Lock()
_remote_counter = 0


def _next_remote_id() -> str:
    global _remote_counter
    with _remote_lock:
        _remote_counter += 1
        return f"proc-{_remote_counter}"


def demo_model():
    """Seeded tiny-GPT factory for process replicas (the child imports it
    as ``paddle_tpu_torch.serving.fleet_proc:demo_model``). It builds on
    the CUDA card and raises without one. Every incarnation and every
    replica gets the same weights, the property re-dispatch parity rests
    on."""
    from ..models import GPTConfig, GPTForCausalLM

    m = GPTForCausalLM(GPTConfig.tiny(), seed=11)
    m.eval()
    return m


# ---------------------------------------------------------------------------
# remote engine: the router-facing stand-in over the child's HTTP surface
# ---------------------------------------------------------------------------

class _RemoteRequest:
    """The client side of one generation request running in the child. It
    carries the serving.scheduler.Request attributes the router and
    fleet_observability touch: identity, token and state snapshots,
    lifecycle timestamps (this process's monotonic clock) and telemetry
    (the child's own block comes back on the stream's last line)."""

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 temperature: float, eos_token_id, request_id: Optional[str],
                 tier: str, trace_ctx: Optional[dict]):
        self.request_id = request_id or _next_remote_id()
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.tier = str(tier) if tier else "default"
        self.trace = None               # engine-side spans stay in the child
        self.trace_ctx = dict(trace_ctx) if trace_ctx else None
        self.state = "queued"
        self.finish_reason: Optional[str] = None
        self.output_tokens: List[int] = []
        self.prefix_matched = 0
        self.arrival_time = time.monotonic()
        self.prefill_start: Optional[float] = None
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self._remote_telemetry: Optional[dict] = None
        self._cancelled = False
        self._sock = None               # the live stream's socket
        self._lock = threading.Lock()
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def queue_seconds(self) -> Optional[float]:
        if self.prefill_start is None:
            return None
        return self.prefill_start - self.arrival_time

    def ttft_seconds(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def decode_tokens_per_s(self) -> Optional[float]:
        if self.finish_time is None or self.first_token_time is None:
            return None
        n = len(self.output_tokens)
        dt = self.finish_time - self.first_token_time
        return (n - 1) / dt if n > 1 and dt > 0 else None

    def telemetry(self) -> dict:
        with self._lock:
            remote = dict(self._remote_telemetry or {})
        t = {
            "request_id": self.request_id,
            "tier": self.tier,
            "state": self.state,
            "finish_reason": self.finish_reason,
            "prompt_tokens": len(self.prompt),
            "prefix_matched_tokens": self.prefix_matched,
            "output_tokens": len(self.output_tokens),
            "queue_s": self.queue_seconds(),
            "ttft_s": self.ttft_seconds(),
            "decode_tok_s": self.decode_tokens_per_s(),
        }
        # the child's telemetry is the engine's view (its queue and
        # prefix numbers); the router-side identity fields stay
        for k, v in remote.items():
            if k not in ("request_id", "tier", "state", "finish_reason"):
                t[k] = v
        return t


class _RemoteObs:
    """`engine.obs` stand-in: health_snapshot proxies the child's
    /healthz."""

    def __init__(self, engine: "_RemoteEngine"):
        self._engine = engine

    def health_snapshot(self, loop_alive: bool = True) -> dict:
        snap = self._engine._get_json("/healthz", ok_codes=(200, 503))
        if snap is None:
            snap = {"ok": False, "status": "unreachable"}
        snap["loop_alive"] = bool(loop_alive) and bool(snap.get("ok"))
        snap["remote"] = True
        return snap


class _RemoteEngine:
    """The ServingEngine surface the router uses, over one child
    incarnation's HTTP endpoints. submit() opens a streamed POST
    /generate and a daemon reader thread feeds the _RemoteRequest;
    cancel() severs the stream socket, which the child's server turns
    into an engine-side cancel (slot and KV reservation freed). One
    _RemoteEngine per incarnation: after a respawn the replica swaps in a
    fresh one, and requests still bound to the dead incarnation fail and
    re-dispatch."""

    _HTTP_TIMEOUT_S = 5.0

    def __init__(self, base_url: Optional[str]):
        self.base_url = base_url        # None: incarnation not up yet
        self.obs = _RemoteObs(self)
        self._draining = False
        self._inflight = 0
        self._lock = threading.Lock()

    # -- shared HTTP helpers ------------------------------------------------
    def _get_json(self, path: str, ok_codes=(200,),
                  timeout: Optional[float] = None) -> Optional[dict]:
        if self.base_url is None:
            return None
        try:
            with urllib.request.urlopen(
                    self.base_url + path,
                    timeout=timeout or self._HTTP_TIMEOUT_S) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if e.code in ok_codes:
                try:
                    return json.loads(e.read().decode())
                except Exception:  # noqa: BLE001 — torn body
                    return None
            return None
        except Exception:  # noqa: BLE001 — dead or frozen child
            return None

    # -- engine surface used by the router ----------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0, eos_token_id=None,
               request_id: Optional[str] = None, tier: str = "default",
               trace_ctx: Optional[dict] = None,
               prefill_only: bool = False) -> _RemoteRequest:
        if self.base_url is None:
            raise RuntimeError("replica incarnation not ready")
        if self._draining:
            raise EngineDrainingError()
        req = _RemoteRequest(prompt, max_new_tokens, temperature,
                             eos_token_id, request_id, tier, trace_ctx)
        body = json.dumps({
            "prompt": req.prompt, "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature, "eos_token_id": req.eos_token_id,
            "tier": req.tier, "stream": True,
            "prefill_only": bool(prefill_only),
        }).encode()
        url = urllib.parse.urlsplit(self.base_url)
        conn = http.client.HTTPConnection(url.hostname, url.port,
                                          timeout=self._HTTP_TIMEOUT_S)
        try:
            conn.request("POST", "/generate", body=body,
                         headers={"Content-Type": "application/json"})
            sock = conn.sock
            resp = conn.getresponse()
            if resp.status != 200:
                try:
                    detail = json.loads(resp.read().decode())
                except Exception:  # noqa: BLE001
                    detail = {}
                conn.close()
                if resp.status == 503:
                    raise QueueFullError(int(detail.get("queue_depth", 0)),
                                         int(detail.get("queue_limit", 0)))
                if resp.status == 400:
                    raise ValueError(detail.get("error", "bad request"))
                raise RuntimeError(f"remote submit: HTTP {resp.status}")
            # the headers came within the timeout; the body may then be
            # silent for as long as the request runs (a greedy request's
            # tokens come at its end): a frozen child is the lease's to
            # find, and cancel() wakes this reader
            sock.settimeout(None)
        except OSError as e:
            conn.close()
            # a child that died between placement and submit: a replica
            # fault, which the router's _place turns into the next
            # candidate (or a re-dispatch), never a caller-visible error
            raise RuntimeError(f"remote submit failed: {e}")
        req._sock = sock
        req.state = "running"
        req.prefill_start = time.monotonic()
        with self._lock:
            self._inflight += 1
        threading.Thread(target=self._consume, args=(req, resp),
                         name="fleet-proc-stream", daemon=True).start()
        return req

    def _consume(self, req: _RemoteRequest, resp) -> None:
        """Reader thread: one NDJSON line per flush of the child. Any
        transport fault finishes the request with a reason that is not a
        good one, which the router's settle pass turns into a failed
        attempt, so the request re-dispatches even when the replica
        itself looks alive (the child restarted between placement and
        finish)."""
        reason = "error"
        telemetry = None
        try:
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                msg = json.loads(line.decode())
                with req._lock:
                    toks = msg.get("tokens")
                    if toks:
                        if req.first_token_time is None:
                            req.first_token_time = time.monotonic()
                        req.output_tokens.extend(int(t) for t in toks)
                    if msg.get("done"):
                        reason = msg.get("finish_reason") or "stop"
                        telemetry = msg.get("telemetry")
                        break
        except Exception:  # noqa: BLE001 — severed stream
            pass
        finally:
            try:
                resp.close()
                if req._sock is not None:
                    req._sock.close()
            except Exception:  # noqa: BLE001
                pass
            with self._lock:
                self._inflight = max(0, self._inflight - 1)
            with req._lock:
                if req._cancelled and reason == "error":
                    reason = "cancelled"
                if req.finish_reason is None:
                    req.finish_reason = reason
                if telemetry:
                    req._remote_telemetry = telemetry
                    req.prefix_matched = int(
                        telemetry.get("prefix_matched_tokens") or 0)
                    # the child's first token on this process's clock (its
                    # arrival is the stream's start): a deferred greedy
                    # stream delivers every token at its end
                    ttft = telemetry.get("ttft_s")
                    if ttft is not None and req.prefill_start is not None:
                        req.first_token_time = min(
                            req.first_token_time or float("inf"),
                            req.prefill_start + float(ttft))
                req.state = "finished"
                req.finish_time = time.monotonic()
            req._done.set()

    def snapshot_output(self, req: _RemoteRequest
                        ) -> Tuple[List[int], str, Optional[str]]:
        with req._lock:
            return list(req.output_tokens), req.state, req.finish_reason

    def cancel(self, req: _RemoteRequest, reason: str = "cancelled") -> bool:
        with req._lock:
            if req.state == "finished":
                return False
            req._cancelled = True
            req.finish_reason = reason
            sock = req._sock
        # severing the stream socket is the cancel signal: the child's
        # handler sees the connection closed and cancels the request; the
        # shutdown also ends this side's blocked read at once
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        return True

    def drain(self) -> None:
        self._draining = True

    def resume(self) -> None:
        self._draining = False

    def drained(self) -> bool:
        with self._lock:
            return self._draining and self._inflight == 0

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def stats(self) -> dict:
        s = self._get_json("/stats", timeout=2.0)
        if s is None:
            return {"remote": True, "unreachable": True}
        s["remote"] = True
        return s

    # -- the KV-block wire (disaggregation, live migration) -----------------
    def export_kv_blocks(self, tokens: List[int]) -> List[dict]:
        """POST /kv/export on the child, decoded to the records
        ServingEngine.export_kv_blocks returns. A dead or frozen child
        exports nothing (the receiver prefills instead)."""
        if self.base_url is None:
            return []
        from .server import kv_wire_decode

        body = json.dumps({"tokens": [int(t) for t in tokens]}).encode()
        http_req = urllib.request.Request(
            self.base_url + "/kv/export", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    http_req, timeout=self._HTTP_TIMEOUT_S) as resp:
                return kv_wire_decode(resp.read())
        except Exception:  # noqa: BLE001 — unreachable child
            return []

    def ingest_kv_blocks(self, records: List[dict]) -> dict:
        """POST /kv/ingest on the child; raises for an unreachable child,
        so the router's transfer falls back to a plain prefill."""
        if self.base_url is None:
            raise RuntimeError("replica incarnation not ready")
        from .server import kv_wire_encode

        http_req = urllib.request.Request(
            self.base_url + "/kv/ingest", data=kv_wire_encode(records),
            headers={"Content-Type": "application/x-ndjson"})
        with urllib.request.urlopen(
                http_req, timeout=self._HTTP_TIMEOUT_S) as resp:
            return json.loads(resp.read().decode())


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------

class ProcessReplicaSpec:
    """What FleetRouter turns into a ProcessReplica (the router passes the
    registry, breaker and clock; the spec carries everything of the
    process). `child_store_addr` lets a chaos test route the CHILD's store
    client through a StorePartitionProxy while the supervisor keeps its
    direct connection. `extra_env` joins the child's environment;
    `log_dir`, when set, receives each incarnation's stderr as
    `<replica>-<fence>.log` (otherwise it is discarded)."""

    def __init__(self, store_addr: Tuple[str, int], *,
                 factory: str = DEMO_FACTORY,
                 engine_kwargs: Optional[dict] = None,
                 child_store_addr: Optional[Tuple[str, int]] = None,
                 child_heartbeat_s: float = 0.2,
                 warmup_timeout_s: Optional[float] = None,
                 respawn_max: Optional[int] = None,
                 respawn_backoff_s: Optional[float] = None,
                 python: str = sys.executable,
                 extra_env: Optional[dict] = None,
                 log_dir: Optional[str] = None):
        self.store_addr = (str(store_addr[0]), int(store_addr[1]))
        self.child_store_addr = (tuple(child_store_addr)
                                 if child_store_addr else self.store_addr)
        self.factory = str(factory)
        self.engine_kwargs = dict(engine_kwargs or {})
        self.child_heartbeat_s = float(child_heartbeat_s)
        self.warmup_timeout_s = float(
            _flags.get_flag("fleet_warmup_timeout_s")
            if warmup_timeout_s is None else warmup_timeout_s)
        self.respawn_max = int(_flags.get_flag("fleet_respawn_max")
                               if respawn_max is None else respawn_max)
        self.respawn_backoff_s = float(
            _flags.get_flag("fleet_respawn_backoff_s")
            if respawn_backoff_s is None else respawn_backoff_s)
        self.python = str(python)
        self.extra_env = dict(extra_env or {})
        self.log_dir = log_dir

    def build(self, rid: str, *, registry, heartbeat_s: float, breaker,
              clock=time.monotonic, idle_sleep_s: float = 0.002
              ) -> "ProcessReplica":
        return ProcessReplica(rid, self, registry=registry,
                              heartbeat_s=heartbeat_s, breaker=breaker,
                              clock=clock, idle_sleep_s=idle_sleep_s)


class ProcessReplica(Replica):
    """A fleet replica whose engine lives in a supervised subprocess.

    Lifecycle (every transition happens in supervise(), which the router
    calls each poll; a spawn runs in a daemon thread, since a child's
    start-up takes seconds and must not stall the monitor):

        spawning -> warming -> ready --(exit / lease death)--> suspect
          ^                                   |                   |
          |                          heal grace (alive and        |
          |                          lease revived: ready,        |
          |                          NO respawn or fence bump)    |
          +--- backoff deadline, fence bump, respawn <------------+

    ``kill()`` SIGKILLs the child (a real crash; the supervisor respawns
    it); ``retire()`` is the thread replica's "dead for good"."""

    def __init__(self, rid: str, spec: ProcessReplicaSpec, *, registry,
                 heartbeat_s: float, breaker, clock=time.monotonic,
                 idle_sleep_s: float = 0.002):
        super().__init__(rid, _RemoteEngine(None), registry=registry,
                         heartbeat_s=heartbeat_s, breaker=breaker,
                         clock=clock, idle_sleep_s=idle_sleep_s)
        self.spec = spec
        self.pid = None                 # the child's pid once ready
        # one record an incarnation that came up: its start-up seconds
        self.spawns: List[dict] = []
        self._proc: Optional[subprocess.Popen] = None
        self._spawn_proc: Optional[subprocess.Popen] = None  # starting up
        self._ready = False
        self._stopped = False
        self._exhausted = False
        self._spawning = False
        self._spawn_thread: Optional[threading.Thread] = None
        self._next_spawn_at: Optional[float] = 0.0   # spawn at once
        self._suspect_deadline: Optional[float] = None
        self._zombies: List[subprocess.Popen] = []   # orphaned incarnations
        self._sup_lock = threading.RLock()
        self._backoff = RetryPolicy(
            base_delay=spec.respawn_backoff_s,
            max_delay=spec.respawn_backoff_s * 8.0,
            multiplier=2.0, jitter=0.5, name=f"respawn-{rid}")

    # -- identity -----------------------------------------------------------
    def _lease_id(self) -> str:
        """The incarnation's lease: a zombie beating its OLD lease never
        refreshes the CURRENT incarnation's liveness."""
        return f"{self.rid}@{self.incarnation}"

    def _fence_key(self) -> str:
        return f"{self.registry.prefix}/fence/{self.rid}"

    # -- Replica surface -----------------------------------------------------
    def start(self):
        # the spawn is asynchronous; the replica stays `warming` until the
        # warm-up probe passes
        with self._sup_lock:
            if self._stopped or self._proc is not None or self._spawning:
                return
            self._begin_spawn()

    def stop(self):
        with self._sup_lock:
            self._stopped = True
            procs = [p for p in [self._proc, self._spawn_proc]
                     + self._zombies if p is not None]
            self._proc = None
            self._zombies = []
            spawner = self._spawn_thread
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + 5.0
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except (subprocess.TimeoutExpired, OSError):
                # a SIGSTOP'd child keeps SIGTERM pending until woken
                self._reap(p)
        if spawner is not None:
            # its child is gone, so the spawn thread ends at once
            spawner.join(timeout=10.0)

    def kill(self):
        """Chaos hook: SIGKILL the live incarnation. Unlike a thread
        replica's this is not terminal: the supervisor sees the exit and
        respawns under backoff."""
        with self._sup_lock:
            proc = self._proc
        if proc is not None:
            try:
                os.kill(proc.pid, signal.SIGKILL)
            except OSError:
                pass

    def retire(self):
        """Terminal kill: the thread replica's kill() (dead for good, no
        respawn)."""
        self._killed = True
        self.stop()

    def children(self) -> List[int]:
        """Pids of every process this replica started that may still run
        (the incarnation, a spawn in flight's child, orphaned zombies)."""
        with self._sup_lock:
            procs = [self._proc, self._spawn_proc] + self._zombies
        return [p.pid for p in procs if p is not None and p.poll() is None]

    def loop_alive(self) -> bool:
        with self._sup_lock:
            return (self._proc is not None and self._proc.poll() is None
                    and self._ready)

    def pause(self):
        raise NotImplementedError(
            "use resilience.chaos.hang_process(replica.pid) for process "
            "replicas")

    def dead(self, lease_ttl_s: float) -> bool:
        if self._killed or self._stopped or self._exhausted:
            return True
        with self._sup_lock:
            proc, ready = self._proc, self._ready
        if proc is None:
            # between incarnations, mid-spawn, or never started: dead for
            # routing and re-dispatch
            return True
        if proc.poll() is not None:
            return True
        if not ready:
            return False                # warming: alive, not routable
        return not self.registry.alive(self._lease_id(), float(lease_ttl_s))

    def warming(self) -> bool:
        # a replica whose respawn budget ran out is dead, not warming
        return not (self._ready or self._stopped or self._killed
                    or self._exhausted)

    # -- routing probes (no remote round trip on the hot path) ---------------
    def load(self) -> int:
        return self.engine.inflight()

    def affinity(self, prompt: List[int]) -> int:
        # probing the child's prefix cache would cost an HTTP round trip a
        # candidate a placement: a process replica bids 0 and wins on
        # least load, then id order
        return 0

    def queue_depth(self) -> int:
        return self.engine.inflight()

    # -- supervision state machine -------------------------------------------
    def supervise(self, router) -> None:
        now = self._clock()
        with self._sup_lock:
            self._reap_zombies()
            if self._stopped or self._killed or self._exhausted \
                    or self._spawning:
                return
            proc = self._proc
            if proc is None:
                if self._next_spawn_at is not None \
                        and now >= self._next_spawn_at:
                    self._begin_spawn()
                return
            code = proc.poll()
            if code is not None:
                self._on_exit(code, now)
                return
            if not self._ready:
                return
            if self.registry.alive(self._lease_id(), router.lease_ttl_s):
                if self._suspect_deadline is not None:
                    # the silent spell healed before the respawn deadline
                    # (a partition healed): revive, NO respawn, NO fence
                    self._suspect_deadline = None
                    self._note("fleet_replica_lease_revived",
                               replica=self.rid,
                               incarnation=self.incarnation)
                return
            # alive by waitpid, dead by lease: a silent process
            if self._suspect_deadline is None:
                grace = self._backoff.jittered_delay(self.respawns + 1)
                self._suspect_deadline = now + grace
                self._note("fleet_replica_lease_expired", replica=self.rid,
                           incarnation=self.incarnation, pid=proc.pid,
                           heal_grace_s=round(grace, 3))
                return
            if now < self._suspect_deadline:
                return
            # the grace is over and it is still silent: orphan the
            # incarnation (do NOT kill it: if it ever wakes it must fence
            # itself out) and respawn under a fresh fence token
            self._suspect_deadline = None
            self._zombies.append(proc)
            self._proc = None
            self._ready = False
            self._record_exit(exit_code=None, reason="lease_expired",
                              pid=proc.pid)
            self._schedule_respawn(now, immediate=True)

    def _reap_zombies(self) -> None:
        """Poll orphaned incarnations (supervision lock held). A zombie
        that woke from SIGSTOP and found itself superseded exits with
        FENCED_EXIT: the proof it never served stale state."""
        for z in list(self._zombies):
            zc = z.poll()
            if zc is None:
                continue
            self._zombies.remove(z)
            if zc == FENCED_EXIT:
                _FENCED.inc()
                self._note("fleet_replica_fenced", replica=self.rid,
                           pid=z.pid, exit_code=zc)
                self.last_exit = dict(self.last_exit or {},
                                      fenced_pid=z.pid)
            else:
                self._note("fleet_replica_zombie_reaped", replica=self.rid,
                           pid=z.pid, exit_code=zc)

    def _on_exit(self, code: int, now: float) -> None:
        """The child exited (the waitpid path): classify, record,
        schedule."""
        proc, self._proc = self._proc, None
        self._ready = False
        self._suspect_deadline = None
        if code == FENCED_EXIT:
            # a superseded zombie draining out is bookkeeping, not a
            # fault: no respawn for it
            _FENCED.inc()
            self._note("fleet_replica_fenced", replica=self.rid,
                       pid=proc.pid if proc else None)
            self.last_exit = dict(self.last_exit or {},
                                  fenced_pid=proc.pid if proc else None)
            return
        self._record_exit(exit_code=code, reason="exit",
                          pid=proc.pid if proc else None)
        self._schedule_respawn(now)

    def _record_exit(self, *, exit_code, reason: str, pid) -> None:
        self.last_exit = {
            "incarnation": self.incarnation,
            "pid": pid,
            "exit_code": exit_code,
            "reason": reason,
        }
        self._note("fleet_replica_dead", replica=self.rid, **self.last_exit)

    def _schedule_respawn(self, now: float, immediate: bool = False) -> None:
        if self.respawns >= self.spec.respawn_max:
            self._exhausted = True
            if self.last_exit is not None:
                self.last_exit["respawn_budget_exhausted"] = True
            self._note("fleet_replica_respawn_exhausted", replica=self.rid,
                       respawns=self.respawns)
            return
        # the heal grace already took the backoff on the silent path; a
        # crash waits it out before its respawn
        delay = (0.0 if immediate
                 else self._backoff.jittered_delay(self.respawns + 1))
        self._next_spawn_at = now + delay

    # -- spawn ----------------------------------------------------------------
    def _begin_spawn(self) -> None:
        """Arm a spawn (supervision lock held). The fence bump, the
        fork/exec, the ready line and the warm-up probe run in a daemon
        thread, so a child's cold start never stalls the router's poll
        loop."""
        self._spawning = True
        self._next_spawn_at = None
        respawn = self._proc is not None or self.incarnation > 0 \
            or self.last_exit is not None
        self._spawn_thread = threading.Thread(
            target=self._spawn, args=(respawn,),
            name=f"fleet-spawn-{self.rid}", daemon=True)
        self._spawn_thread.start()

    def _child_stderr(self, fence: int):
        if not self.spec.log_dir:
            return subprocess.DEVNULL
        os.makedirs(self.spec.log_dir, exist_ok=True)
        return open(os.path.join(self.spec.log_dir,
                                 f"{self.rid}-{fence}.log"), "wb")

    def _spawn(self, respawn: bool) -> None:
        try:
            # the fence bump is the previous incarnation's point of no
            # return: from here any survivor of it must fence itself out
            fence = int(self.registry.store.add(self._fence_key(), 1))
            if respawn:
                with self._sup_lock:
                    self.respawns += 1
                _RESPAWNS.inc(replica=self.rid)
                self._dump_respawn(fence)
            host, port = self.spec.child_store_addr
            t0 = time.monotonic()
            cmd = [
                self.spec.python, "-m", CHILD_MODULE,
                "--replica-id", self.rid,
                "--incarnation", str(fence),
                "--fence", str(fence),
                "--store", f"{host}:{port}",
                "--prefix", self.registry.prefix,
                "--factory", self.spec.factory,
                "--engine-kwargs", json.dumps(self.spec.engine_kwargs),
                "--heartbeat-s", str(self.spec.child_heartbeat_s),
                "--parent-pid", str(os.getpid()),
                "--spawn-wall", repr(time.time()),
            ]
            env = dict(os.environ)
            env.update(self.spec.extra_env)
            err = self._child_stderr(fence)
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=err, env=env)
            finally:
                if err is not subprocess.DEVNULL:
                    err.close()
            with self._sup_lock:
                self._spawn_proc = proc
                if self._stopped:
                    self._reap(proc)
                    return
            deadline = time.monotonic() + self.spec.warmup_timeout_s
            # a child that hangs before its ready line would park readline
            # for good; the watchdog kills it at the deadline, so the pipe
            # ends and the spawn fails over to the next attempt
            watchdog = threading.Timer(
                max(0.1, deadline - time.monotonic()), self._reap,
                args=(proc,))
            watchdog.daemon = True
            watchdog.start()
            try:
                ready = self._await_ready(proc, deadline)
            finally:
                watchdog.cancel()
            t_ready = time.monotonic()
            if ready is None:
                # the pipe ended: the child exited on its own, or the
                # watchdog killed it at the deadline
                self._spawn_failed(proc, "warmup_timeout"
                                   if t_ready >= deadline
                                   else "exit_before_ready")
                return
            engine = _RemoteEngine(f"http://127.0.0.1:{ready['port']}")
            if not self._probe(engine, deadline):
                self._spawn_failed(proc, "warmup_probe_failed")
                return
            t_probe = time.monotonic()
            with self._sup_lock:
                if self._stopped or self._killed:
                    self._reap(proc)
                    return
                self.incarnation = fence
                self.pid = proc.pid
                self.engine = engine
                self._proc = proc
                self._ready = True
                self._suspect_deadline = None
                self.spawns.append({
                    "incarnation": fence, "pid": proc.pid,
                    "respawn": bool(respawn),
                    "spawn_to_ready_s": t_probe - t0,
                    "ready_line_s": t_ready - t0,
                    "probe_s": t_probe - t_ready,
                    **(ready.get("timings") or {})})
                self._note("fleet_replica_ready", replica=self.rid,
                           incarnation=fence, pid=proc.pid,
                           port=ready["port"])
        except Exception as e:  # noqa: BLE001 — spawn machinery fault
            with self._sup_lock:
                self._record_exit(exit_code=None,
                                  reason=f"spawn_error: {e}", pid=None)
                self._schedule_respawn(self._clock())
        finally:
            with self._sup_lock:
                self._spawning = False
                self._spawn_proc = None

    def _await_ready(self, proc: subprocess.Popen,
                     deadline: float) -> Optional[dict]:
        """Block (spawn thread only) for the child's one ready line; then a
        drain thread keeps the pipe from filling."""
        line = proc.stdout.readline() if proc.stdout else b""
        while line and time.monotonic() < deadline:
            line = line.strip()
            if line.startswith(b"{"):
                try:
                    msg = json.loads(line.decode())
                except ValueError:
                    msg = {}
                if msg.get("ready"):
                    threading.Thread(target=self._drain_stdout, args=(proc,),
                                     name=f"fleet-drain-{self.rid}",
                                     daemon=True).start()
                    return msg
            line = proc.stdout.readline()
        return None

    @staticmethod
    def _drain_stdout(proc: subprocess.Popen) -> None:
        try:
            while proc.stdout and proc.stdout.read(65536):
                pass
        except Exception:  # noqa: BLE001
            pass

    def _probe(self, engine: _RemoteEngine, deadline: float) -> bool:
        """The warm-up gate: the incarnation takes traffic only once its
        own /healthz agrees it is healthy."""
        while time.monotonic() < deadline:
            if self._stopped:
                return False
            snap = engine._get_json("/healthz", ok_codes=(200, 503),
                                    timeout=2.0)
            if snap is not None and snap.get("ok"):
                return True
            time.sleep(0.1)
        return False

    def _spawn_failed(self, proc: subprocess.Popen, reason: str) -> None:
        code = proc.poll()          # the child's own, before any reaping
        if code is None and reason == "exit_before_ready":
            # its pipe closes a moment before it can be waited for
            try:
                code = proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        self._reap(proc)
        with self._sup_lock:
            if self._stopped:
                return              # stop() ended the start-up
            self._record_exit(exit_code=proc.poll() if code is None
                              else code, reason=reason, pid=proc.pid)
            self._schedule_respawn(self._clock())

    @staticmethod
    def _reap(proc: subprocess.Popen) -> None:
        try:
            proc.kill()
            proc.wait(timeout=5.0)
        except (OSError, subprocess.TimeoutExpired):
            pass

    # -- observability --------------------------------------------------------
    @staticmethod
    def _note(kind: str, **data) -> None:
        try:
            from ..observability.flight_recorder import get_flight_recorder
            get_flight_recorder().note(kind, **data)
        except Exception:  # noqa: BLE001 — observability must not wound
            pass

    def _dump_respawn(self, new_fence: int) -> None:
        """A flight-recorder dump on every respawn, with the dead
        incarnation's last recorded state."""
        try:
            from ..observability.flight_recorder import get_flight_recorder
            get_flight_recorder().dump(
                "fleet_respawn",
                extra={"replica": self.rid,
                       "dead_incarnation": dict(self.last_exit or {}),
                       "new_incarnation": int(new_fence),
                       "respawns_so_far": self.respawns})
        except Exception:  # noqa: BLE001
            pass


def build_process_fleet(n_replicas: int = 2, *, store,
                        store_addr: Tuple[str, int],
                        spec_kwargs: Optional[dict] = None,
                        router_kwargs: Optional[dict] = None):
    """N supervised process replicas behind one FleetRouter over `store`
    (a native.TCPStore master the caller owns; `store_addr` is the
    endpoint the CHILDREN dial: point it at a chaos proxy to partition
    them). Returns the router unstarted."""
    from .fleet import FleetRouter

    specs = [ProcessReplicaSpec(store_addr, **(spec_kwargs or {}))
             for _ in range(int(n_replicas))]
    kw = dict(router_kwargs or {})
    return FleetRouter(replica_specs=specs, store=store, **kw)


def wait_fleet_ready(router, timeout_s: float = 120.0) -> bool:
    """Poll until every process replica passed its warm-up probe (a thread
    replica is ready at once); False at the timeout, or as soon as a
    replica has given up respawning. Drives router.poll() itself, so it
    works on an unstarted router too."""
    deadline = time.monotonic() + float(timeout_s)
    while time.monotonic() < deadline:
        router.poll()
        reps = list(router.replicas.values())
        if any(getattr(rep, "_exhausted", False) for rep in reps):
            return False
        if all(not rep.warming() for rep in reps):
            return True
        time.sleep(0.05)
    return False


# ---------------------------------------------------------------------------
# child side (python -m paddle_tpu_torch.serving.fleet_proc)
# ---------------------------------------------------------------------------

def _load_factory(spec: str):
    mod_name, _, fn_name = spec.rpartition(":")
    if not mod_name:
        raise ValueError(f"factory must be 'module:function', got {spec!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), fn_name)


def _child_main(argv: Optional[List[str]] = None) -> int:
    import argparse

    # the ready line is the one thing on stdout: everything else written
    # to file descriptor 1 (by Python or by native code) goes to stderr
    ready_out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    p = argparse.ArgumentParser(prog=CHILD_MODULE)
    p.add_argument("--replica-id", required=True)
    p.add_argument("--incarnation", type=int, required=True)
    p.add_argument("--fence", type=int, required=True)
    p.add_argument("--store", required=True, help="host:port of the "
                   "fleet's TCPStore (possibly through a partition proxy)")
    p.add_argument("--prefix", default="/pt/fleet")
    p.add_argument("--factory", default=DEMO_FACTORY)
    p.add_argument("--engine-kwargs", default="{}")
    p.add_argument("--heartbeat-s", type=float, default=0.2)
    p.add_argument("--parent-pid", type=int, default=0)
    p.add_argument("--spawn-wall", type=float, default=None,
                   help="the supervisor's time.time() at the spawn")
    args = p.parse_args(argv)
    timings = {}
    if args.spawn_wall is not None:
        # interpreter start-up and imports, up to here
        timings["import_s"] = time.time() - args.spawn_wall

    from .. import native
    from ..distributed.env import ReplicaRegistry
    from .engine import ServingEngine
    from .server import ServingServer

    host, _, port = args.store.rpartition(":")
    store = native.TCPStore(host, int(port), is_master=False, world_size=1,
                            timeout_s=30.0)
    registry = ReplicaRegistry(store, prefix=args.prefix)
    lease = f"{args.replica_id}@{args.incarnation}"
    fence_key = f"{args.prefix}/fence/{args.replica_id}"

    # refuse to even build the model when already superseded (a spawn
    # that lost a race with a faster supervisor decision)
    if int(store.add(fence_key, 0)) != args.fence:
        return FENCED_EXIT

    t0 = time.monotonic()
    model = _load_factory(args.factory)()
    t1 = time.monotonic()
    kw = json.loads(args.engine_kwargs)
    kw.setdefault("device", model.device)     # the factory picks it
    engine = ServingEngine(model, **kw)
    t2 = time.monotonic()
    srv = ServingServer(engine, port=0)
    timings.update(weights_s=t1 - t0, engine_s=t2 - t1)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    ready_out.write(json.dumps({"ready": True, "port": srv.port,
                                "pid": os.getpid(), "timings": timings})
                    + "\n")
    ready_out.flush()

    while not stop.is_set():
        # the fence check FIRST: a zombie waking from SIGSTOP exits before
        # it heartbeats or serves anything (os._exit: no atexit, no
        # flush; the process is gone as if it never woke)
        if int(store.add(fence_key, 0)) != args.fence:
            os._exit(FENCED_EXIT)
        if args.parent_pid and os.getppid() != args.parent_pid:
            break                        # the supervisor died: no orphans
        registry.heartbeat(lease)
        stop.wait(args.heartbeat_s)

    srv.stop()
    store.close()
    return 0


if __name__ == "__main__":
    sys.exit(_child_main())
