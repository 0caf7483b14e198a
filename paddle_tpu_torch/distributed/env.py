"""Process and rank environment, and the process-group store (counterpart
of paddle_tpu/distributed/env.py, for one process).

What the serving fleet needs: the in-process store (`InProcStore`, the
native TCPStore's API over a dict and a condition variable, which N threads
share to act as N ranks), the cached process-group store (`get_store`,
`reset_store`) and the store-based replica registry (`ReplicaRegistry`:
a registration log, heartbeat leases aged on the reader's clock,
tombstones). `ParallelEnv`, `get_rank` and `get_world_size` read the
launcher's variables (PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM) and default
to rank 0 of 1.

A store across ranks (the reference's native TCPStore, chosen when
PADDLE_MASTER is set and the world has more than one rank) waits for the
distributed slice (ROADMAP queue 1): `get_store` raises for it rather than
hand each rank a private store. Nothing here uses torch.distributed yet.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

_initialized = False


class InProcStore:
    """In-process, thread-safe store with the native TCPStore's API
    (set/get/add/wait_ge/delete/num_keys/barrier/close). N threads sharing
    one instance behave like N ranks; barriers count waves, so one shared
    instance serves every simulated rank."""

    def __init__(self, world_size: int = 1):
        self.world_size = int(world_size)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._kv: Dict[str, bytes] = {}
        self._counters: Dict[str, int] = {}

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        with self._cv:
            self._kv[str(key)] = bytes(value)
            self._cv.notify_all()

    def get(self, key: str, *, blocking: bool = True,
            timeout_s: float = 60.0) -> Optional[bytes]:
        key = str(key)
        deadline = time.monotonic() + float(timeout_s)
        with self._cv:
            while key not in self._kv:
                if not blocking:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"InProcStore.get({key!r}) timed out")
                self._cv.wait(remaining)
            return self._kv[key]

    def add(self, key: str, delta: int = 1) -> int:
        with self._cv:
            v = self._counters.get(str(key), 0) + int(delta)
            self._counters[str(key)] = v
            self._kv[str(key)] = str(v).encode()
            self._cv.notify_all()
            return v

    def wait_ge(self, key: str, target: int, *,
                timeout_s: float = 60.0) -> int:
        key = str(key)
        deadline = time.monotonic() + float(timeout_s)
        with self._cv:
            while self._counters.get(key, 0) < int(target):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    cur = self._counters.get(key, 0)
                    raise TimeoutError(
                        f"InProcStore.wait_ge({key!r}, {target}) timed out "
                        f"after {float(timeout_s):g}s: counter at {cur}, "
                        f"{int(target) - cur} arrival(s) never happened")
                self._cv.wait(remaining)
            return self._counters[key]

    def delete(self, key: str) -> None:
        with self._cv:
            self._kv.pop(str(key), None)
            self._counters.pop(str(key), None)

    def num_keys(self) -> int:
        with self._lock:
            return len(self._kv)

    def barrier(self, name: str = "default",
                world_size: Optional[int] = None, *,
                rank: Optional[int] = None,
                timeout_s: float = 60.0) -> None:
        """Rendezvous of `world_size` callers: the n-th arrival belongs to
        wave ceil(n / world) and waits for that wave to fill, so a reused
        name meets again correctly. Callers that pass their `rank` get the
        ranks that never arrived named in a timeout."""
        world = int(world_size or self.world_size)
        n = self.add(f"/barrier/{name}", 1)
        wave = (n + world - 1) // world
        if rank is not None:
            self.set(f"/barrier/{name}/w{wave}/r{int(rank)}", b"1")
        try:
            self.wait_ge(f"/barrier/{name}", world * wave,
                         timeout_s=timeout_s)
        except TimeoutError:
            arrived = self._counters.get(f"/barrier/{name}", 0) \
                - world * (wave - 1)
            msg = (f"InProcStore.barrier({name!r}) timed out after "
                   f"{float(timeout_s):g}s: {arrived}/{world} callers "
                   f"arrived in wave {wave}")
            if rank is not None:
                missing = [r for r in range(world)
                           if self.get(f"/barrier/{name}/w{wave}/r{r}",
                                       blocking=False) is None]
                if missing:
                    msg += (f"; ranks whose arrival key never appeared: "
                            f"{missing}")
            raise TimeoutError(msg) from None

    def close(self) -> None:  # the native store's API
        pass


_store = None
_store_lock = threading.Lock()


def get_store(world_size: Optional[int] = None, *, timeout_s: float = 60.0):
    """The process-group store, resolved once per process: an InProcStore
    that N threads can share. A store across ranks (PADDLE_MASTER set,
    world > 1) raises NotImplementedError: it waits for the distributed
    slice."""
    global _store
    with _store_lock:
        if _store is not None:
            return _store
        world = int(world_size if world_size is not None
                    else get_world_size())
        master = os.environ.get("PADDLE_MASTER", "")
        if world > 1 and master and ":" in master:
            raise NotImplementedError(
                f"a store across {world} ranks at PADDLE_MASTER={master} "
                "(the reference's native TCPStore) is not ported yet "
                "(ROADMAP queue 1: distributed and fleet)")
        _store = InProcStore(world_size=world)
        return _store


def reset_store() -> None:
    """Drop the cached store (tests, or a re-init after env changes)."""
    global _store
    with _store_lock:
        if _store is not None:
            try:
                _store.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        _store = None


class ReplicaRegistry:
    """Store-based serving-replica registry (fleet routing and discovery):
    registration is an append-only log (a sequence counter plus one entry
    key a registration), liveness a heartbeat lease a replica, departure
    a tombstone key, so discovery works alike over an InProcStore (threads
    as replicas) and a store across processes."""

    def __init__(self, store, *, prefix: str = "/pt/fleet",
                 clock=time.monotonic):
        self.store = store
        self.prefix = prefix.rstrip("/")
        self._clock = clock
        # the reader's lease state: heartbeat values are opaque change
        # tokens; a lease ages on this reader's clock from the moment its
        # value was last seen to change, so writers' clocks never enter
        self._hb_lock = threading.Lock()
        self._hb_seen: Dict[str, tuple] = {}  # rid -> (raw, first seen)
        self._hb_seq = 0

    def _k(self, *parts: str) -> str:
        return "/".join((self.prefix,) + parts)

    # -- membership --------------------------------------------------------
    def register(self, replica_id: str, meta: Optional[dict] = None) -> None:
        n = self.store.add(self._k("seq"), 1)
        self.store.set(self._k("entry", str(n)), replica_id)
        self.store.set(self._k("meta", replica_id),
                       json.dumps(meta or {}, sort_keys=True))
        self.store.delete(self._k("left", replica_id))
        self.heartbeat(replica_id)

    def deregister(self, replica_id: str, reason: str = "left") -> None:
        self.store.set(self._k("left", replica_id), reason)

    def replicas(self, include_left: bool = False) -> List[str]:
        """Registered replica ids in registration order (a re-registration
        keeps the first position)."""
        # add(key, 0) reads a counter on every store kind
        n = self.store.add(self._k("seq"), 0)
        seen, out = set(), []
        for i in range(1, n + 1):
            rid = self.store.get(self._k("entry", str(i)), blocking=False)
            if rid is None:
                continue
            rid = rid.decode()
            if rid in seen:
                continue
            seen.add(rid)
            if include_left or not self.has_left(rid):
                out.append(rid)
        return out

    def meta(self, replica_id: str) -> dict:
        raw = self.store.get(self._k("meta", replica_id), blocking=False)
        return json.loads(raw.decode()) if raw else {}

    def has_left(self, replica_id: str) -> bool:
        return self.store.get(self._k("left", replica_id),
                              blocking=False) is not None

    # -- liveness ----------------------------------------------------------
    def heartbeat(self, replica_id: str) -> None:
        """Renew the lease. The value carries a sequence number, so it
        changes at every beat even under a frozen clock; the writer primes
        its own reader state, so a registry that beats and reads ages the
        lease from its last write."""
        with self._hb_lock:
            self._hb_seq += 1
            raw = f"{self._hb_seq}:{self._clock():.9f}".encode()
            self._hb_seen[str(replica_id)] = (raw, self._clock())
        self.store.set(self._k("hb", replica_id), raw)

    def heartbeat_age(self, replica_id: str) -> float:
        """Seconds on this reader's clock since it last saw the replica's
        heartbeat value change (0.0 at first sight); inf when the replica
        never beat."""
        raw = self.store.get(self._k("hb", replica_id), blocking=False)
        if raw is None:
            return float("inf")
        now = self._clock()
        with self._hb_lock:
            seen = self._hb_seen.get(str(replica_id))
            if seen is None or seen[0] != raw:
                self._hb_seen[str(replica_id)] = (raw, now)
                return 0.0
            return max(0.0, now - seen[1])

    def alive(self, replica_id: str, lease_ttl_s: float) -> bool:
        return (not self.has_left(replica_id)
                and self.heartbeat_age(replica_id) <= float(lease_ttl_s))


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", "0"))

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def nranks(self):
        return get_world_size()

    @property
    def device_type(self):
        return "gpu" if torch.cuda.is_available() else "cpu"

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]


def get_rank(group=None) -> int:
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None) -> int:
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


def is_initialized() -> bool:
    return _initialized
