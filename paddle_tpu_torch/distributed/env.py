"""Process and rank environment, and the process-group store (counterpart
of paddle_tpu/distributed/env.py).

What the serving fleet needs: the in-process store (`InProcStore`, the
TCPStore's API over a dict and a condition variable, which N threads
share to act as N ranks), the cached process-group store (`get_store`,
`reset_store`) and the store-based replica registry (`ReplicaRegistry`:
a registration log, heartbeat leases aged on the reader's clock,
tombstones), which works alike over either store. `ParallelEnv`,
`get_rank` and `get_world_size` read the launcher's variables
(PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM) and default to rank 0 of 1.

With PADDLE_MASTER=host:port set and more than one rank, `get_store`
returns the store across processes (native.TCPStore over
torch.distributed's c10d store): rank 0 hosts it, the others connect.

`init_parallel_env` joins torch.distributed's default process group at
that endpoint, one process a rank (see its note), and
`reform_parallel_env` re-points the rank variables after an elastic
change.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import torch

_initialized = False
_device: Optional[torch.device] = None     # what init_parallel_env bound


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
    """The process-group store, resolved once per process. With
    PADDLE_MASTER=host:port set and world > 1: a native.TCPStore, hosted
    by rank 0 on that endpoint, every other rank connected to it.
    Otherwise an InProcStore that N threads can share to act as N ranks
    (tests, one-process runs)."""
    global _store
    with _store_lock:
        if _store is not None:
            return _store
        world = int(world_size if world_size is not None
                    else get_world_size())
        master = os.environ.get("PADDLE_MASTER", "")
        if world > 1 and master and ":" in master:
            from .. import native

            if native.available():
                host, _, port = master.rpartition(":")
                _store = native.TCPStore(
                    host, int(port), is_master=(get_rank() == 0),
                    world_size=world, timeout_s=timeout_s)
                return _store
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


def rank_device() -> torch.device:
    """The device init_parallel_env bound this rank to (cuda:i, or the CPU
    when it was asked for); before it ran, the current CUDA device (raising
    when there is none, as core.place.resolve_device does)."""
    if _device is not None:
        return _device
    from ..core.place import resolve_device

    return resolve_device(None)


_pg_generation = 0     # process groups this process has initialised


def _local_cuda_device(local_rank: int) -> torch.device:
    """cuda:{local_rank % device_count}, made current; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_parallel_env: this rank sees no CUDA device; pass "
            "device='cpu' to run it on the CPU")
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _device_identity(dev: torch.device) -> str:
    """What names a card across processes: the host and the card's UUID
    (two processes with other CUDA_VISIBLE_DEVICES see one card under two
    indices, or two cards under one)."""
    if dev.type != "cuda":
        return f"{socket.gethostname()}/cpu"
    props = torch.cuda.get_device_properties(dev)
    return (f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)} "
            f"({dev}, {props.name})")


def check_device_clash(backend: str, devices: Dict[int, str]) -> None:
    """Raise ValueError, naming the device, when `backend` is nccl and two
    ranks of `devices` (rank -> the identity `_device_identity` gives)
    share one CUDA device: NCCL refuses that. Nothing here switches the
    backend; gloo may share a device."""
    if backend != "nccl":
        return
    seen: Dict[str, int] = {}
    for rank in sorted(devices):
        ident = devices[rank]
        if ident.split("/", 1)[-1] == "cpu":
            continue
        if ident in seen:
            raise ValueError(
                f"backend nccl: ranks {seen[ident]} and {rank} share the "
                f"device {ident}, and NCCL refuses two ranks on one "
                "device; give each rank a card of its own "
                "(PADDLE_LOCAL_RANK), or name another backend in "
                "PADDLE_DISTRI_BACKEND (gloo)")
        seen[ident] = rank


def pg_timeout():
    """The process groups' collective timeout: PADDLE_PG_TIMEOUT seconds
    when set (a collective that waits longer raises, where gloo would
    wait its default half hour), else None (the backend's default)."""
    import datetime

    value = os.environ.get("PADDLE_PG_TIMEOUT")
    return None if not value else datetime.timedelta(seconds=float(value))


def init_parallel_env(strategy=None, *, device=None) -> "ParallelEnv":
    """Reference: paddle_tpu/distributed/env.py:334 (Paddle's
    parallel.py:914). Idempotent.

    Reads the launcher's variables: PADDLE_MASTER (or
    COORDINATOR_ADDRESS) as host:port, PADDLE_TRAINERS_NUM and
    PADDLE_TRAINER_ID. With more than one rank this process joins
    torch.distributed's default process group at that tcp:// endpoint.
    The rendezvous store there is the package's process-group store
    (`get_store`: rank 0 hosts a c10d TCPStore at PADDLE_MASTER, the
    others connect), handed to `init_process_group` under a prefix of
    its own, so the store and the process group share one endpoint (a
    tcp:// init method would bind the port a second time).

    `device=None` binds the rank to cuda:{PADDLE_LOCAL_RANK %
    device_count} (raising when there is no CUDA device); "cpu" keeps it
    on the CPU, as the tests ask. The backend is PADDLE_DISTRI_BACKEND
    (Paddle's own variable) when set, else nccl on CUDA and gloo on the
    CPU. Before the backend starts, the ranks exchange their devices
    through the store, and under nccl two ranks on one device raise
    ValueError naming it: the backend is never switched behind the
    caller's back. At world 1, or without PADDLE_MASTER, no process group
    is made and every collective stays the identity, as in the
    reference. PADDLE_PG_TIMEOUT (seconds) bounds every collective of
    the default group and of the groups made after it (`pg_timeout`).
    Keeps the span dist.init_parallel_env and the counter
    distributed_init_total."""
    global _initialized, _pg_generation, _device
    if _initialized:
        return ParallelEnv()
    import torch.distributed as dist

    from ..observability.registry import counter as _obs_counter
    from ..observability.spans import span as _span

    coord = os.environ.get("PADDLE_MASTER") or \
        os.environ.get("COORDINATOR_ADDRESS")
    nproc = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    pid = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    env = ParallelEnv()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = _local_cuda_device(env.local_rank if dev.index is None
                                 else dev.index)
    _device = dev
    backend = os.environ.get("PADDLE_DISTRI_BACKEND") or \
        ("nccl" if dev.type == "cuda" else "gloo")
    with _span("dist.init_parallel_env", cat="dist",
               args={"nproc": nproc, "rank": pid, "backend": backend}):
        if coord and nproc > 1 and not dist.is_initialized():
            os.environ["PADDLE_MASTER"] = coord    # where get_store looks
            store = get_store(nproc)
            if isinstance(store, InProcStore):
                raise RuntimeError(
                    "init_parallel_env: the process-group store is "
                    "in-process (torch.distributed is unavailable, or "
                    "get_store() ran before PADDLE_MASTER was set: "
                    "reset_store() first), so the ranks cannot meet")
            prefix = f"/pt/pg/{_pg_generation}"
            store.set(f"{prefix}/device/{pid}", _device_identity(dev))
            devices = {r: bytes(store.get(f"{prefix}/device/{r}",
                                          timeout_s=300.0)).decode()
                       for r in range(nproc)}
            check_device_clash(backend, devices)
            timeout = pg_timeout()
            kw = {} if timeout is None else {"timeout": timeout}
            dist.init_process_group(
                backend, store=dist.PrefixStore(prefix, store._store),
                rank=pid, world_size=nproc, **kw)
            _pg_generation += 1
    _obs_counter("distributed_init_total",
                 "init_parallel_env completions.").inc()
    _initialized = True
    return env


def reform_parallel_env(rank: int, world_size: int, *,
                        drop_store: bool = False) -> "ParallelEnv":
    """Reference: paddle_tpu/distributed/env.py:361. Re-point this
    process's rank and world after an elastic membership change:
    rewrites PADDLE_TRAINER_ID and PADDLE_TRAINERS_NUM, which ParallelEnv,
    get_rank and get_world_size read lazily. `drop_store=True` also drops
    the cached process-group store (a real multi-host reform whose
    endpoint set changed; not thread ranks sharing one InProcStore).

    A torch.distributed process group cannot change its size or ranks,
    so an initialised default group is destroyed here, with the mesh and
    the groups made over it, and init_parallel_env is armed again: the
    next call meets the new world under a fresh store prefix. The
    reference's single-controller world has no such group to drop."""
    global _initialized
    os.environ["PADDLE_TRAINER_ID"] = str(int(rank))
    os.environ["PADDLE_TRAINERS_NUM"] = str(int(world_size))
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from . import collective, mesh

        mesh.set_mesh(None)
        collective._reset_groups()
        dist.destroy_process_group()
        _initialized = False
    if drop_store:
        reset_store()
    return ParallelEnv()
