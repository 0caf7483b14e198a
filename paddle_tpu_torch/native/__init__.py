"""The store across processes (counterpart of paddle_tpu/native's
TCPStore; the reference's host tracer, arena and feed are not ported).

`TCPStore` keeps the reference's API and its contract with
distributed.env.InProcStore (tests/test_torch_store.py runs one suite over
both): byte values, an atomic counter whose `add(key, 0)` is the read,
`wait_ge` and a wave-counting `barrier`, with the same TimeoutError texts.
It runs over torch.distributed's c10d TCPStore, host code that ships with
PyTorch; no JAX process ever talks to a port process, so the reference's
wire format is not matched.

Every timeout is the client's, by polling non-blocking reads, as the
reference's are: c10d's `get` parks on the server until the store's own
timeout when the key is missing, so it is never called. A non-blocking
read is one `compare_set(key, M, M)` with a marker value M that no caller
stores: c10d answers it with the key's value, or with M for a missing key,
and writes nothing either way. That is one atomic request, so a key
deleted by another client between a `check` and a `get` cannot park the
reader.

c10d keeps counters as decimal text; a counter that `set` overwrote reads
as the reference's `_counter` reads it (decimal text, else a packed
little-endian int64, else 0). c10d's client does not reconnect after its
socket is severed (as the reference's native client does not): every call
after that raises.
"""
from __future__ import annotations

import struct
import time
from datetime import timedelta
from typing import Optional

__all__ = ["TCPStore", "available"]

# the non-blocking read's marker: never a stored value
_MISSING = b"\x00paddle_tpu_torch.native.TCPStore:missing\x00"


def available() -> bool:
    """Can this process host or join a TCPStore?"""
    import torch.distributed as dist

    return bool(dist.is_available())


class TCPStore:
    """TCP rendezvous store. The master process hosts the server; every
    process (the master too) talks to it through its own client
    connection. `port=0` on the master binds an ephemeral port (`.port`).

    set/get are byte-valued, add() is an atomic counter, wait_ge() blocks
    until a counter reaches a target, and barrier() is an add + wait_ge
    rendezvous. get / wait_ge / barrier take the same `timeout_s` keyword
    as distributed.env.InProcStore and raise TimeoutError with the same
    diagnostics. `timeout_s` of the constructor bounds the connect and
    every request to the server."""

    _POLL_S = 0.005  # client-side poll interval for timed blocking ops

    def __init__(self, host: str, port: int, *, is_master: bool = False,
                 world_size: int = 1, timeout_s: float = 60.0,
                 connect_attempts: int = 3):
        import torch.distributed as dist

        from ..resilience.retry import RetryError, RetryPolicy

        self.world_size = int(world_size)
        self.host = str(host)
        connect_host = "127.0.0.1" if is_master else self.host

        def _connect():
            try:
                # world_size None + no wait: the master never blocks for
                # the other ranks; rendezvous is barrier()'s job
                return dist.TCPStore(
                    connect_host, int(port), None, bool(is_master),
                    timedelta(seconds=float(timeout_s)),
                    wait_for_workers=False)
            except RuntimeError as e:       # DistNetworkError and friends
                raise ConnectionError(str(e)) from e

        # transient connect failures (master not bound yet, a refused
        # connection during a restart) retry under the shared policy; the
        # deadline caps the total wait at the caller's timeout
        policy = RetryPolicy(max_attempts=connect_attempts, base_delay=0.05,
                             max_delay=1.0, deadline=timeout_s,
                             retry_on=(ConnectionError,),
                             name="tcpstore.connect")
        try:
            self._store = policy.call(_connect)
        except (RetryError, ConnectionError) as e:
            raise RuntimeError(
                f"TCPStore: cannot connect to {host}:{port}") from e
        self.port = int(self._store.port)

    @property
    def _s(self):
        s = self._store
        if s is None:
            raise RuntimeError("TCPStore is closed")
        return s

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._s.set(str(key), bytes(value))

    def _get_once(self, key: str) -> Optional[bytes]:
        """One non-blocking fetch; None when the key is missing."""
        v = self._s.compare_set(str(key), _MISSING, _MISSING)
        return None if v == _MISSING else bytes(v)

    def get(self, key: str, *, blocking: bool = True,
            timeout_s: float = 60.0) -> Optional[bytes]:
        v = self._get_once(key)
        if v is not None or not blocking:
            return v
        deadline = time.monotonic() + float(timeout_s)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"TCPStore.get({key!r}) timed out "
                                   f"after {float(timeout_s):g}s")
            time.sleep(min(self._POLL_S, max(remaining, 0.0)))
            v = self._get_once(key)
            if v is not None:
                return v

    def add(self, key: str, delta: int = 1) -> int:
        return int(self._s.add(str(key), int(delta)))

    def _counter(self, key: str) -> int:
        """Read a counter without creating it; a missing key is 0."""
        raw = self._get_once(key)
        if raw is None:
            return 0
        try:
            return int(raw.decode())
        except (UnicodeDecodeError, ValueError):
            pass
        if len(raw) == 8:
            return int(struct.unpack("<q", raw)[0])
        return 0

    def wait_ge(self, key: str, target: int, *,
                timeout_s: float = 60.0) -> int:
        deadline = time.monotonic() + float(timeout_s)
        while True:
            cur = self._counter(key)
            if cur >= int(target):
                return cur
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"TCPStore.wait_ge({key!r}, {target}) timed out "
                    f"after {float(timeout_s):g}s: counter at {cur}, "
                    f"{int(target) - cur} arrival(s) never happened")
            time.sleep(min(self._POLL_S, max(remaining, 0.0)))

    def delete(self, key: str) -> None:
        self._s.delete_key(str(key))

    def num_keys(self) -> int:
        return int(self._s.num_keys())

    def barrier(self, name: Optional[str] = None,
                world_size: Optional[int] = None, *,
                rank: Optional[int] = None,
                timeout_s: float = 60.0) -> None:
        """Rendezvous of `world_size` callers, counted in waves (the
        scheme of InProcStore.barrier): the n-th arrival belongs to wave
        ceil(n / world) and waits for that wave to fill, so a reused name
        meets again correctly and a client keeps no barrier state. With
        `rank` given, a timeout names the ranks whose arrival key never
        appeared in this wave."""
        world = int(world_size or self.world_size)
        if name is None:
            name = "__anon"
        n = self.add(f"/barrier/{name}", 1)
        wave = (n + world - 1) // world
        if rank is not None:
            self.set(f"/barrier/{name}/w{wave}/r{int(rank)}", b"1")
        try:
            self.wait_ge(f"/barrier/{name}", world * wave,
                         timeout_s=timeout_s)
        except TimeoutError:
            arrived = self._counter(f"/barrier/{name}") - world * (wave - 1)
            msg = (f"TCPStore.barrier({name!r}) timed out after "
                   f"{float(timeout_s):g}s: {arrived}/{world} callers "
                   f"arrived in wave {wave}")
            if rank is not None:
                missing = [r for r in range(world)
                           if self._get_once(
                               f"/barrier/{name}/w{wave}/r{r}") is None]
                if missing:
                    msg += (f"; ranks whose arrival key never appeared: "
                            f"{missing}")
            raise TimeoutError(msg) from None

    def close(self) -> None:
        """Drop this client (the master's server stops once no clone of
        it is left). Idempotent; any later call raises."""
        self._store = None
