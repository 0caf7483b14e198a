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

Values of any size. c10d's libuv server resets the connection on a
request over 8 MiB, and a single large request holds its one server
thread (and so every other client's heartbeat) for as long as it takes.
So a value longer than `CHUNK_BYTES` is written as chunk keys of at most
that size under a per-write nonce, then a small head at the key itself
(a marker, the nonce, the chunk count and the length): the head lands
last, so a reader never sees half a value. A reader that finds a chunk
gone (the key was overwritten or deleted meanwhile) starts again from
the head. Every `set` swaps the key's raw value by `compare_set`, so the
writer that replaced a chunked value (with a short or a chunked one)
drops its chunks, also when writers race on one key.

c10d has no compare-and-delete, so `delete` first swaps the exact raw
value it read for a tombstone (unique to that delete) by `compare_set`,
then removes the key, then drops that value's chunks. A `set` never
swaps a tombstone: it waits until the key is gone, so the removal can
only remove the tombstone, and a set racing a delete either lands first
(the delete then reads again and takes the new value) or after it;
every head's chunks are dropped by the one client that replaced it.
Nothing is left behind: a deleted key holds no raw key once `delete`
returns. Readers and `wait_ge` take a tombstone for a missing key. A
`set` that still finds the same tombstone after `_TOMB_LEASE_S` takes
its deleter for dead and swaps it; a deleter stalled that long between
its two steps would remove that set's value (and orphan its chunks).
A tombstone starts with "0", so c10d's own `add` reads it as 0: an
`add` racing a `delete` of the same key may be removed with it (no
caller adds to a key that another client deletes). `num_keys` counts
logical keys (the chunks and their counter are subtracted); a key whose
delete is in flight still counts. A chunked
value reads back as a `bytearray` (one copy of its bytes, filled chunk by
chunk), a short one as `bytes`. The server is c10d's own (non-libuv)
backend: it moved 4 MiB chunks ~1.5x faster than the libuv one on
loopback.
"""
from __future__ import annotations

import json
import struct
import time
import uuid
from datetime import timedelta
from typing import Optional

__all__ = ["TCPStore", "available", "CHUNK_BYTES"]

# the non-blocking read's marker: never a stored value
_MISSING = b"\x00paddle_tpu_torch.native.TCPStore:missing\x00"
# a chunked value's head starts with this marker: never a stored prefix
_HEAD = b"\x00paddle_tpu_torch.native.TCPStore:chunked\x00"
# chunk keys and the count of live chunk keys (for num_keys)
_CHUNK_PREFIX = "/__paddle_tpu_torch_chunks__"
_CHUNK_COUNT = _CHUNK_PREFIX + "/count"
# a key being deleted holds "0" (c10d's add parses it as 0), a marker
# no caller stores and the delete's nonce, until the delete removes it
_TOMB = b"0\x00paddle_tpu_torch.native.TCPStore:deleted\x00"
_TOMB_LEASE_S = 10.0
CHUNK_BYTES = 4 << 20
_READ_RESTARTS = 100


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
                return _c10d_store(
                    dist, connect_host, int(port), bool(is_master),
                    timedelta(seconds=float(timeout_s)))
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
        key = str(key)
        if isinstance(value, str):
            value = value.encode()
        view = memoryview(value).cast("B")
        if view.nbytes <= CHUNK_BYTES:
            old = self._swap(key, bytes(view))
        else:
            nonce = uuid.uuid4().hex
            n = -(-view.nbytes // CHUNK_BYTES)
            self._s.add(_CHUNK_COUNT, n)
            for i in range(n):
                self._s.set(_chunk_key(nonce, i),
                            bytes(view[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES]))
            old = self._swap(key, _HEAD + json.dumps(
                {"nonce": nonce, "n": n, "size": view.nbytes}).encode())
        self._replaced(old)

    def _swap(self, key: str, new: bytes) -> Optional[bytes]:
        """Replace the raw value at `key` by `new` with compare_set, so of
        two writers racing over one chunked value exactly one sees it go;
        the raw value replaced (None for a missing key). A tombstone is
        waited out (see the module note)."""
        cur = self._get_once(key)
        while True:
            cur = self._past_tomb(key, cur)
            expected = b"" if cur is None else cur
            got = bytes(self._s.compare_set(key, expected, new))
            if got == new:
                return cur
            # c10d answers a missing key with `expected` itself: read again
            cur = self._get_once(key) if got == expected else got

    def _past_tomb(self, key: str, cur: Optional[bytes]) -> Optional[bytes]:
        """`cur`, or once a delete in flight has removed the key, the
        key's raw value then; a tombstone that outlives `_TOMB_LEASE_S`
        is returned as the value to replace."""
        deadline = time.monotonic() + _TOMB_LEASE_S
        while cur is not None and cur.startswith(_TOMB) \
                and time.monotonic() < deadline:
            time.sleep(self._POLL_S)
            nxt = self._get_once(key)
            if nxt != cur:
                deadline = time.monotonic() + _TOMB_LEASE_S
            cur = nxt
        return cur

    def _replaced(self, old: Optional[bytes]) -> None:
        """Drop a replaced chunked value's chunks."""
        head = _head(old)
        if head is not None:
            self._drop_chunks(head)

    def _drop_chunks(self, head: dict) -> None:
        # delete_key says whether it deleted, so a head's chunks are
        # counted off once even if two writers both saw it replaced (two
        # equal short values written over it at once)
        dropped = sum(bool(self._s.delete_key(_chunk_key(head["nonce"], i)))
                      for i in range(int(head["n"])))
        if dropped:
            self._s.add(_CHUNK_COUNT, -dropped)

    def _get_once(self, key: str) -> Optional[bytes]:
        """One non-blocking fetch of a raw c10d key; None when the key is
        missing."""
        v = self._s.compare_set(str(key), _MISSING, _MISSING)
        return None if v == _MISSING else bytes(v)

    def _read(self, key: str):
        """One non-blocking read of a logical value (a chunked one
        reassembled); None when the key is missing."""
        for _ in range(_READ_RESTARTS):
            raw = self._get_once(key)
            if raw is not None and raw.startswith(_TOMB):
                return None
            head = _head(raw)
            if head is None:
                return raw
            out = bytearray(int(head["size"]))
            for i in range(int(head["n"])):
                part = self._get_once(_chunk_key(head["nonce"], i))
                if part is None:            # overwritten or deleted since
                    break
                out[i * CHUNK_BYTES:i * CHUNK_BYTES + len(part)] = part
            else:
                return out
        raise RuntimeError(f"TCPStore.get({key!r}): the value kept changing "
                           f"under {_READ_RESTARTS} reads")

    def get(self, key: str, *, blocking: bool = True,
            timeout_s: float = 60.0) -> Optional[bytes]:
        v = self._read(key)
        if v is not None or not blocking:
            return v
        deadline = time.monotonic() + float(timeout_s)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"TCPStore.get({key!r}) timed out "
                                   f"after {float(timeout_s):g}s")
            time.sleep(min(self._POLL_S, max(remaining, 0.0)))
            v = self._read(key)
            if v is not None:
                return v

    def add(self, key: str, delta: int = 1) -> int:
        return int(self._s.add(str(key), int(delta)))

    def _counter(self, key: str) -> int:
        """Read a counter without creating it; a missing key is 0."""
        raw = self._get_once(key)
        if raw is None or raw.startswith(_TOMB):
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
        """Swap the raw value read for a tombstone, remove the key, then
        drop that value's chunks (see the module note); a missing key,
        or one another delete is removing, is left to it."""
        key = str(key)
        tomb = _TOMB + uuid.uuid4().hex.encode()
        cur = self._get_once(key)
        while cur is not None and not cur.startswith(_TOMB):
            got = bytes(self._s.compare_set(key, cur, tomb))
            if got == tomb:
                self._s.delete_key(key)
                self._replaced(cur)
                return
            # c10d answers a missing key with `expected` itself: read again
            cur = self._get_once(key) if got == cur else got

    def num_keys(self) -> int:
        n = int(self._s.num_keys())
        live = self._get_once(_CHUNK_COUNT)
        return n if live is None else n - 1 - int(live.decode())

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


def _c10d_store(dist, host: str, port: int, is_master: bool,
                timeout: timedelta):
    # world_size None + no wait: the master never blocks for the other
    # ranks; rendezvous is barrier()'s job
    return dist.TCPStore(host, port, None, is_master, timeout,
                         wait_for_workers=False, use_libuv=False)


def _chunk_key(nonce: str, i: int) -> str:
    return f"{_CHUNK_PREFIX}/{nonce}/{int(i)}"


def _head(raw) -> Optional[dict]:
    """A chunked value's head, parsed; None for any other value."""
    if raw is None or not raw.startswith(_HEAD):
        return None
    return json.loads(raw[len(_HEAD):].decode())
