"""Elastic membership over the process-group store: heartbeats, leases and
generation-numbered views, plus the store-based gradient exchange
(counterpart of paddle_tpu/distributed/elastic.py).

The protocol is the reference's, with no coordinator:

  * every member keeps a lease alive by rewriting `<prefix>/hb/<id>`
    every `FLAGS_elastic_heartbeat_s` (a value that changes every beat,
    aged on the observer's own clock); a member whose heartbeat is older
    than `FLAGS_elastic_lease_ttl_s` is presumed dead;
  * the agreed membership is a published view at `<prefix>/view`,
    `{"gen": G, "members": [...]}`; a writer rejects a stale generation,
    and every survivor computes its proposal from the same store state,
    so concurrent proposers converge on one view;
  * a graceful departure (or an ejection) sets `<prefix>/left/<id>`;
    joiners append themselves to a join log (`/join_seq` + `/join/<n>`)
    and wait to appear in a published view.

`StoreReducer` exchanges per-step gradients through the same store: each
member publishes its gradients and metadata as one value (a 4-byte
big-endian header length, a JSON header, then an npz of the arrays: the
reference's wire format), collects the others', and a collection timeout
names exactly which members never arrived (`PeerLostError`). Keys carry
the membership generation; each member deletes its own keys two steps
behind (a retried step's republished key is not counted twice, as the
reference counts it, which would delete it while a slow peer may still
read it), and the rest of them on a reform. Values of several GB pass through native.TCPStore, which
chunks them. `iter_raw` yields the packed contributions one at a time, in
the given order, and `_unpack_iter` their arrays one at a time, so a
caller can fold each into a running sum and drop it. `_pack` writes the
header and the npz into one buffer and the readers read the arrays out of
the buffer they are given, so no whole contribution is copied again.

Works alike over distributed.env.InProcStore (threads as ranks) and
native.TCPStore (one process a rank).
"""
from __future__ import annotations

import io
import json
import struct
import threading
import time
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from ..core.flags import define_flag, get_flag
from ..observability.registry import counter as _counter

define_flag("elastic", False,
            "Enable elastic training: heartbeat/lease liveness on the "
            "process-group store and mesh reformation at N-1 on rank loss "
            "(resilience/elastic.py ElasticTrainer).")
define_flag("elastic_heartbeat_s", 0.25,
            "Interval between heartbeat-key rewrites for elastic "
            "membership leases.")
define_flag("elastic_lease_ttl_s", 1.5,
            "Lease TTL: a member whose heartbeat key is older than this "
            "is presumed dead and reformed out of the membership view. "
            "Keep well above elastic_heartbeat_s (>= 4x).")

_REFORMS = _counter("elastic_membership_changes_total",
                    "Membership views adopted, by kind of change.",
                    labelnames=("kind",), always=True)

__all__ = [
    "MembershipView", "ElasticMembership", "StoreReducer", "PeerLostError",
]


class PeerLostError(TimeoutError):
    """A collective over the store timed out with specific members'
    contributions missing: carries who, so the caller can check their
    leases and reform instead of guessing."""

    def __init__(self, op: str, step: int, missing: Sequence[int],
                 present: Sequence[int], timeout_s: float):
        self.op = str(op)
        self.step = int(step)
        self.missing = tuple(sorted(int(m) for m in missing))
        self.present = tuple(sorted(int(m) for m in present))
        self.timeout_s = float(timeout_s)
        super().__init__(
            f"{op} at step {step} timed out after {timeout_s:g}s: "
            f"contributions from members {list(self.missing)} never "
            f"arrived (got {list(self.present)}) — check their "
            f"heartbeat leases and reform the membership view")


class MembershipView:
    """One agreed membership: a generation number and a sorted member set.
    dp_rank(member) is the member's index in the sorted set, so ranks are
    dense in [0, world_size) at every generation: what the sharded
    checkpoint layout and the batch slicing key on."""

    __slots__ = ("gen", "members")

    def __init__(self, gen: int, members: Sequence[int]):
        self.gen = int(gen)
        self.members: Tuple[int, ...] = tuple(
            sorted({int(m) for m in members}))
        if not self.members:
            raise ValueError("a membership view needs at least one member")

    @property
    def world_size(self) -> int:
        return len(self.members)

    def contains(self, member: int) -> bool:
        return int(member) in self.members

    def dp_rank(self, member: int) -> int:
        try:
            return self.members.index(int(member))
        except ValueError:
            raise ValueError(
                f"member {member} is not in membership view gen "
                f"{self.gen} {list(self.members)}") from None

    def to_json(self) -> str:
        return json.dumps({"gen": self.gen, "members": list(self.members)})

    @classmethod
    def from_json(cls, raw) -> "MembershipView":
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode()
        d = json.loads(raw)
        return cls(d["gen"], d["members"])

    def __eq__(self, other):
        return (isinstance(other, MembershipView)
                and self.gen == other.gen and self.members == other.members)

    def __hash__(self):
        return hash((self.gen, self.members))

    def __repr__(self):
        return f"MembershipView(gen={self.gen}, members={list(self.members)})"


class ElasticMembership:
    """One member's handle on the shared membership protocol.

    `clock` is injectable so lease-expiry tests need not sleep. The
    background heartbeat thread only heartbeats; views are adopted in
    `poll()` on the caller's thread (the training loop), so the view never
    changes under a step."""

    def __init__(self, store, member_id: int,
                 members: Sequence[int], *,
                 lease_ttl_s: Optional[float] = None,
                 heartbeat_s: Optional[float] = None,
                 prefix: str = "/pt/elastic",
                 clock: Callable[[], float] = time.monotonic):
        self.store = store
        self.member_id = int(member_id)
        self.prefix = str(prefix).rstrip("/")
        self.lease_ttl_s = float(
            lease_ttl_s if lease_ttl_s is not None
            else get_flag("elastic_lease_ttl_s"))
        self.heartbeat_s = float(
            heartbeat_s if heartbeat_s is not None
            else get_flag("elastic_heartbeat_s"))
        self._clock = clock
        # observer-side leases: heartbeat values are opaque change tokens,
        # aged on this member's clock from the last change it saw
        self._hb_lock = threading.Lock()
        self._hb_seen: Dict[int, tuple] = {}
        self._hb_seq = 0
        self._view_lock = threading.RLock()
        self.view = MembershipView(0, members)
        self.changes: List[dict] = []     # adopted views, newest last
        self._callbacks: List[Callable] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # adopt the view already agreed (a late joiner sees the
        # incumbents' generation); otherwise publish gen 0 (every initial
        # member writes the same bytes)
        pub = self.published_view()
        if pub is not None:
            self.view = pub
        else:
            self.store.set(self._k("view"), self.view.to_json())
        self.heartbeat()

    # -- store keys ---------------------------------------------------------
    def _k(self, *parts) -> str:
        return "/".join([self.prefix, *map(str, parts)])

    # -- liveness -----------------------------------------------------------
    def heartbeat(self) -> None:
        """Renew this member's lease. "n" changes the value every beat
        (frozen test clocks included); "t" is for humans reading the
        store."""
        with self._hb_lock:
            self._hb_seq += 1
            raw = json.dumps({"m": self.member_id, "n": self._hb_seq,
                              "t": self._clock()}).encode()
            self._hb_seen[self.member_id] = (raw, self._clock())
        self.store.set(self._k("hb", self.member_id), raw)

    def heartbeat_age(self, member: int) -> float:
        """Seconds on this member's clock since it last saw `member`'s
        heartbeat value change (0.0 on first sight); inf when it never
        heartbeat."""
        raw = self.store.get(self._k("hb", member), blocking=False)
        if raw is None:
            return float("inf")
        now = self._clock()
        with self._hb_lock:
            seen = self._hb_seen.get(int(member))
            if seen is None or seen[0] != bytes(raw):
                self._hb_seen[int(member)] = (bytes(raw), now)
                return 0.0
            return max(0.0, now - seen[1])

    def has_left(self, member: int) -> bool:
        return self.store.get(self._k("left", member),
                              blocking=False) is not None

    def is_alive(self, member: int) -> bool:
        if int(member) == self.member_id:
            return True
        return (not self.has_left(member)
                and self.heartbeat_age(member) <= self.lease_ttl_s)

    # -- the background heartbeat thread ------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._beat_loop, name=f"elastic-hb-{self.member_id}",
            daemon=True)
        self._thread.start()

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self.heartbeat()
            except Exception:  # noqa: BLE001 — the store is going away
                return

    def stop(self) -> None:
        """Stop heartbeating without a left marker: from outside this
        looks like a crash (the chaos rank kill uses it; a graceful
        departure is leave())."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    # -- view agreement -----------------------------------------------------
    def published_view(self) -> Optional[MembershipView]:
        raw = self.store.get(self._k("view"), blocking=False)
        if raw is None:
            return None
        try:
            return MembershipView.from_json(raw)
        except (ValueError, KeyError):
            return None

    def publish_view(self, view: MembershipView) -> bool:
        """Publish iff `view.gen` is newer than the published generation:
        a slow member waking with an old proposal cannot roll the
        membership back."""
        cur = self.published_view()
        if cur is not None and cur.gen >= view.gen:
            return False
        self.store.set(self._k("view"), view.to_json())
        return True

    def pending_joins(self) -> List[int]:
        """Members in the join log that are not in the current view and
        are heartbeating."""
        # add(key, 0) is the portable atomic counter read
        seq = self.store.add(self._k("join_seq"), 0)
        out = []
        for i in range(1, seq + 1):
            raw = self.store.get(self._k("join", i), blocking=False)
            if raw is None:
                continue
            try:
                m = int(raw)
            except ValueError:
                continue
            if (not self.view.contains(m) and not self.has_left(m)
                    and self.heartbeat_age(m) <= self.lease_ttl_s):
                out.append(m)
        return sorted(set(out))

    def poll(self) -> Optional[MembershipView]:
        """One protocol turn: adopt a newer published view if someone
        already reformed; otherwise diff the current view against liveness
        (leases, left markers, the join log) and, if it changed, propose
        gen+1. Returns the newly adopted view, or None if nothing moved.
        Every survivor computes the same proposal, so whoever wins the
        publish race wrote the view the others would have written."""
        with self._view_lock:
            pub = self.published_view()
            if pub is not None and pub.gen > self.view.gen:
                self._adopt(pub, kind="adopted")
                return self.view
            desired = {m for m in self.view.members if self.is_alive(m)}
            desired.update(self.pending_joins())
            if not desired or desired == set(self.view.members):
                return None
            proposal = MembershipView(self.view.gen + 1, desired)
            if self.publish_view(proposal):
                self._adopt(proposal, kind="proposed")
            else:
                pub = self.published_view()
                if pub is None or pub.gen <= self.view.gen:
                    return None
                self._adopt(pub, kind="adopted")
            return self.view

    def _adopt(self, view: MembershipView, kind: str) -> None:
        prev = self.view
        self.view = view
        lost = sorted(set(prev.members) - set(view.members))
        joined = sorted(set(view.members) - set(prev.members))
        info = {"gen": view.gen, "prev_gen": prev.gen,
                "members": list(view.members), "lost": lost,
                "joined": joined, "world_size": view.world_size,
                "kind": kind}
        self.changes.append(info)
        _REFORMS.inc(kind=("shrink" if lost else
                           "grow" if joined else "noop"))
        from ..observability import flight_recorder as _fr
        try:
            _fr.on_membership_change(info)
        except Exception:  # noqa: BLE001 — forensics must not kill training
            pass
        for cb in list(self._callbacks):
            try:
                cb(info)
            except Exception:  # noqa: BLE001
                pass

    def add_watch_callback(self, cb: Callable) -> None:
        """Called with the change-info dict on every adopted view
        (PreemptionHandler.attach_elastic plugs in here)."""
        self._callbacks.append(cb)

    # -- departures / arrivals ---------------------------------------------
    def leave(self) -> None:
        """Graceful departure: a left marker (seen at once) and no more
        heartbeats. Survivors reform on their next poll()."""
        self.store.set(self._k("left", self.member_id), b"leave")
        self.stop()

    def eject(self, member: int) -> Optional[MembershipView]:
        """Mark another member as departed (straggler remediation past the
        rebalancing bound) and reform."""
        self.store.set(self._k("left", member), b"ejected")
        return self.poll()

    def request_join(self, timeout_s: float = 30.0) -> MembershipView:
        """Announce this member in the join log, heartbeat, and wait until
        a published view contains it. Incumbents fold pending joiners in
        on their next poll(); a lone joiner (everyone else gone) folds
        itself in."""
        self.heartbeat()
        n = self.store.add(self._k("join_seq"), 1)
        self.store.set(self._k("join", n), str(self.member_id))
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            with self._view_lock:
                pub = self.published_view()
                if pub is not None and pub.gen > self.view.gen:
                    self._adopt(pub, kind="adopted")
                if self.view.contains(self.member_id):
                    return self.view
                # no incumbent alive to sponsor us: self-sponsor
                if not any(self.is_alive(m) for m in self.view.members):
                    self.poll()
                    if self.view.contains(self.member_id):
                        return self.view
            time.sleep(min(0.01, self.heartbeat_s / 4))
        raise TimeoutError(
            f"member {self.member_id} was not admitted into a membership "
            f"view within {timeout_s:g}s (current view gen "
            f"{self.view.gen}, members {list(self.view.members)})")


# -- store-backed gradient exchange -----------------------------------------

_HDR = struct.Struct(">I")


class _BufferReader(io.RawIOBase):
    """A seekable read-only file over a buffer, without copying it (what
    np.load reads an npz from)."""

    def __init__(self, buf):
        self._buf = memoryview(buf).cast("B")
        self._pos = 0

    def readable(self):
        return True

    def seekable(self):
        return True

    def readinto(self, b):
        n = max(0, min(len(b), len(self._buf) - self._pos))
        b[:n] = self._buf[self._pos:self._pos + n]
        self._pos += n
        return n

    def seek(self, offset, whence=io.SEEK_SET):
        base = {io.SEEK_SET: 0, io.SEEK_CUR: self._pos,
                io.SEEK_END: len(self._buf)}[whence]
        self._pos = max(0, base + int(offset))
        return self._pos

    def tell(self):
        return self._pos


class _Shifted:
    """A writable file whose positions start `base` bytes into `f`: the
    npz after the header is then the same bytes as an npz written alone
    (zipfile records one absolute position, the zip64 locator's, which a
    reader of the npz alone would find `base` bytes off)."""

    def __init__(self, f, base: int):
        self._f, self._base = f, int(base)

    def write(self, b):
        return self._f.write(b)

    def read(self, n=-1):
        return self._f.read(n)

    def tell(self):
        return self._f.tell() - self._base

    def seek(self, pos, whence=io.SEEK_SET):
        if whence == io.SEEK_SET:
            pos += self._base
        return self._f.seek(pos, whence) - self._base

    def seekable(self):
        return True

    def flush(self):
        self._f.flush()


def _pack(meta: dict, arrays: Sequence[np.ndarray]) -> memoryview:
    """Header length, JSON header, npz of `arrays` (as a0, a1, ...): one
    buffer, written once."""
    header = json.dumps(meta).encode()
    header = _HDR.pack(len(header)) + header
    bio = io.BytesIO()
    bio.write(header)
    np.savez(_Shifted(bio, len(header)),
             **{f"a{i}": np.ascontiguousarray(a)
                for i, a in enumerate(arrays)})
    return bio.getbuffer()


def _unpack_iter(raw) -> Tuple[dict, Iterator[np.ndarray]]:
    """(meta, the arrays one at a time): a caller that drops each array
    before taking the next holds one of them at a time."""
    view = memoryview(raw).cast("B")
    (hlen,) = _HDR.unpack_from(view, 0)
    meta = json.loads(bytes(view[_HDR.size:_HDR.size + hlen]).decode())

    def arrays():
        with np.load(_BufferReader(view[_HDR.size + hlen:])) as z:
            for i in range(len(z.files)):
                yield z[f"a{i}"]

    return meta, arrays()


def _unpack(raw) -> Tuple[dict, List[np.ndarray]]:
    meta, arrays = _unpack_iter(raw)
    return meta, list(arrays)


class StoreReducer:
    """Per-step gradient exchange over the store: publish mine, collect
    everyone's, name whoever never showed up. Keys are namespaced by
    membership generation, so a reformed view never consumes a dead
    generation's leftovers, and each member deletes its own keys two steps
    behind (the exchange is lockstep: every peer has read them by then)."""

    def __init__(self, store, member_id: int, prefix: str = "/pt/elastic/ar"):
        self.store = store
        self.member_id = int(member_id)
        self.prefix = str(prefix).rstrip("/")
        self._published: List[str] = []

    def _key(self, gen: int, step: int, member: int) -> str:
        return f"{self.prefix}/g{int(gen)}/s{int(step)}/m{int(member)}"

    def publish(self, gen: int, step: int, meta: dict,
                arrays: Sequence[np.ndarray]) -> None:
        self.publish_packed(gen, step, _pack(meta, arrays))

    def publish_packed(self, gen: int, step: int, value) -> None:
        """Publish this member's contribution, already `_pack`ed."""
        key = self._key(gen, step, self.member_id)
        self.store.set(key, value)
        if key in self._published:      # a retried step: the same key
            return
        self._published.append(key)
        # anything this member published 2+ steps ago has been read
        while len(self._published) > 2:
            self.store.delete(self._published.pop(0))

    def iter_raw(self, gen: int, step: int, members: Sequence[int], *,
                 timeout_s: float = 10.0) -> Iterator[Tuple[int, bytes]]:
        """Yield (member, packed contribution) for each of `members`, in
        that order, as each arrives; one deadline for them all. A member
        still missing at the deadline raises PeerLostError naming every
        member not yet yielded."""
        deadline = time.monotonic() + float(timeout_s)
        pending = [int(m) for m in members]
        done: List[int] = []
        while pending:
            m = pending[0]
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise PeerLostError("store allreduce", step,
                                    missing=pending, present=done,
                                    timeout_s=timeout_s)
            try:
                raw = self.store.get(self._key(gen, step, m),
                                     blocking=True,
                                     timeout_s=min(remaining, 0.25))
            except TimeoutError:
                continue  # re-check the global deadline, try again
            if raw is None:
                continue
            pending.pop(0)
            done.append(m)
            yield m, raw

    def collect(self, gen: int, step: int, members: Sequence[int], *,
                timeout_s: float = 10.0
                ) -> Dict[int, Tuple[dict, List[np.ndarray]]]:
        return {m: _unpack(raw) for m, raw in self.iter_raw(
            gen, step, members, timeout_s=timeout_s)}

    def reset(self) -> None:
        """After a reform: delete this member's keys of the old generation,
        which no one reads again (the reference only forgets them, and a
        GPT-3 1.3B member's two would hold ~10.5 GB of the store's host
        until it exits)."""
        while self._published:
            self.store.delete(self._published.pop(0))
