"""The port's stores on the CPU: native.TCPStore (over torch.distributed's
c10d store) and distributed.env.InProcStore behind one contract.

The cases of tests/test_store_contract.py run unchanged against both of
the port's stores (set/get, a non-blocking miss, a blocking get's timeout
and wake-up, counters and the `add(key, 0)` read, wait_ge and its
diagnostics, delete, num_keys, barrier reuse and the missing ranks named
in a timeout, an idempotent close), and so do the replica registry's
lease-clock cases. Then get_store under PADDLE_MASTER with two real
ranks, a counter overwritten by set, the chaos process helpers, and the
store partition proxy's stall and drop.
"""
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import test_store_contract as _contract
from paddle_tpu_torch import native
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed.env import InProcStore, ReplicaRegistry
from paddle_tpu_torch.resilience import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORES = ["inproc", "tcp"]


def _make_store(kind):
    if kind == "inproc":
        return InProcStore(world_size=1)
    return native.TCPStore("127.0.0.1", 0, is_master=True, world_size=1)


@pytest.fixture(params=STORES)
def store(request):
    s = _make_store(request.param)
    yield s
    s.close()


class TestPortStoreContract(_contract.TestStoreContract):
    """The reference's contract cases, over `store` above: the port's
    InProcStore and the port's TCPStore."""


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


class TestLeaseClocks:
    """Leases age on the OBSERVER's clock from the last change it saw, over
    either store (a writer's clock never enters the comparison)."""

    def test_registry_lease_ignores_writer_clock_steps(self, store):
        wclock, rclock = _FakeClock(5_000.0), _FakeClock(100.0)
        writer = ReplicaRegistry(store, prefix="/lease", clock=wclock)
        reader = ReplicaRegistry(store, prefix="/lease", clock=rclock)
        writer.heartbeat("r0")
        assert reader.alive("r0", 1.0)
        wclock.t -= 10_000.0
        rclock.t += 0.5
        writer.heartbeat("r0")
        assert reader.heartbeat_age("r0") == 0.0
        assert reader.alive("r0", 1.0)
        wclock.t += 50_000.0
        rclock.t += 0.5
        writer.heartbeat("r0")
        assert reader.alive("r0", 1.0)
        rclock.t += 1.51
        assert not reader.alive("r0", 1.0)
        wclock.t = -3.0
        writer.heartbeat("r0")
        assert reader.alive("r0", 1.0)

    def test_registry_frozen_writer_clock_still_beats(self, store):
        wclock, rclock = _FakeClock(), _FakeClock()
        writer = ReplicaRegistry(store, prefix="/frz", clock=wclock)
        reader = ReplicaRegistry(store, prefix="/frz", clock=rclock)
        for _ in range(3):
            writer.heartbeat("r0")
            rclock.t += 0.9
            assert reader.alive("r0", 1.0)
        rclock.t += 1.2
        assert not reader.alive("r0", 1.0)

    def test_registry_membership_log_and_tombstones(self, store):
        reg = ReplicaRegistry(store, prefix="/mem")
        for rid in ("r0", "r1", "r2"):
            reg.register(rid, meta={"slots": 4})
        reg.deregister("r1")
        assert reg.replicas() == ["r0", "r2"]
        assert reg.replicas(include_left=True) == ["r0", "r1", "r2"]
        reg.register("r1")                     # back: keeps its position
        assert reg.replicas() == ["r0", "r1", "r2"]
        assert reg.meta("r0") == {"slots": 4}
        assert reg.heartbeat_age("nobody") == float("inf")


def test_counter_overwritten_by_set_reads_like_the_reference():
    """c10d keeps counters as decimal text: wait_ge and the barrier read a
    counter that set() replaced as the reference's `_counter` does."""
    s = native.TCPStore("127.0.0.1", 0, is_master=True)
    try:
        s.add("/n", 5)
        assert s._counter("/n") == 5 and s._counter("/missing") == 0
        s.set("/n", "12")
        assert s._counter("/n") == 12 and s.wait_ge("/n", 12) == 12
        s.set("/n", (7).to_bytes(8, "little", signed=True))
        assert s._counter("/n") == 7
        s.set("/n", b"not a number")
        assert s._counter("/n") == 0
        s.close()
        with pytest.raises(RuntimeError, match="closed"):
            s.add("/n", 1)
    finally:
        s.close()


_RANK1 = """
import os, sys
from paddle_tpu_torch.distributed import env
store = env.get_store(timeout_s=30.0)
assert type(store).__name__ == "TCPStore", type(store)
store.set("/r1/hello", b"from rank 1")
assert store.get("/r0/hello", timeout_s=30.0) == b"from rank 0"
store.barrier("both", rank=1, timeout_s=30.0)
print("rank1 ok", store.add("/seen", 1))
"""


def test_get_store_under_paddle_master_joins_two_ranks(monkeypatch):
    """Two ranks, one store: rank 0 (this process) hosts it on the
    PADDLE_MASTER endpoint, rank 1 (a child process) connects, and they
    exchange keys and meet at a barrier."""
    host = native.TCPStore("127.0.0.1", 0, is_master=True)
    port = host.port
    host.close()                    # a port that was free a moment ago
    monkeypatch.setenv("PADDLE_MASTER", f"127.0.0.1:{port}")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    tenv.reset_store()
    try:
        s0 = tenv.get_store(timeout_s=30.0)
        assert type(s0) is native.TCPStore and s0.port == port
        env = dict(os.environ, PADDLE_TRAINER_ID="1", PYTHONPATH=REPO)
        child = subprocess.Popen([sys.executable, "-c", _RANK1], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            s0.set("/r0/hello", b"from rank 0")
            assert s0.get("/r1/hello", timeout_s=30.0) == b"from rank 1"
            s0.barrier("both", rank=0, timeout_s=30.0)
            out, err = child.communicate(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        assert child.returncode == 0, err
        assert "rank1 ok 1" in out
        assert s0.add("/seen", 0) == 1
    finally:
        tenv.reset_store()


def _state(pid):
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


@pytest.mark.skipif(not chaos.sigstop_supported(), reason="no SIGSTOP")
def test_chaos_process_faults():
    chaos.reset_stats()
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"])
             for _ in range(2)]
    try:
        chaos.hang_process(procs[0])
        deadline = time.monotonic() + 10
        while _state(procs[0].pid) != "T" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _state(procs[0].pid) == "T"     # stopped, still alive
        assert procs[0].poll() is None
        chaos.resume_process(procs[0].pid)
        deadline = time.monotonic() + 10
        while _state(procs[0].pid) == "T" and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _state(procs[0].pid) != "T"
        chaos.kill_process(procs[1])
        assert procs[1].wait(timeout=10) == -signal.SIGKILL
        assert (chaos.stats["processes_hung"],
                chaos.stats["processes_resumed"],
                chaos.stats["processes_killed"]) == (1, 1, 1)
    finally:
        for p in procs:
            p.kill()
            p.wait()


def test_partition_proxy_stall_holds_and_drop_severs():
    master = native.TCPStore("127.0.0.1", 0, is_master=True)
    px = chaos.StorePartitionProxy("127.0.0.1", master.port)
    try:
        victim = native.TCPStore(px.host, px.port, timeout_s=10.0)
        assert victim.add("/k", 2) == 2
        # stall: the request is held, then answered at heal; nothing lost
        px.partition(mode="stall")
        assert px.partitioned
        got = []
        t = threading.Thread(target=lambda: got.append(victim.add("/k", 1)))
        t.start()
        time.sleep(0.3)
        assert not got and master.add("/k", 0) == 2
        px.heal()
        t.join(10)
        assert got == [3] and master.add("/k", 0) == 3
        # a timed heal
        px.partition(0.2, mode="stall")
        t0 = time.monotonic()
        assert victim.add("/k", 1) == 4
        assert time.monotonic() - t0 >= 0.15 and not px.partitioned
        # drop severs the live connection. c10d's client does not
        # reconnect (nor does the reference's native client): every later
        # call on it raises, and the caller (a process replica's
        # heartbeat loop) ends with that exception
        px.partition(mode="drop")
        px.heal()
        for _ in range(2):
            with pytest.raises(RuntimeError):
                victim.add("/k", 1)
        assert master.add("/k", 0) == 4
        # a new client through the healed proxy works
        fresh = native.TCPStore(px.host, px.port, timeout_s=10.0)
        assert fresh.add("/k", 1) == 5
        with pytest.raises(ValueError):
            px.partition(mode="flap")
        assert chaos.stats["partitions_started"] >= 3
    finally:
        px.close()
        master.close()


def test_partition_proxy_keeps_an_idle_connection():
    """An idle client keeps its connection through the port's proxy. The
    reference's proxy dials upstream with a 10 s socket timeout and keeps
    it, so 10 s without a byte from the server severs the pair, and a
    stall longer than that turns into a drop (ROADMAP §3)."""
    from paddle_tpu.resilience import chaos as jchaos

    master = native.TCPStore("127.0.0.1", 0, is_master=True)
    ours = chaos.StorePartitionProxy("127.0.0.1", master.port)
    theirs = jchaos.StorePartitionProxy("127.0.0.1", master.port)
    try:
        a = native.TCPStore(ours.host, ours.port, timeout_s=10.0)
        b = native.TCPStore(theirs.host, theirs.port, timeout_s=10.0)
        assert a.add("/idle", 1) == 1 and b.add("/idle", 1) == 2
        time.sleep(10.5)
        assert a.add("/idle", 1) == 3
        with pytest.raises(RuntimeError):
            b.add("/idle", 1)
    finally:
        ours.close()
        theirs.close()
        master.close()
