"""The port's distributed/env.py against the reference's, on the CPU.

The same operation sequences run on both packages' InProcStore and
ReplicaRegistry (the port's copy must answer every call as the reference
does: values, counters, timeouts, barrier waves, registration order,
leases on a fake clock, tombstones), get_store's in-process singleton and
its store across ranks (a native.TCPStore that rank 0 hosts), and
ParallelEnv for one process.
Everything compares exactly: these are host data structures.
"""
import threading

from paddle_tpu.distributed import env as jenv
from paddle_tpu_torch.distributed import env as tenv


def _run_both(script):
    """script(env module) -> a list of observations; both packages must
    observe the same."""
    want = script(jenv)
    got = script(tenv)
    assert got == want
    return got


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the exception kind is compared
        return ("raises", type(e).__name__)


def test_store_operations_match():
    def script(env):
        s = env.InProcStore(world_size=2)
        out = [s.set("/a", b"x"), s.get("/a"), s.set("/b", "text"),
               s.get("/b"), s.get("/missing", blocking=False),
               _outcome(lambda: s.get("/missing", timeout_s=0.05)),
               s.add("/n", 3), s.add("/n", -1), s.add("/n", 0), s.get("/n"),
               s.wait_ge("/n", 2, timeout_s=1.0),
               _outcome(lambda: s.wait_ge("/n", 5, timeout_s=0.05)),
               s.num_keys()]
        s.delete("/n")
        out += [s.add("/n", 0), s.num_keys(), s.world_size, s.close()]
        return out

    got = _run_both(script)
    assert got[5] == ("raises", "TimeoutError")


def test_store_blocking_get_and_barrier_waves_match():
    def script(env):
        s = env.InProcStore(world_size=2)
        seen = []

        def late_set():
            s.set("/late", b"v")

        t = threading.Timer(0.05, late_set)
        t.start()
        seen.append(s.get("/late", timeout_s=5.0))
        t.join()
        done = []

        def rank(r):
            s.barrier("sync", rank=r, timeout_s=10.0)
            done.append(r)
            s.barrier("sync", rank=r, timeout_s=10.0)   # the name reused
            done.append(r + 10)

        ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=30)
        seen.append(sorted(done))
        try:
            s.barrier("lonely", 3, rank=0, timeout_s=0.1)
        except TimeoutError as e:
            msg = str(e)
            seen.append([msg.split("after")[0], "1/3" in msg,
                         msg.split("never appeared: ")[-1]])
        return seen

    got = _run_both(script)
    assert got[1] == [0, 1, 10, 11]
    assert got[2][2] == "[1, 2]"


def test_replica_registry_matches_on_a_fake_clock():
    def script(env):
        now = [0.0]
        store = env.InProcStore()
        reg = env.ReplicaRegistry(store, prefix="/pt/fleet/",
                                  clock=lambda: now[0])
        reader = env.ReplicaRegistry(store, clock=lambda: now[0] + 50.0)
        out = []
        reg.register("r0", meta={"slots": 4})
        reg.register("r1")
        out += [reg.replicas(), reg.meta("r0"), reg.meta("r1"),
                reg.alive("r0", 0.5), reader.heartbeat_age("r0")]
        now[0] = 0.6                        # the lease lapses unrenewed
        out += [reg.alive("r0", 0.5), reg.heartbeat_age("r0"),
                reader.heartbeat_age("r0")]
        reg.heartbeat("r0")                 # a beat the reader sees change
        out += [reg.alive("r0", 0.5), reader.heartbeat_age("r0"),
                reg.heartbeat_age("nope")]
        reg.deregister("r1", reason="drain")
        out += [reg.replicas(), reg.replicas(include_left=True),
                reg.has_left("r1"), reg.has_left("r0"),
                reg.alive("r1", 1e9)]
        reg.register("r1")                  # a rejoin clears the tombstone
        reg.register("r2", meta={"kind": "process"})
        out += [reg.replicas(), reg.has_left("r1"), reg.meta("r2"),
                store.get("/pt/fleet/left/r1", blocking=False),
                store.add("/pt/fleet/seq", 0)]
        return out

    got = _run_both(script)
    assert got[0] == ["r0", "r1"] and got[-1] == 4


def test_get_store_is_a_singleton_and_refuses_a_store_across_ranks(
        monkeypatch):
    for env in (jenv, tenv):
        env.reset_store()
    try:
        for var in ("PADDLE_MASTER", "PADDLE_TRAINERS_NUM",
                    "PADDLE_TRAINER_ID"):
            monkeypatch.delenv(var, raising=False)
        js, ts = jenv.get_store(), tenv.get_store()
        assert type(ts) is tenv.InProcStore
        assert tenv.get_store() is ts and jenv.get_store() is js
        assert ts.world_size == js.world_size == 1
        tenv.reset_store()
        # world 1 with a master set: still the in-process store
        monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:6170")
        assert isinstance(tenv.get_store(), tenv.InProcStore)
        tenv.reset_store()
        # world 2 with a master: rank 0 hosts a TCPStore there (port 0
        # binds an ephemeral one), never a private in-process store
        from paddle_tpu_torch import native

        monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:0")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        s2 = tenv.get_store()
        assert type(s2) is native.TCPStore and s2.port > 0
        assert s2.world_size == 2 and tenv.get_store() is s2
        tenv.reset_store()
        s4 = tenv.get_store(world_size=4)
        assert type(s4) is native.TCPStore and s4.world_size == 4
        tenv.reset_store()
        monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:6170")
        # no master: N threads share one in-process store
        monkeypatch.delenv("PADDLE_MASTER")
        assert tenv.get_store().world_size == 2
    finally:
        for env in (jenv, tenv):
            env.reset_store()


def test_parallel_env_for_one_process(monkeypatch):
    for var in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                "PADDLE_LOCAL_RANK", "PADDLE_CURRENT_ENDPOINT",
                "PADDLE_TRAINER_ENDPOINTS"):
        monkeypatch.delenv(var, raising=False)

    def view(env):
        pe = env.ParallelEnv()
        return [pe.rank, pe.world_size, pe.local_rank, pe.dev_id,
                pe.nranks, pe.current_endpoint, pe.trainer_endpoints,
                env.get_rank(), env.get_world_size(), env.is_initialized()]

    assert view(tenv) == view(jenv) == [0, 1, 0, 0, 1, "127.0.0.1:6170",
                                        ["127.0.0.1:6170"], 0, 1, False]
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2")
    assert view(tenv) == view(jenv)
    assert tenv.ParallelEnv().device_type == "cpu"
