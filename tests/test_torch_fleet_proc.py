"""The port's process replicas (serving/fleet_proc.py) on the CPU.

Cheap half: _RemoteEngine against an in-process ServingServer (no child
process), as tests/test_fleet_proc.py runs the reference's: stream parity
with the engine itself, the child's telemetry merged, cancel, drain,
/stats and /healthz proxied, a dead endpoint and a bad request mapped to
errors, an incarnation not yet spawned refusing work, and a client that
leaves a silent stream (its request still queued) found and cancelled.

Expensive half: ONE two-process fleet for the module. Its children build
the JAX package's demo_model (a tiny GPT at seed 11), its weights carried
into the port by load_jax_state_dict through a file, from a factory module
written to a temporary directory; their store client goes through a
StorePartitionProxy. Greedy tokens must equal the JAX ServingEngine's on
the same weights and prompts, exactly: before and after a SIGKILL
(re-dispatched, respawned under fence + 1), across a SIGSTOP'd zombie
(fenced with exit 43 once its replacement runs) and a store partition
that heals inside the grace (no respawn). FleetServer's /healthz and
/stats carry the supervision fields, and no child outlives
router.stop().

Then two faults of the reference the port does not share: its autoscaler
spawns again while a process replica warms up, and a child that dies
before its first ready line is retried without end (ROADMAP §3).
"""
import json
import os
import signal
import sys
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu.serving as jserving
from paddle_tpu.serving.fleet_proc import demo_model as jax_demo_model
from paddle_tpu_torch import native
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_jax_state_dict)
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.observability.flight_recorder import \
    get_flight_recorder
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import (EngineDrainingError, FleetRouter,
                                      FleetServer, Replica,
                                      ServingEngine, ServingServer,
                                      build_process_fleet, wait_fleet_ready)
from paddle_tpu_torch.serving.fleet_proc import (FENCED_EXIT,
                                                 ProcessReplicaSpec,
                                                 _RemoteEngine)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = {"max_slots": 3, "block_size": 16, "prefill_chunk": 16}
PROMPT = [5, 6, 7, 8]
PROMPTS = [PROMPT, [11, 12, 13, 14, 15, 16, 17], [3] * 20,
           list(range(40, 73))]
NEW = 24

_STATE = {}


def _state():
    if not _STATE:
        _STATE.update({k: np.asarray(v.numpy())
                       for k, v in jax_demo_model().state_dict().items()})
    return _STATE


def _torch_demo():
    m = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(m, _state())
    m.eval()
    return m


def _wait_for(cond, timeout_s=60.0, poll_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(poll_s)
    return False


# ---------------------------------------------------------------------------
# cheap: the remote stand-in against an in-process server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def local_srv():
    engine = ServingEngine(_torch_demo(), device="cpu", **ENGINE_KW)
    srv = ServingServer(engine, port=0)
    yield srv
    srv.stop()


@pytest.fixture()
def remote(local_srv):
    return _RemoteEngine(f"http://127.0.0.1:{local_srv.port}")


class TestRemoteEngine:
    def test_stream_parity_with_direct_engine(self, local_srv, remote):
        direct = local_srv.engine.submit(PROMPT, max_new_tokens=12)
        assert direct.wait(60)
        req = remote.submit(PROMPT, max_new_tokens=12)
        assert req.wait(60)
        assert req.output_tokens == direct.output_tokens
        assert req.finish_reason == direct.finish_reason == "length"
        assert req.state == "finished"
        toks, state, reason = remote.snapshot_output(req)
        assert toks == direct.output_tokens and state == "finished"

    def test_request_telemetry_merges_child_view(self, remote):
        req = remote.submit(PROMPT * 5, max_new_tokens=8, tier="interactive")
        assert req.wait(60)
        t = req.telemetry()
        assert t["tier"] == "interactive"
        assert t["request_id"] == req.request_id
        assert t["output_tokens"] == len(req.output_tokens) == 8
        assert t["prompt_tokens"] == 20
        # the engine's view: the earlier requests cached the prompt's
        # first full block
        assert t["prefix_matched_tokens"] == req.prefix_matched
        assert req.ttft_seconds() is not None
        assert req.queue_seconds() is not None

    def test_cancel_severs_stream(self, local_srv, remote):
        req = remote.submit(PROMPT, max_new_tokens=200)
        assert remote.cancel(req, "cancelled")
        assert req.wait(30)
        assert req.finish_reason == "cancelled" and req.state == "finished"
        assert _wait_for(lambda: remote.inflight() == 0, 10)
        # the server side let go of it: no slot or reservation left
        eng = local_srv.engine
        assert _wait_for(lambda: not eng.sched.has_work(), 30)
        assert eng.stats()["reserved_blocks"] == 0
        assert not remote.cancel(req)          # already finished

    def test_a_silent_stream_still_sees_its_client_go(self, local_srv,
                                                      remote):
        """A greedy request's stream is silent until its budget ends (its
        tokens stay on the device) or, here, while it waits for a slot;
        the server still finds its client gone and cancels it, instead of
        running it to the end (ROADMAP §3)."""
        eng = local_srv.engine
        shed = tregistry.REGISTRY.get("serving_shed_requests_total")
        before = shed.value(tier="silent", reason="disconnect")
        blockers = [eng.submit([7] * 4, max_new_tokens=200)
                    for _ in range(ENGINE_KW["max_slots"])]
        req = remote.submit(PROMPT, max_new_tokens=200, tier="silent")
        assert remote.cancel(req) and req.wait(30)
        assert _wait_for(lambda: shed.value(
            tier="silent", reason="disconnect") == before + 1, 30)
        for b in blockers:
            assert b.wait(60) and b.finish_reason == "length"

    def test_drain_gates_submit(self, remote):
        remote.drain()
        with pytest.raises(EngineDrainingError):
            remote.submit(PROMPT, max_new_tokens=4)
        assert remote.drained()
        remote.resume()
        req = remote.submit(PROMPT, max_new_tokens=4)
        assert req.wait(60)

    def test_stats_and_health_proxy(self, remote):
        s = remote.stats()
        assert s["remote"] is True and "unreachable" not in s
        assert "graphs" in s and set(s["launches"]) >= {
            "rms_norm", "rope_packed", "paged_decode"}
        # the plain versions ran here: no kernel launched on the CPU
        assert not any(s["launches"].values())
        snap = remote.obs.health_snapshot()
        assert snap["ok"] and snap["remote"] is True and snap["loop_alive"]

    def test_dead_endpoint_maps_to_errors(self):
        eng = _RemoteEngine("http://127.0.0.1:9")   # discard port: refused
        with pytest.raises(RuntimeError):
            eng.submit(PROMPT, max_new_tokens=4)
        assert eng.stats().get("unreachable") is True
        snap = eng.obs.health_snapshot()
        assert snap["ok"] is False and snap["loop_alive"] is False
        assert eng.export_kv_blocks(PROMPT) == []

    def test_bad_request_maps_to_value_error(self, remote):
        with pytest.raises(ValueError):
            remote.submit([], max_new_tokens=4)

    def test_unspawned_incarnation_rejects_submit(self):
        eng = _RemoteEngine(None)
        with pytest.raises(RuntimeError):
            eng.submit(PROMPT)
        with pytest.raises(RuntimeError):
            eng.ingest_kv_blocks([])
        assert eng.stats().get("unreachable") is True


# ---------------------------------------------------------------------------
# expensive: one real two-process fleet for the module
# ---------------------------------------------------------------------------

_FACTORY = '''
import numpy as np
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_jax_state_dict)


def make():
    m = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    with np.load({path!r}) as z:
        load_jax_state_dict(m, {{k: z[k] for k in z.files}})
    m.eval()
    return m
'''


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX ServingEngine's greedy tokens on demo_model for PROMPTS."""
    eng = jserving.ServingEngine(jax_demo_model(), **ENGINE_KW)
    out = eng.generate(PROMPTS, max_new_tokens=NEW)
    return [o[len(p):] for o, p in zip(out, PROMPTS)]


@pytest.fixture(scope="module")
def proc_fleet(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_proc")
    np.savez(d / "demo_weights.npz", **_state())
    (d / "fleet_factory.py").write_text(
        _FACTORY.format(path=str(d / "demo_weights.npz")))
    # respawn dumps go to FLAGS_metrics_dir/flight: a temporary directory
    prev = tflags.get_flag("metrics_dir")
    tflags.set_flags({"metrics_dir": str(d / "metrics")})
    store = native.TCPStore("127.0.0.1", 0, is_master=True)
    proxy = chaos.StorePartitionProxy("127.0.0.1", store.port)
    router = build_process_fleet(
        2, store=store, store_addr=(proxy.host, proxy.port),
        spec_kwargs=dict(
            factory="fleet_factory:make", engine_kwargs=ENGINE_KW,
            extra_env={"PYTHONPATH": os.pathsep.join([str(d), REPO])},
            child_heartbeat_s=0.2, respawn_backoff_s=2.0, respawn_max=5,
            warmup_timeout_s=60.0, log_dir=str(d / "logs")),
        router_kwargs=dict(heartbeat_s=0.05, lease_ttl_s=2.0,
                           prefix=f"/test/fleetproc/{os.getpid()}"))
    router.start()
    try:
        assert wait_fleet_ready(router, 90), "process fleet never warmed up"
        yield router, proxy
    finally:
        router.stop()
        proxy.close()
        store.close()
        tflags.set_flags({"metrics_dir": prev})


def _serve(router, prompts=PROMPTS):
    freqs = [router.submit(p, max_new_tokens=NEW) for p in prompts]
    for f in freqs:
        assert f.wait(60) and f.finish_reason == "length", f.finish_reason
    return [list(f.output_tokens) for f in freqs]


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


class TestProcessFleet:
    def test_greedy_tokens_equal_the_jax_engine(self, proc_fleet,
                                                jax_tokens):
        router, _ = proc_fleet
        assert _serve(router) == jax_tokens
        # both children served (least load spreads a burst)
        assert all(rep.incarnation == 1 and rep.respawns == 0
                   for rep in router.replicas.values())
        assert len({rep.pid for rep in router.replicas.values()}) == 2

    def test_supervision_surface_over_fleet_server(self, proc_fleet):
        router, _ = proc_fleet
        srv = FleetServer(router, port=0)
        try:
            with urllib.request.urlopen(srv.url() + "/healthz",
                                        timeout=10) as r:
                health = json.loads(r.read().decode())
            with urllib.request.urlopen(srv.url() + "/stats",
                                        timeout=10) as r:
                stats = json.loads(r.read().decode())
        finally:
            srv._httpd.shutdown()          # keep the router running
            srv._httpd.server_close()
        assert health["ok"] is True
        for rid, snap in health["replicas"].items():
            rep = router.replicas[rid]
            assert snap["incarnation"] == rep.incarnation >= 1
            assert snap["pid"] == rep.pid and snap["pid"] != os.getpid()
            assert snap["respawns"] == 0 and snap["last_exit"] is None
            assert snap["warming"] is False and snap["dead"] is False
            assert snap["remote"] is True
        for rid, snap in stats["replicas"].items():
            assert snap["incarnation"] >= 1 and "last_exit" in snap
            assert snap["remote"] is True and "graphs" in snap
            assert "launches" in snap

    def test_sigkill_redispatch_bitwise_and_respawn(self, proc_fleet,
                                                    jax_tokens):
        router, _ = proc_fleet
        req = router.submit(PROMPTS[3], max_new_tokens=NEW)
        victim = req.attempts[0].replica
        vinc, vpid = victim.incarnation, victim.pid
        chaos.kill_process(vpid)
        assert req.wait(60)
        assert req.redispatches >= 1
        assert list(req.output_tokens) == jax_tokens[3]
        # the supervisor respawns the victim under the next fence token;
        # it is warming (unroutable, not dead) until its probe passes
        seen_warming = []

        def back():
            if victim.warming():
                seen_warming.append(victim.incarnation)
            return (victim.incarnation > vinc and not victim.warming()
                    and not victim.dead(router.lease_ttl_s))

        assert _wait_for(back, 60, poll_s=0.005)
        assert seen_warming and victim.incarnation == vinc + 1
        assert victim.respawns == 1 and victim.pid != vpid
        assert victim.last_exit == {"incarnation": vinc, "pid": vpid,
                                    "exit_code": -signal.SIGKILL,
                                    "reason": "exit"}
        assert not _alive(vpid)
        assert _serve(router) == jax_tokens

    @pytest.mark.skipif(not chaos.sigstop_supported(), reason="no SIGSTOP")
    def test_zombie_is_fenced_not_trusted(self, proc_fleet, jax_tokens):
        router, _ = proc_fleet
        fenced = tregistry.REGISTRY.get("fleet_replica_fenced_total")
        fenced0 = fenced.total()
        z = router.replicas["replica-1"]
        zpid, zinc, zresp = z.pid, z.incarnation, z.respawns
        chaos.hang_process(zpid)
        assert _wait_for(lambda: (z.incarnation > zinc and not z.warming()
                                  and not z.dead(router.lease_ttl_s)), 60)
        assert z.last_exit["reason"] == "lease_expired"
        assert z.last_exit["pid"] == zpid and z.respawns == zresp + 1
        assert _alive(zpid)                    # orphaned, never killed
        # requests keep flowing, bitwise, while the zombie is out
        assert _serve(router) == jax_tokens
        chaos.resume_process(zpid)
        assert _wait_for(lambda: (z.last_exit or {}).get("fenced_pid")
                         == zpid, 30)
        assert not _alive(zpid)
        assert fenced.total() == fenced0 + 1
        # it exited with the fence code, not a crash's
        assert any(e["kind"] == "fleet_replica_fenced" and e["pid"] == zpid
                   and e.get("exit_code") == FENCED_EXIT
                   for e in get_flight_recorder().events())
        assert z.incarnation == zinc + 1       # the zombie left it alone
        assert _serve(router) == jax_tokens

    def test_healed_partition_gives_no_respawn(self, proc_fleet,
                                               jax_tokens):
        """Both children's store traffic stalls past the lease (2 s) but
        heals inside the heal grace (at least 1 s on top): the leases
        expire and revive, with no respawn and no fence bump."""
        router, proxy = proc_fleet
        before = {rid: (rep.incarnation, rep.respawns, rep.pid)
                  for rid, rep in router.replicas.items()}
        rec = get_flight_recorder()
        n0 = len(rec.events())
        proxy.partition(2.3, mode="stall")
        assert _wait_for(lambda: not proxy.partitioned, 10)
        time.sleep(1.5)
        kinds = [e["kind"] for e in rec.events()[n0:]]
        assert "fleet_replica_lease_expired" in kinds
        assert "fleet_replica_lease_revived" in kinds
        after = {rid: (rep.incarnation, rep.respawns, rep.pid)
                 for rid, rep in router.replicas.items()}
        assert after == before
        assert _serve(router) == jax_tokens

    def test_no_child_outlives_router_stop(self, proc_fleet):
        router, _ = proc_fleet
        pids = [pid for rep in router.replicas.values()
                for pid in rep.children()]
        assert len(pids) == 2 and all(_alive(p) for p in pids)
        router.stop()
        assert not any(_alive(p) for p in pids)
        assert all(not rep.children() for rep in router.replicas.values())


# ---------------------------------------------------------------------------
# faults of the reference the port does not share
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _warming_spec(base):
    """A spec whose replica stays warming (mid-spawn: unroutable, dead by
    its lease) for good, as a 7B child does for its first seconds."""

    class Warming(base):
        def dead(self, lease_ttl_s):
            return True

        def warming(self):
            return True

        def load(self):
            return 0

        def start(self):
            pass

    class Spec:
        built = []

        def build(self, rid, **kw):
            rep = Warming(rid, object(), **kw)
            self.built.append(rid)
            return rep

    return Spec()


def test_autoscaler_counts_a_warming_replica():
    """The reference's autoscaler leaves a warming process replica out of
    its pool, so one cooldown later, the load unchanged, it spawns
    another (and another, for as long as a 7B child takes to come up).
    The port counts the warming replica's slots: one spawn."""
    from paddle_tpu.serving.fleet import Replica as JaxReplica

    spawned = {}
    for name, mod, eng, base in (
            ("jax", jserving,
             lambda: jserving.ServingEngine(jax_demo_model(), **ENGINE_KW),
             JaxReplica),
            ("torch", sys.modules["paddle_tpu_torch.serving"],
             lambda: ServingEngine(_torch_demo(), device="cpu",
                                   **ENGINE_KW), Replica)):
        clock = _Clock()
        router = mod.FleetRouter([eng()], clock=clock, lease_ttl_s=1000.0)
        for i in range(3):                     # every slot taken
            router.submit([i + 1] * 4, max_new_tokens=4)
        spec = _warming_spec(base)
        scaler = mod.FleetAutoscaler(router, lambda: spec, hi=0.75, lo=0.25,
                                     cooldown_s=1.0, max_replicas=4,
                                     slots_per_replica=3)
        acts = []
        for _ in range(3):
            acts.append(scaler.tick())
            clock.t += 2.0
        spawned[name] = (acts, len(spec.built))
    assert spawned["jax"] == (["up", "up", "up"], 3)
    assert spawned["torch"] == (["up", None, None], 1)


def test_child_that_never_comes_up_exhausts_its_respawns(tmp_path,
                                                         monkeypatch):
    """A child that dies before its first ready line is retried
    `respawn_max` times, then the replica is dead, not warming. (The
    reference counts respawns only after a first incarnation came up, so
    it retries such a child without end.)"""
    # the respawn's flight dump goes to a temporary directory
    monkeypatch.setattr(tflags._registry["metrics_dir"], "value",
                        str(tmp_path / "metrics"))
    store = native.TCPStore("127.0.0.1", 0, is_master=True)
    spec = ProcessReplicaSpec(
        ("127.0.0.1", store.port), factory="no_such_module_here:make",
        engine_kwargs=ENGINE_KW, respawn_max=1, respawn_backoff_s=0.1,
        warmup_timeout_s=60.0, extra_env={"PYTHONPATH": REPO},
        log_dir=str(tmp_path))
    router = FleetRouter(replica_specs=[spec], store=store,
                         prefix="/test/never-up")
    try:
        t0 = time.monotonic()
        assert wait_fleet_ready(router, 60) is False
        assert time.monotonic() - t0 < 55     # no wait for the timeout
        rep = router.replicas["replica-0"]
        assert rep.respawns == 1 and rep.incarnation == 0
        assert rep.last_exit["reason"] == "exit_before_ready"
        assert rep.last_exit["exit_code"] == 1
        assert rep.last_exit["respawn_budget_exhausted"] is True
        assert rep.dead(router.lease_ttl_s) and not rep.warming()
        assert not rep.children()
        assert store.add(f"/test/never-up/fence/{rep.rid}", 0) == 2
        logs = sorted(p.name for p in tmp_path.iterdir()
                      if p.suffix == ".log")
        assert logs == ["replica-0-1.log", "replica-0-2.log"]
        assert "no_such_module_here" in (tmp_path / logs[0]).read_text()
    finally:
        router.stop()
        store.close()

