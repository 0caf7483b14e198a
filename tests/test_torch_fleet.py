"""The port's serving fleet against the reference's, on the CPU.

Each scenario of tests/test_fleet.py that runs on a fake clock with the
replicas stepped by hand (`router.poll()` as the monitor tick) runs twice,
once over paddle_tpu.serving and once over paddle_tpu_torch.serving, with
identical weights (a JAX tiny GPT at seed 11, carried into the port by
load_jax_state_dict) and the same request ids. For each scenario the two
fleets must agree exactly on:

  * every request's tokens (and both equal the models' generate());
  * the routing decisions: each request's attempts as (cause, replica,
    cancelled), re-dispatch and hedge counts, KV transfers and migrations;
  * stats() and health() on every key the two share (health's tick age, a
    wall-clock reading, left out);
  * breaker states, registry leases, the autoscaler's events and the
    merged traces' attempt tags.

The scenarios: breaker states, registry leases, jittered Retry-After,
affinity, a kill with re-dispatch, a hedge win with the loser cancelled,
shedding, a faulty replica's breaker, drain and resume, disaggregated
prefill and decode, migration, autoscaler growth and shrinkage, and the
merged trace of a re-dispatched request. FleetServer's HTTP round trip
(with /drain?migrate=1 and a 503) runs the port's real threads and holds
its tokens against the reference fleet's.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.observability import registry as jregistry
from paddle_tpu.observability import reset_all as jreset_all
from paddle_tpu.serving import fleet_observability as jfobs
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     load_jax_state_dict)
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.observability import reset_all as treset_all
from paddle_tpu_torch.serving import fleet_observability as tfobs

ENGINE_KW = dict(max_slots=3, block_size=16, prefill_chunk=16)
VOCAB = JaxGPTConfig.tiny().vocab_size


def _jax_model():
    # every replica seeded alike: replicas must be interchangeable
    paddle.seed(11)
    m = JaxGPT(JaxGPTConfig.tiny())
    m.eval()
    return m


_STATE = {}


def _state():
    if not _STATE:
        _STATE.update({k: np.asarray(v.numpy())
                       for k, v in _jax_model().state_dict().items()})
    return _STATE


def _torch_model():
    m = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(m, _state())
    return m


class _Side:
    """One package's fleet API, so a scenario is written once."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.serving = jserving if jax_side else tserving
        self.flags = jflags if jax_side else tflags
        self.registry = jregistry if jax_side else tregistry
        self.fobs = jfobs if jax_side else tfobs
        self.reset_all = jreset_all if jax_side else treset_all
        self.model = _jax_model if jax_side else _torch_model
        self._kw = {} if jax_side else {"device": "cpu"}

    def engine(self):
        return self.serving.ServingEngine(self.model(), **self._kw,
                                          **ENGINE_KW)

    def fleet(self, n=2, **router_kw):
        return self.serving.FleetRouter([self.engine() for _ in range(n)],
                                        **router_kw)

    def generate(self, prompt, n):
        m = self.model()
        if self.name == "jax":
            out = m.generate(paddle.to_tensor(np.asarray([prompt], np.int32)),
                             max_new_tokens=n).numpy()[0, -n:]
            return [int(t) for t in out]
        return m.generate(torch.tensor([prompt]),
                          max_new_tokens=n)[0].tolist()[-n:]

    def counter(self, name, **labels):
        m = self.registry.REGISTRY.get(name)
        return m.value(**labels) if labels else m.total()


SIDES = (_Side("jax"), _Side("torch"))


def _both(scenario, *args, **kw):
    """Run `scenario(side, ...)` over both packages; returns (jax, torch)
    observations, which must be equal."""
    jax_obs, torch_obs = (scenario(side, *args, **kw) for side in SIDES)
    assert _common(torch_obs, jax_obs) == _common(jax_obs, torch_obs)
    return jax_obs, torch_obs


def _common(a, b):
    """`a` restricted to the keys `b` shares, recursively (stats() and
    health() carry package-specific extras)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: _common(a[k], b[k]) for k in a if k in b}
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) \
            and len(a) == len(b):
        return [_common(x, y) for x, y in zip(a, b)]
    return a


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, VOCAB, n)] for n in lens]


def _drive(router, freqs, max_iters=5000):
    """Manual engine loop and monitor: step every live replica that has
    work, then poll, until every fleet request settles."""
    for _ in range(max_iters):
        if all(f.done for f in freqs):
            return
        for rep in list(router.replicas.values()):
            if not rep._killed and rep.engine.sched.has_work():
                rep.engine.step()
        router.poll()
    raise AssertionError(f"requests did not settle: {[f.done for f in freqs]}")


def _routes(freqs):
    return {f.request_id: [(a.kind, a.replica.rid, a.failed)
                           for a in f.attempts] for f in freqs}


def _observe(router, freqs):
    """Tokens, routes, reasons and the fleet's own counters by request
    id, with stats() and health() (the tick age left out)."""
    health = router.health()
    for snap in health["replicas"].values():
        snap.pop("last_tick_age_s", None)
    return {
        "tokens": {f.request_id: list(f.output_tokens) for f in freqs},
        "reasons": {f.request_id: f.finish_reason for f in freqs},
        "routes": _routes(freqs),
        "fleet": {f.request_id: (f.redispatches, f.hedged, f.migrations,
                                 None if f.kv_streamed is None else
                                 {k: f.kv_streamed[k] for k in (
                                     "imported", "dedup", "rejected",
                                     "skipped", "bytes", "src", "dst",
                                     "kind")})
                  for f in freqs},
        "stats": router.stats(),
        "health": health,
    }


def _fake(side, n=2, **kw):
    fake = [0.0]
    router = side.fleet(n, clock=lambda: fake[0],
                        lease_ttl_s=kw.pop("lease_ttl_s", 1000.0), **kw)
    return fake, router


# ---------------------------------------------------------------- breaker
def _breaker(side):
    fake = [0.0]
    br = side.serving.CircuitBreaker(max_errors=3, cooldown_s=2.0,
                                     clock=lambda: fake[0])
    seen = [(br.state, br.allow())]
    for t, act in ((0.0, "f"), (0.0, "f"), (0.0, "f"), (1.9, None),
                   (2.0, None), (2.0, "allow"), (2.0, "allow"), (2.0, "f"),
                   (4.0, "allow"), (4.0, "s"), (4.0, "allow"),
                   (4.0, "allow")):
        fake[0] = t
        if act == "f":
            br.record_failure()
        elif act == "s":
            br.record_success()
        allowed = br.allow() if act == "allow" else None
        seen.append((br.state, allowed))
    br2 = side.serving.CircuitBreaker(max_errors=2, cooldown_s=1.0)
    br2.record_failure()
    br2.record_success()
    br2.record_failure()
    seen.append(br2.state)          # the streak is consecutive errors
    return seen


def test_circuit_breaker_states_match():
    seen, _ = _both(_breaker)
    assert seen[3] == ("open", None) and seen[5] == ("half_open", None)
    assert seen[6] == ("half_open", True) and seen[7] == ("half_open", False)
    assert seen[-1] == "closed"


# ------------------------------------------------------ registry leases
def _leases(side):
    fake, router = _fake(side, 2, lease_ttl_s=1.0)
    p = _prompts(5, (9, 14))
    freqs = [router.submit(q, max_new_tokens=4, request_id=f"L{i}")
             for i, q in enumerate(p)]
    before = [router.replica_dead(r) for r in router.replicas.values()]
    fake[0] = 2.0                   # both leases lapse; replica-1 renews
    router.registry.heartbeat("replica-1")
    after = [router.replica_dead(r) for r in router.replicas.values()]
    router.poll()                   # replica-0's orphan moves to replica-1
    _drive(router, freqs)
    obs = _observe(router, freqs)
    obs.update(dead=(before, after),
               registry=(router.registry.replicas(),
                         router.registry.meta("replica-0"),
                         router.registry.alive("replica-0", 1.0),
                         router.registry.alive("replica-1", 1.0)),
               routable=[router.routable(r)
                         for r in router.replicas.values()])
    return obs


def test_registry_leases_expire_and_redispatch_alike():
    obs, _ = _both(_leases)
    assert obs["dead"] == ([False, False], [True, False])
    assert obs["routes"]["L0"] == [("primary", "replica-0", True),
                                   ("redispatch", "replica-1", False)]
    assert obs["registry"][0] == ["replica-0", "replica-1"]
    assert obs["registry"][1] == {"blocks": 3 * 16 + 1, "slots": 3}
    assert obs["routable"] == [False, True]


# --------------------------------------------------- Retry-After jitter
def _retry_after(side):
    f = side.flags
    old = (f.get_flag("serving_retry_after_s"),
           f.get_flag("serving_retry_after_jitter"))
    err = side.serving.QueueFullError
    try:
        f.set_flags({"serving_retry_after_s": 2.0,
                     "serving_retry_after_jitter": 0.5})
        vals = {err(1, 1).retry_after_s for _ in range(64)}
        spread = (all(2.0 <= v <= 3.0 for v in vals), len(vals) > 1)
        f.set_flags({"serving_retry_after_jitter": 0.0})
        return [spread, err(1, 1).retry_after_s,
                err(1, 1, retry_after_s=7.5).retry_after_s,
                (err(3, 4).depth, err(3, 4).limit)]
    finally:
        f.set_flags({"serving_retry_after_s": old[0],
                     "serving_retry_after_jitter": old[1]})


def test_retry_after_jitter_matches():
    obs, _ = _both(_retry_after)
    assert obs == [(True, True), 2.0, 7.5, (3, 4)]


# ---------------------------------------------------------- affinity
def _affinity(side):
    fake, router = _fake(side)
    prompt, cold = _prompts(0, (20, 10))
    a = router.submit(prompt, max_new_tokens=4, request_id="A")
    _drive(router, [a])
    b = router.submit(prompt, max_new_tokens=4, request_id="B")
    c = router.submit(cold, max_new_tokens=4, request_id="C")
    _drive(router, [b, c])
    obs = _observe(router, [a, b, c])
    obs["want"] = side.generate(prompt, 4)
    return obs


def test_prefix_affinity_and_least_loaded_routing_match():
    obs, _ = _both(_affinity)
    # the idle tie goes by id; the prompt's chain pulls B back to
    # replica-0; the cold prompt balances away from it
    assert [r[0][1] for r in obs["routes"].values()] == \
        ["replica-0", "replica-0", "replica-1"]
    assert obs["tokens"]["A"] == obs["tokens"]["B"] == obs["want"]


# ------------------------------------------------ kill and re-dispatch
def _kill(side):
    fake, router = _fake(side)
    prompts = _prompts(1, (5, 19, 33, 7))
    red0 = side.counter("fleet_requests_redispatched_total")
    freqs = [router.submit(p, max_new_tokens=8, request_id=f"K{i}")
             for i, p in enumerate(prompts)]
    for _ in range(3):              # partial progress, then the crash
        router.replicas["replica-0"].engine.step()
    router.kill_replica("replica-0")
    router.poll()                   # detect and re-dispatch the orphans
    mid = _routes(freqs)
    _drive(router, freqs)
    obs = _observe(router, freqs)
    obs.update(mid=mid, want=[side.generate(p, 8) for p in prompts],
               redispatched=side.counter(
                   "fleet_requests_redispatched_total") - red0,
               routable=router.routable(router.replicas["replica-0"]))
    return obs


def test_kill_redispatch_matches_and_loses_nothing():
    obs, _ = _both(_kill)
    assert list(obs["tokens"].values()) == obs["want"]
    assert set(obs["reasons"].values()) == {"length"}
    assert obs["redispatched"] == 2 and not obs["routable"]
    assert obs["health"]["ok"]
    moved = [r for r in obs["mid"].values() if len(r) == 2]
    assert len(moved) == 2 and all(
        r == [("primary", "replica-0", True),
              ("redispatch", "replica-1", False)] for r in moved)


# ------------------------------------------------------------- hedges
def _hedge(side):
    fake, router = _fake(side, hedge_ttft_ms=50.0)
    (prompt,) = _prompts(2, (6,))
    wins0 = side.counter("fleet_hedge_wins_total", winner="hedge")
    freq = router.submit(prompt, max_new_tokens=6, request_id="H")
    r0 = router.replicas["replica-0"].engine
    r0.step()                       # admitted and prefilling, no token
    router.poll()
    early = freq.hedged
    fake[0] = 0.1                   # past the 50 ms deadline
    router.poll()
    r1 = router.replicas["replica-1"].engine
    for _ in range(2000):           # only the hedge arm makes progress
        if freq.done:
            break
        if r1.sched.has_work():
            r1.step()
        router.poll()
    obs = _observe(router, [freq])
    st = r0.stats()
    obs.update(early=early, want=side.generate(prompt, 6),
               wins=side.counter("fleet_hedge_wins_total",
                                 winner="hedge") - wins0,
               loser=(st["running"], st["waiting"], st["prefilling"],
                      st["reserved_blocks"]))
    return obs


def test_hedge_wins_and_cancels_the_loser_alike():
    obs, _ = _both(_hedge)
    assert not obs["early"] and obs["wins"] == 1
    assert obs["routes"]["H"] == [("primary", "replica-0", True),
                                  ("hedge", "replica-1", False)]
    assert obs["tokens"]["H"] == obs["want"]
    assert obs["loser"] == (0, 0, 0, 0)     # slot and KV freed at once


# ------------------------------------------------------------ shedding
def _shed(side):
    f = side.flags
    old = f.get_flag("serving_max_queue")
    f.set_flags({"serving_max_queue": 1})
    try:
        fake, router = _fake(side)
        full0 = side.counter("fleet_requests_shed_total",
                             reason="queue_full")
        a = router.submit([1, 2, 3], request_id="S0")
        b = router.submit([4, 5, 6], request_id="S1")
        with pytest.raises(side.serving.QueueFullError) as ei:
            router.submit([7, 8, 9], request_id="S2")
        out = [_routes([a, b]), ei.value.retry_after_s > 0,
               side.counter("fleet_requests_shed_total",
                            reason="queue_full") - full0]
    finally:
        f.set_flags({"serving_max_queue": old})
    fake, router = _fake(side)
    none0 = side.counter("fleet_requests_shed_total",
                         reason="no_healthy_replica")
    router.kill_replica("replica-0")
    router.kill_replica("replica-1")
    with pytest.raises(side.serving.QueueFullError):
        router.submit([1, 2, 3])
    out += [side.counter("fleet_requests_shed_total",
                         reason="no_healthy_replica") - none0,
            router.health()["ok"]]
    return out


def test_fleet_sheds_alike():
    obs, _ = _both(_shed)
    assert obs == [{"S0": [("primary", "replica-0", False)],
                    "S1": [("primary", "replica-1", False)]},
                   True, 1.0, 1.0, False]


# ------------------------------------------------ a faulty replica
def _faulty(side):
    fake, router = _fake(side, breaker_errors=2, breaker_cooldown_s=5.0)
    r0 = router.replicas["replica-0"]
    real_submit = r0.engine.submit

    def bad_submit(*a, **kw):
        raise RuntimeError("injected submit fault")

    r0.engine.submit = bad_submit
    states = []
    a = router.submit([1, 2, 3], max_new_tokens=2, request_id="F0")
    states.append(r0.breaker.state)
    b = router.submit([4, 5, 6], max_new_tokens=2, request_id="F1")
    states += [r0.breaker.state, router.routable(r0),
               router.health()["replicas"]["replica-0"]["breaker"]]
    r0.engine.submit = real_submit
    fake[0] = 5.0
    states.append(r0.breaker.state)
    router.poll()
    c = router.submit([7, 8, 9], max_new_tokens=2, request_id="F2")
    states.append(r0.breaker.state)
    _drive(router, [a, b, c])
    obs = _observe(router, [a, b, c])
    obs.update(states=states,
               transitions=[(t["replica"], t["from"], t["to"])
                            for t in router.obs._breaker_log])
    return obs


def test_breaker_takes_a_faulty_replica_out_alike():
    obs, _ = _both(_faulty)
    assert obs["states"] == ["closed", "open", False, "open", "half_open",
                             "closed"]
    assert [r[0][1] for r in obs["routes"].values()] == \
        ["replica-1", "replica-1", "replica-0"]
    assert ("replica-0", "closed", "open") in obs["transitions"]
    assert ("replica-0", "half_open", "closed") in obs["transitions"]


# ---------------------------------------------------- drain and resume
def _drain(side):
    fake, router = _fake(side)
    (prompt,) = _prompts(3, (12,))
    a = router.submit(prompt, max_new_tokens=20, request_id="D0")
    router.drain("replica-0")
    refused = False
    try:
        router.replicas["replica-0"].engine.submit([1, 2, 3])
    except side.serving.EngineDrainingError:
        refused = True
    b = router.submit(prompt, max_new_tokens=4, request_id="D1")
    health = router.health()
    snap = health["replicas"]["replica-0"]
    # the loops never run here (a status of "dead"): the router's flag
    draining = (health["ok"], snap["draining"], snap["ok"],
                router.drained("replica-0"))
    _drive(router, [a, b])
    dry = router.drained("replica-0")
    router.resume("replica-0")
    resumed = router.health()["replicas"]["replica-0"]["draining"]
    c = router.submit(prompt, max_new_tokens=4, request_id="D2")
    _drive(router, [c])
    obs = _observe(router, [a, b, c])
    obs.update(refused=refused, draining=draining, dry=dry,
               resumed=resumed, want=side.generate(prompt, 20))
    return obs


def test_drain_routes_around_and_resume_restores_alike():
    obs, _ = _both(_drain)
    assert obs["refused"] and obs["dry"]
    assert obs["draining"] == (True, True, False, False)
    assert obs["resumed"] is False
    assert [r[0][1] for r in obs["routes"].values()] == \
        ["replica-0", "replica-1", "replica-0"]
    assert obs["tokens"]["D0"] == obs["want"]
    assert obs["tokens"]["D1"] == obs["tokens"]["D2"] == obs["want"][:4]


# ------------------------------------------------------ disaggregation
def _disagg(side):
    fake, router = _fake(side, 3, roles="prefill:1,decode:2")
    prompts = _prompts(21, (32, 32, 32, 32))
    freqs = [router.submit(p, max_new_tokens=6, request_id=f"G{i}")
             for i, p in enumerate(prompts)]
    _drive(router, freqs)
    obs = _observe(router, freqs)
    obs.update(want=[side.generate(p, 6) for p in prompts],
               roles=[r.role for r in router.replicas.values()],
               prefill_tokens={rid: r.engine.prefill_tokens
                               for rid, r in router.replicas.items()},
               matched={f.request_id: [a.req.prefix_matched
                                       for a in f.attempts]
                        for f in freqs})
    return obs


def test_disaggregated_prefill_streams_kv_alike():
    obs, _ = _both(_disagg, )
    assert list(obs["tokens"].values()) == obs["want"]
    assert obs["roles"] == ["prefill", "decode", "decode"]
    for rid, routes in obs["routes"].items():
        assert routes[0][:2] == ("prefill", "replica-0")
        (win,) = [r for r in routes if not r[2]]
        assert win[0] == "decode" and win[1] != "replica-0"
        ks = obs["fleet"][rid][3]
        assert ks["kind"] == "prefill" and ks["imported"] + ks["dedup"] == 2
        assert obs["matched"][rid][-1] == 32     # a full prefix hit
    # the decode replicas computed no prefill token
    assert obs["prefill_tokens"]["replica-1"] == 0
    assert obs["prefill_tokens"]["replica-2"] == 0
    assert obs["prefill_tokens"]["replica-0"] > 0


# ----------------------------------------------------------- migration
def _migrate(side):
    fake, router = _fake(side)
    (prompt,) = _prompts(22, (32,))
    f = router.submit(prompt, max_new_tokens=48, request_id="M")
    rep = f.attempts[0].replica
    for _ in range(8):              # two prefill chunks and some decode
        rep.engine.step()
    state = rep.engine.snapshot_output(f.attempts[0].req)[1]
    router.drain(rep.rid, migrate=True)
    migrations = f.migrations
    _drive(router, [f])
    mig = f.attempts[1]
    obs = _observe(router, [f])
    obs.update(state=state, migrations=migrations,
               matched=mig.req.prefix_matched,
               survivor_prefill=mig.replica.engine.prefill_tokens,
               drained=router.drained(rep.rid),
               kv=dict(f.kv_streamed),
               want=side.generate(prompt, 48))
    return obs


def test_drain_migrates_mid_decode_alike():
    obs, tobs = _both(_migrate)
    # the port times each half of the transfer (keys the reference lacks)
    assert tobs["kv"]["export_s"] >= 0 and tobs["kv"]["ingest_s"] >= 0
    assert obs["state"] != "finished" and obs["migrations"] == 1
    assert obs["routes"]["M"] == [("primary", "replica-0", True),
                                  ("migrate", "replica-1", False)]
    assert obs["matched"] == 32 and obs["survivor_prefill"] == 0
    assert obs["tokens"]["M"] == obs["want"] and obs["drained"]
    assert obs["fleet"]["M"][3]["kind"] == "migrate"


# ---------------------------------------------------------- autoscaler
def _autoscale(side):
    fake, router = _fake(side, 1)
    scaler = side.serving.FleetAutoscaler(
        router, side.engine, min_replicas=1, max_replicas=3, hi=0.75,
        lo=0.25, cooldown_s=1.0)
    router.attach_autoscaler(scaler)
    prompts = _prompts(23, (8,) * 8)
    freqs = [router.submit(p, max_new_tokens=6, request_id=f"U{i}")
             for i, p in enumerate(prompts)]
    grown = []
    for _ in range(8):
        fake[0] += 1.1
        router.poll()
        grown.append(len(router.replicas))
        if len(router.replicas) == 3:
            break
    _drive(router, freqs)
    obs = _observe(router, freqs)
    shrunk = []
    for _ in range(64):
        fake[0] += 1.1
        router.poll()
        shrunk.append(len(router.replicas))
        if (scaler._retiring is None
                and len(router.replicas) == scaler.min_replicas):
            break
    obs.update(grown=grown, shrunk=shrunk,
               events=[(e["dir"], e["replica"], e["utilization"],
                        e["replicas"]) for e in scaler.events],
               scale_log=[(e["direction"], e["replica"], e["replicas"])
                          for e in router.obs.scale_log()],
               left=list(router.replicas),
               want=[side.generate(p, 6) for p in prompts])
    return obs


def test_autoscaler_grows_and_shrinks_alike():
    obs, _ = _both(_autoscale)
    assert obs["grown"][-1] == 3 and obs["shrunk"][-1] == 1
    assert [e[0] for e in obs["events"]] == ["up", "up", "down", "down"]
    assert len(obs["scale_log"]) == 4
    assert list(obs["tokens"].values()) == obs["want"]


# ------------------------------------------------------- merged traces
def _traced(side):
    side.reset_all()
    side.flags.set_flags({"metrics": "on"})
    try:
        fake, router = _fake(side)
        (prompt,) = _prompts(7, (8,))
        freq = router.submit(prompt, max_new_tokens=6, request_id="T")
        ctx0 = freq.attempts[0].req.trace_ctx
        for _ in range(3):
            router.replicas["replica-0"].engine.step()
        router.kill_replica("replica-0")
        router.poll()
        _drive(router, [freq])
        evs = router.obs.trace_payload("T")["traceEvents"]
        xs = [e for e in evs if e.get("ph") == "X"]
        return {
            "ctx": [ctx0, freq.attempts[1].req.trace_ctx],
            "tags": sorted({(e["args"]["attempt"], e["args"]["cause"],
                             e["args"].get("cancelled", False))
                            for e in xs if e["pid"] != 0}),
            "lanes": sorted({e["pid"] for e in xs}),
            "router_spans": sorted(e["name"] for e in xs if e["pid"] == 0),
            "coverage": side.fobs.coverage_of(evs) >= 0.99,
            "unparented": side.fobs.unparented_spans(evs, "T"),
            "unknown": router.obs.trace_payload("nope"),
            "rollups": sorted(router.obs.publish_rollups()),
        }
    finally:
        side.flags.set_flags({"metrics": "off"})
        side.reset_all()


def test_redispatch_merged_trace_matches():
    obs, _ = _both(_traced)
    assert obs["ctx"] == [
        {"fleet_request_id": "T", "attempt": 0, "cause": "primary"},
        {"fleet_request_id": "T", "attempt": 1, "cause": "redispatch"}]
    assert obs["tags"] == [(0, "primary", True), (1, "redispatch", False)]
    assert obs["lanes"] == [0, 1, 2]
    assert obs["router_spans"].count("fleet.route") == 2
    assert "fleet.queue" in obs["router_spans"]
    assert obs["coverage"] and obs["unparented"] == []
    assert obs["unknown"] is None
    assert obs["rollups"] == ["e2e", "queue", "route", "ttft"]


def test_disaggregated_handoff_under_threads_is_one_decode_attempt(
        monkeypatch):
    """Real threads: the waiter's settle streams the KV while the monitor
    polls. A slow stream (0.2 s) holds the request between its finished
    prefill and its decode placement for ten polls; the port must not
    take it for an orphan (the reference re-dispatches it there: a full
    prefill on the decode replica beside the handoff's decode attempt)."""
    import time

    _, torch_side = SIDES
    router = torch_side.fleet(2, roles="prefill:1,decode:1",
                              poll_interval_s=0.02)
    stream = router._stream_kv

    def slow_stream(*a, **kw):
        time.sleep(0.2)
        return stream(*a, **kw)

    monkeypatch.setattr(router, "_stream_kv", slow_stream)
    prompts = _prompts(31, (16, 32, 48))
    router.start()
    try:
        freqs = [router.submit(p, max_new_tokens=6) for p in prompts]
        assert all(f.wait(timeout=120) for f in freqs)
    finally:
        router.stop()
    for f, p in zip(freqs, prompts):
        assert [(a.kind, a.replica.rid) for a in f.attempts] == \
            [("prefill", "replica-0"), ("decode", "replica-1")]
        assert f.output_tokens == torch_side.generate(p, 6)
    assert router.replicas["replica-1"].engine.prefill_tokens == 0
    assert all(r.breaker.failures == 0 for r in router.replicas.values())


def test_launch_counts_lose_no_update_and_captures_count_their_own():
    """Replica threads replay graphs (adding each replay's launches to the
    shared counts) while another thread captures an engine (its launches
    recorded apart, `ops.gpu.recording()`): 16 threads on a shortened
    switch interval, half counting and adding, half recording; no update
    may be lost and no recorder may see another thread's launches."""
    import sys
    import threading

    from paddle_tpu_torch.ops import gpu
    from paddle_tpu_torch.ops.gpu import _counts

    fn = gpu.KERNEL_WRAPPERS["rms_norm"]
    gpu.reset_launch_counts()
    recorded, n = [], 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def replay():
        for _ in range(n):
            _counts.count(fn)
            gpu.add_launch_counts({"rms_norm": 2})

    def capture():
        with gpu.recording() as rec:
            for _ in range(n):
                _counts.count(fn)
        recorded.append(rec)

    try:
        threads = [threading.Thread(target=replay if i % 2 else capture)
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert gpu.launch_counts(("rms_norm",))["rms_norm"] == 8 * 3 * n
    assert recorded == [{"rms_norm": n}] * 8
    gpu.reset_launch_counts()


# ---------------------------------------------------------------- HTTP
def _post(url, obj, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_fleet_server_roundtrip_drain_and_shed():
    (prompt,) = _prompts(4, (5,))
    jax_side, torch_side = SIDES
    _, jrouter = _fake(jax_side)
    jf = jrouter.submit(prompt, max_new_tokens=4, request_id="W")
    _drive(jrouter, [jf])
    router = torch_side.fleet(2)
    srv = tserving.FleetServer(router, port=0)
    old = tflags.get_flag("serving_max_queue")
    try:
        code, out = _post(srv.url() + "/generate",
                          {"prompt": prompt, "max_new_tokens": 4})
        assert code == 200 and out["finish_reason"] == "length"
        assert out["output_tokens"] == jf.output_tokens
        assert out["output_tokens"] == torch_side.generate(prompt, 4)
        assert out["fleet"] == {"redispatches": 0, "hedged": False}
        code, health = _get(srv.url() + "/healthz")
        assert code == 200 and health["ok"] is True
        assert set(health["replicas"]) == {"replica-0", "replica-1"}
        code, st = _get(srv.url() + "/stats")
        assert set(st["replicas"]) == {"replica-0", "replica-1"}
        assert _common(st, jrouter.stats()).keys() == \
            jrouter.stats().keys()
        # a drain that migrates, over the wire, then a resume
        code, out = _post(srv.url() + "/drain?migrate=1",
                          {"replica": "replica-0"})
        assert out["status"] == "draining"
        _, health = _get(srv.url() + "/healthz")
        assert health["replicas"]["replica-0"]["status"] == "draining"
        assert health["ok"] is True
        code, out = _post(srv.url() + "/resume", {"replica": "replica-0"})
        assert out["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url() + "/drain", {"replica": "nope"})
        assert ei.value.code == 404
        # every queue full: both loops paused, one request queued on each
        tflags.set_flags({"serving_max_queue": 1})
        for rep in router.replicas.values():
            rep.pause()
        fillers = [router.submit([1, 2, 3], max_new_tokens=2),
                   router.submit([4, 5, 6], max_new_tokens=2)]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url() + "/generate",
                  {"prompt": prompt, "max_new_tokens": 4})
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["retry_after_s"] > 0
        for rep in router.replicas.values():
            rep.unpause()
        assert all(f.wait(timeout=120) for f in fillers)
        assert all(r.breaker.failures == 0 for r in router.replicas.values())
    finally:
        tflags.set_flags({"serving_max_queue": old})
        srv.stop()


def test_build_fleet_and_the_fleet_exports():
    router = tserving.build_fleet(_torch_model, 2, device="cpu",
                                  **ENGINE_KW)
    assert [r.engine.device.type for r in router.replicas.values()] == \
        ["cpu", "cpu"]
    assert router.replicas["replica-0"].engine.model is not \
        router.replicas["replica-1"].engine.model
    for name in ("FleetRouter", "FleetRequest", "FleetAutoscaler",
                 "FleetServer", "CircuitBreaker", "build_fleet",
                 "parse_fleet_roles", "export_fleet_trace",
                 "build_process_fleet", "wait_fleet_ready",
                 "ProcessReplica", "ProcessReplicaSpec"):
        assert name in tserving.__all__ and hasattr(tserving, name)
        assert name in jserving.__all__
    for spec, n in ((None, 3), ("symmetric", 2), ("prefill:1,decode:2", 3)):
        assert tserving.parse_fleet_roles(spec, n) == \
            jserving.parse_fleet_roles(spec, n)
    for spec, n in (("prefill:1,decode:1", 3), ("oracle:2", 2)):
        with pytest.raises(ValueError):
            tserving.parse_fleet_roles(spec, n)
