"""The port's cross-rank observability against the JAX reference, on the
CPU.

observability.cluster.ClusterTelemetry in both packages is fed the same
step records by the same rank threads over each package's InProcStore:
aggregates, straggler events, flags and snapshots must be equal (floats
are the same host arithmetic, so equal exactly), and so must the gauges
they set. Then the flight recorder's `cluster` entry and its membership
and ejection triggers, and ResilientTrainer(cluster=) publishing each step
record of a tiny run (rank 0 aggregating a second rank fed by hand).
"""
import json
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.core import flags as jflags
from paddle_tpu.distributed.env import InProcStore as JaxStore
from paddle_tpu.observability import cluster as jcluster
from paddle_tpu.observability import flight_recorder as jflight
from paddle_tpu.observability import registry as jregistry
from paddle_tpu.observability import reset_all as jreset_all
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.distributed.env import InProcStore
from paddle_tpu_torch.observability import cluster as tcluster
from paddle_tpu_torch.observability import flight_recorder as tflight
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import CheckpointManager
from paddle_tpu_torch.resilience.trainer import ResilientTrainer


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    jreset_all()
    tobs.reset_all()
    for f, tag in ((jflags, "jax"), (tflags, "port")):
        f.set_flags({"metrics": "on",
                     "metrics_dir": str(tmp_path / tag / "metrics")})
    yield
    for f in (jflags, tflags):
        f.set_flags({"metrics": "off", "metrics_dir": ""})
    jreset_all()
    tobs.reset_all()


def _rec(step, *, loss=1.0, compute=0.01, reduce=0.0, grad_norm=1.0,
         tps=1000.0, wall=None):
    return {
        "step": int(step), "loss": loss, "grad_norm": grad_norm,
        "step_wall_s": wall if wall is not None else compute + 0.002,
        "tokens_per_s": tps, "samples_per_s": tps / 64,
        "phases": {"data": 0.001, "compute": compute, "reduce": reduce,
                   "save": 0.0},
    }


def _records(world, steps, seed):
    """Per rank and step, a record: noisy compute and reduce phases, one
    rank slowed from a step on, and a stretch where it recovers."""
    rng = np.random.default_rng(seed)
    slow, start = int(rng.integers(0, world)), int(rng.integers(1, 4))
    out = {}
    for r in range(world):
        for s in range(steps):
            compute = 0.01 + 0.002 * float(rng.random())
            if r == slow and start <= s and not 9 <= s <= 10:
                compute *= 3.5
            out[r, s] = _rec(s, loss=1.0 + 0.1 * r + 0.01 * s,
                             compute=compute,
                             reduce=0.004 * float(rng.random()),
                             tps=1000.0 + r)
    return out


def _run(mod, store, world, steps, recs, m=3):
    cts = [mod.ClusterTelemetry(store, r, world, k=2.0, m=m, timeout_s=10.0)
           for r in range(world)]

    def run_rank(r):
        for s in range(steps):
            cts[r].publish(recs[r, s])

    threads = [threading.Thread(target=run_rank, args=(r,))
               for r in range(1, world)]
    for t in threads:
        t.start()
    run_rank(0)
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return cts[0]


def _strip(obj):
    """Drop wall-clock stamps; everything else must match."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


@pytest.mark.parametrize("world,seed", [(2, 0), (3, 1), (4, 2), (5, 3)])
def test_aggregates_and_straggler_flags_match_the_reference(world, seed):
    steps = 14
    recs = _records(world, steps, seed)
    want = _run(jcluster, JaxStore(), world, steps, recs)
    store = InProcStore()
    got = _run(tcluster, store, world, steps, recs)
    assert _strip(got.aggregates) == _strip(want.aggregates)
    assert _strip(got.straggler_events) == _strip(want.straggler_events)
    assert _strip(got.snapshot()) == _strip(want.snapshot())
    assert store.num_keys() == 0            # every record drained
    assert _strip(tflight.cluster_snapshot()) == \
        _strip(jflight.cluster_snapshot())
    for name, labels in (("cluster_phase_seconds",
                          dict(phase="compute", stat="p95")),
                         ("cluster_loss", dict(stat="median")),
                         ("cluster_step_wall_seconds", dict(stat="max")),
                         ("cluster_tokens_per_second_total", {})):
        assert tregistry.REGISTRY.get(name).value(**labels) == \
            jregistry.REGISTRY.get(name).value(**labels)
    assert tregistry.REGISTRY.get("cluster_aggregated_steps_total") \
        .value() == steps


def test_straggler_event_on_the_rising_edge_only():
    world, steps = 4, 10
    recs = {(r, s): _rec(s, compute=0.05 if r == 2 and s >= 4 else 0.01)
            for r in range(world) for s in range(steps)}
    ct = _run(tcluster, InProcStore(), world, steps, recs)
    (ev,) = ct.straggler_events
    assert (ev["rank"], ev["phase"], ev["step"]) == (2, "compute", 6)
    assert ev["ratio"] > 2.0 and ct.snapshot()["flagged"]["2"]["compute"] \
        == steps - 1


def test_a_silent_rank_times_out_into_an_event(tmp_path):
    """A rank that never publishes costs the aggregator `timeout_s` and
    becomes a cluster_timeout event, not a hang."""
    ct = tcluster.ClusterTelemetry(InProcStore(), 0, 2, timeout_s=0.2)
    agg = ct.publish(_rec(0))
    assert agg["ranks"] == 1
    with open(tmp_path / "port" / "metrics" / "events.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert "cluster_timeout" in kinds


def test_dump_carries_the_cluster_view_and_reset_clears_it():
    tflight.set_cluster_snapshot({"world_size": 4,
                                  "flagged": {"2": {"compute": 9}}})
    path = tflight.get_flight_recorder().dump("forensics")
    with open(path) as f:
        assert json.load(f)["cluster"]["flagged"]["2"]["compute"] == 9
    tflight.reset()
    assert tflight.cluster_snapshot() is None
    with open(tflight.get_flight_recorder().dump("after")) as f:
        assert "cluster" not in json.load(f)


def test_membership_and_ejection_triggers_dump():
    """Both triggers dump with their record attached; the ejection dump is
    the reference's. The reference's membership trigger spreads the change
    into its note, whose own "kind" collides, so it raises (and the
    membership layer swallows it: no dump); the port notes the change
    whole."""
    info = {"gen": 3, "prev_gen": 2, "members": [0, 2], "lost": [1],
            "joined": [], "world_size": 2, "kind": "proposed"}
    eject = {"member": 1, "by": 0, "step": 7, "gen": 2,
             "pinned_windows": 2, "weight": 0.5}
    with open(tflight.on_membership_change(dict(info))) as f:
        member_dump = json.load(f)
    assert member_dump["reason"] == "membership_gen3"
    assert member_dump["membership"] == info
    assert member_dump["events"][-1]["kind"] == "membership_change"
    assert member_dump["events"][-1]["membership"] == info
    with pytest.raises(TypeError, match="kind"):
        jflight.on_membership_change(dict(info))
    dumps = {}
    for name, fr in (("port", tflight), ("jax", jflight)):
        with open(fr.on_member_ejected(dict(eject))) as f:
            dumps[name] = json.load(f)
    for d in dumps.values():
        assert d["reason"] == "eject_member1" and d["ejection"] == eject
    assert _strip(dumps["port"]["events"][-1]) == \
        _strip(dumps["jax"]["events"][-1])
    tflags.set_flags({"metrics": "off"})
    assert tflight.on_membership_change(dict(info)) is None


def test_resilient_trainer_publishes_every_step_record(tmp_path):
    """ResilientTrainer(cluster=) as rank 0 of two: each step's record goes
    through the store. Rank 1 publishes a copy of each record first, its
    compute phase 10x rank 0's from step 2 on, and is flagged at step
    2 + m - 1 (k 1.5: at world 2 the median is the midpoint, so k 2 could
    never flag anyone)."""
    store = InProcStore()
    steps, m = 6, 2
    torch.manual_seed(3)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 1))
    opt = AdamW(0.05, parameters=model.parameters())
    ct0 = tcluster.ClusterTelemetry(store, 0, 2, k=1.5, m=m, timeout_s=30.0)
    ct1 = tcluster.ClusterTelemetry(store, 1, 2, k=1.5, m=m, timeout_s=30.0)
    rng = np.random.RandomState(0)
    batches = [(rng.randn(8, 4).astype(np.float32),
                rng.randn(8, 1).astype(np.float32)) for _ in range(steps)]

    class TwoRanks:
        def publish(self, rec):
            slow = 10.0 if rec["step"] >= 2 else 1.0
            ct1.publish({**rec, "phases": {
                **rec["phases"], "compute": rec["phases"]["compute"] * slow}})
            return ct0.publish(rec)

    tr = ResilientTrainer(model, lambda a, b: ((model(a) - b) ** 2).mean(),
                          opt, CheckpointManager(str(tmp_path / "ck")),
                          save_every=0, cluster=TwoRanks(), device="cpu")
    rep = tr.run(batches)
    assert rep["status"] == "completed"
    assert [a["step"] for a in ct0.aggregates] == list(range(steps))
    assert all(a["ranks"] == 2 for a in ct0.aggregates)
    assert [(e["rank"], e["phase"], e["step"])
            for e in ct0.straggler_events] == [(1, "compute", 2 + m - 1)]
    assert store.num_keys() == 0
