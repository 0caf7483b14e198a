"""The port's elastic training against the JAX reference, on the CPU.

The rank-sharded checkpoint (distributed.checkpoint): `split_bounds`, the
on-disk layout byte for byte, and resharding across the packages (one
saves at world 4, the other loads at 3, 2 and 1, bitwise). Membership
(distributed.elastic) over InProcStore: the same operation sequences on
both packages observe the same views, leases and joins, on fake clocks.
The store exchange: the wire format read by the other package, and a
timeout that names the missing members. The synchronised sharded commit:
four thread ranks commit what the reference restores, the reference's
commit restores in the port, a leader or shard crash commits nothing and
names the dead, generations stay apart. The rebalancer: the same walls
give the same shares, weights and streaks. chaos's rank helpers, and
PreemptionHandler.attach_elastic. TrainStep.forward_backward.

ElasticTrainer end to end, threads as ranks over one InProcStore: a
two-layer MLP whose weights the port loads from the reference's
(models.convert.load_jax_state_dict), AdamW at lr 0.05, 16-row global
batches; the same run in both packages for a clean world, a rank kill, a
join and an auto-ejection. Losses agree within 1e-5 relative step by step
(AdamW in fp32: the port's fused kernel's plain version against the
reference's `functional_update`, the TrainStep parity test's bound);
the membership history (statuses, reforms, ejections) is the same, and
the port's survivors hold bitwise-equal parameters. A tiny GPT's two-rank
run, and a checkpoint the reference's trainer wrote that the port resumes,
to the same bound.
"""
import os
import subprocess
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed import elastic as jel
from paddle_tpu.distributed.env import InProcStore as JaxStore
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.resilience import CheckpointManager as JaxManager
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu.resilience import elastic as jrel
from paddle_tpu.resilience.preemption import \
    PreemptionHandler as JaxPreemption
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed import elastic as tel
from paddle_tpu_torch.distributed.env import InProcStore
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.observability import registry as tregistry
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.resilience import CheckpointManager, chaos
from paddle_tpu_torch.resilience import elastic as trel
from paddle_tpu_torch.resilience.preemption import PreemptionHandler

JAX = SimpleNamespace(Store=JaxStore, el=jel, ck=jck, rel=jrel,
                      Manager=JaxManager, chaos=jchaos)
PORT = SimpleNamespace(Store=InProcStore, el=tel, ck=tck, rel=trel,
                       Manager=CheckpointManager, chaos=chaos)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _chaos_clear():
    chaos.clear()
    jchaos.clear()
    yield
    chaos.clear()
    jchaos.clear()


def _both(script):
    """script(package) -> observations; both packages must observe the
    same."""
    want = script(JAX)
    got = script(PORT)
    assert got == want
    return got


# ------------------------------------------------------------ split bounds
def test_split_bounds_match_the_reference_and_numpy():
    for n in (0, 1, 2, 5, 7, 16, 33, 100):
        for world in (1, 2, 3, 4, 7, 8):
            bounds = tck.split_bounds(n, world)
            assert bounds == jck.split_bounds(n, world)
            arr = np.arange(n)
            for (a, b), piece in zip(bounds, np.array_split(arr, world)):
                assert np.array_equal(arr[a:b], piece)
    for mod in (tck, jck):
        with pytest.raises(ValueError):
            mod.split_bounds(4, 0)


# ------------------------------------------------------- the shard format
def _states(seed=7):
    """The same state as the reference's leaves and as the port's."""
    rng = np.random.RandomState(seed)
    w = rng.randn(7, 3).astype(np.float32)      # odd leading dim
    b = rng.randn(5).astype(np.float32)
    deep = rng.randn(4, 2, 3).astype(np.float32)
    half = torch.from_numpy(rng.randn(6, 2).astype(np.float32)) \
        .to(torch.bfloat16)
    ids = np.arange(9, dtype=np.int32)
    ref = {"w": w, "b": b, "step": np.int64(42),
           "nested": [deep, {"ids": ids}],
           "half": jnp.asarray(half.float().numpy()).astype(jnp.bfloat16)}
    port = {"w": torch.from_numpy(w), "b": b, "step": np.int64(42),
            "nested": [torch.from_numpy(deep), {"ids": torch.from_numpy(ids)}],
            "half": half}
    return ref, port


def _write_world(mod, path, state, world, nonce="abc123"):
    index = None
    for r in range(world):
        index = mod.write_rank_shard(path, r, world, state, nonce)
    mod.write_shard_index(path, index)


def _host(x):
    """A leaf as numpy words (bf16 as its uint16 words)."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [_host(tree)]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_the_port_writes_the_reference_layout_byte_for_byte(tmp_path):
    ref, port = _states()
    _write_world(jck, str(tmp_path / "ref"), ref, 4)
    _write_world(tck, str(tmp_path / "port"), port, 4)
    want, got = _files(str(tmp_path / "ref")), _files(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) and len(got) > 10
    assert all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_at_4_load_at_3_2_1_bitwise_across_packages(tmp_path, writer):
    """One package saves at world 4; the other reads every target rank at
    worlds 3, 2 and 1, and the slices reassemble bitwise into the
    gather-and-reslice oracle (scalars replicate to every rank)."""
    ref, port = _states()
    w_mod, r_mod = (tck, jck) if writer == "port" else (jck, tck)
    path = str(tmp_path / "ck")
    _write_world(w_mod, path, port if writer == "port" else ref, 4)
    assert r_mod.validate_rank_sharded(path) is None
    src = _flat(ref)
    for target in (3, 2, 1):
        gathered = []
        for tr in range(target):
            got = _flat(r_mod.load_sharded(path, target_world_size=target,
                                           target_rank=tr))
            assert len(got) == len(src)
            for g, s in zip(got, src):
                if s.ndim == 0:
                    assert g.tobytes() == s.tobytes() and g.dtype == s.dtype
            gathered.append(got)
        for i, s in enumerate(src):
            if s.ndim == 0:
                continue
            whole = np.concatenate([g[i] for g in gathered], axis=0)
            oracle = np.concatenate(
                [s[a:b] for a, b in tck.split_bounds(s.shape[0], target)])
            assert whole.dtype == s.dtype
            assert whole.tobytes() == s.tobytes() == oracle.tobytes()


def test_slices_nonces_ranks_and_damage(tmp_path):
    _, port = _states()
    path = str(tmp_path / "ck")
    _write_world(tck, path, port, 4)
    w = port["w"].numpy()
    for target in (1, 2, 3, 4):
        for tr, (a, b) in enumerate(tck.split_bounds(7, target)):
            got = tck.load_sharded(path, target_world_size=target,
                                   target_rank=tr)["w"]
            assert got.numpy().tobytes() == w[a:b].tobytes()
    with pytest.raises(ValueError):
        tck.load_sharded(path, target_world_size=2, target_rank=2)
    # the template places leaves on its devices, dtypes kept
    got = tck.load_sharded(path, template={"w": torch.zeros(7, 3)},
                           target_world_size=1)
    assert got["half"].dtype == torch.bfloat16
    mixed = str(tmp_path / "mixed")
    _write_world(tck, mixed, port, 2, nonce="good")
    tck.write_rank_shard(mixed, 1, 2, port, nonce="evil")
    assert "nonce" in tck.validate_rank_sharded(mixed)
    with open(os.path.join(path, "shard_00002", "arr_0.bin"), "r+b") as f:
        f.write(b"\xff")
    assert "checksum mismatch in shard 2" in tck.validate_rank_sharded(path)
    torn = str(tmp_path / "torn")
    _write_world(tck, torn, port, 4)
    os.remove(os.path.join(torn, "shard_00003", "shard.json"))
    assert tck.validate_rank_sharded(torn) == "missing shard 3/4"
    with pytest.raises(NotImplementedError, match="Orbax"):
        tck.load_sharded(str(tmp_path / "nowhere"))


# ------------------------------------------------------ membership protocol
def _members(pkg, store, ids, clock, ttl=1.5):
    return {i: pkg.el.ElasticMembership(store, i, ids, clock=clock,
                                        lease_ttl_s=ttl, heartbeat_s=0.25)
            for i in ids}


def _v(view):
    return None if view is None else (view.gen, list(view.members))


def test_lease_expiry_stale_generations_and_dp_ranks():
    def script(pkg):
        store, fake = pkg.Store(), [0.0]
        ms = _members(pkg, store, [0, 1, 2, 3], lambda: fake[0])
        out = [_v(m.view) for m in ms.values()] + [_v(ms[0].poll())]
        fake[0] = 5.0
        for i in (0, 1, 3):
            ms[i].heartbeat()
        out += [_v(ms[0].poll()), _v(ms[1].poll()), _v(ms[3].poll()),
                ms[1].view.dp_rank(3)]
        try:
            ms[1].view.dp_rank(2)
        except ValueError as e:
            out.append(str(e))
        out += [ms[0].publish_view(pkg.el.MembershipView(4, [0, 1])),
                ms[1].publish_view(pkg.el.MembershipView(3, [0])),
                ms[1].publish_view(pkg.el.MembershipView(4, [0])),
                _v(ms[1].poll()), _v(ms[0].published_view()),
                [c["kind"] for c in ms[1].changes]]
        return out

    _both(script)


def test_leave_join_eject_and_late_construction():
    def script(pkg):
        store, fake = pkg.Store(), [0.0]
        ms = _members(pkg, store, [0, 1, 2], lambda: fake[0])
        ms[2].leave()
        joiner = pkg.el.ElasticMembership(store, 9, [9],
                                          clock=lambda: fake[0],
                                          lease_ttl_s=1.5, heartbeat_s=0.25)
        out = [_v(joiner.view)]
        n = store.add(joiner._k("join_seq"), 1)
        store.set(joiner._k("join", n), "9")
        out += [joiner.pending_joins(), _v(ms[0].poll()), _v(ms[1].poll()),
                _v(joiner.poll()), joiner.view.dp_rank(9)]
        out += [_v(ms[0].eject(9)), _v(ms[1].poll())]
        late = pkg.el.ElasticMembership(store, 1, [0, 1, 2],
                                        clock=lambda: fake[0])
        out += [_v(late.view), ms[0].changes[-1]["lost"],
                ms[0].is_alive(9), ms[0].heartbeat_age(42)]
        return out

    _both(script)


def test_request_join_sponsored_by_an_incumbent_and_counted():
    def script(pkg):
        store, fake = pkg.Store(), [0.0]
        ms = _members(pkg, store, [0, 1], lambda: fake[0])
        joiner = pkg.el.ElasticMembership(store, 7, [7],
                                          clock=lambda: fake[0])
        got = {}
        t = threading.Thread(target=lambda: got.setdefault(
            "view", joiner.request_join(timeout_s=10)))
        t.start()
        deadline = time.monotonic() + 10
        while "view" not in got and time.monotonic() < deadline:
            ms[0].poll()
            time.sleep(0.01)
        t.join(timeout=5)
        return [_v(got.get("view")), _v(ms[1].poll()),
                [(c["kind"], c["joined"]) for c in ms[0].changes]]

    before = tregistry.REGISTRY.get(
        "elastic_membership_changes_total").value(kind="grow")
    assert _both(script)[0] == (1, [0, 1, 7])
    after = tregistry.REGISTRY.get(
        "elastic_membership_changes_total").value(kind="grow")
    assert after == before + 3   # proposer, joiner and member 1 adopt it


# ----------------------------------------------------------- store exchange
def test_the_wire_format_crosses_the_packages():
    arrays = [np.random.RandomState(0).randn(5, 3).astype(np.float32),
              np.arange(7, dtype=np.int64), np.float32(3.0)]
    meta = {"n": 2, "loss": 1.5, "wall_s": 0.25, "member": 3}
    for pack, unpack in ((tel._pack, jel._unpack), (jel._pack, tel._unpack),
                         (tel._pack, tel._unpack)):
        got_meta, got = unpack(bytes(pack(meta, arrays)))
        assert got_meta == meta
        for g, a in zip(got, arrays):
            assert g.dtype == a.dtype and np.array_equal(g.reshape(a.shape),
                                                         a)


def test_a_zip64_contribution_crosses_the_packages(monkeypatch):
    """Past 4 GB (a GPT-3 1.3B member's gradients) the npz ends in zip64
    records, one of which holds an absolute position: packed after the
    header, it must read as the npz written alone. A small ZIP64_LIMIT
    makes zipfile write those records for a small payload."""
    import zipfile

    arrays = [np.arange(40, dtype=np.float32), np.ones((3, 4), np.int64)]
    monkeypatch.setattr(zipfile, "ZIP64_LIMIT", 16)
    packed = {"port": bytes(tel._pack({"n": 1}, arrays)),
              "reference": jel._pack({"n": 1}, arrays)}
    monkeypatch.undo()
    for raw in packed.values():
        for unpack in (tel._unpack, jel._unpack):
            meta, got = unpack(raw)
            assert meta == {"n": 1}
            assert all(np.array_equal(g, a) for g, a in zip(got, arrays))


def test_reducer_timeout_names_the_missing_members():
    def script(pkg):
        store = pkg.Store()
        r = pkg.el.StoreReducer(store, 0)
        r.publish(0, 1, {"n": 1}, [np.zeros(2, np.float32)])
        try:
            r.collect(0, 1, [0, 3, 5], timeout_s=0.3)
        except pkg.el.PeerLostError as e:
            return [e.missing, e.present, e.step, str(e)]

    assert _both(script)[0] == (3, 5)


def test_reducer_gc_keeps_two_steps_and_counts_a_retry_once():
    store = InProcStore()
    r = tel.StoreReducer(store, 4)
    for step in (0, 1, 1, 2):            # step 1 republished (a retry)
        r.publish(0, step, {"n": 1}, [np.full(3, step, np.float32)])
    keys = [r._key(0, s, 4) for s in range(3)]
    assert [store.get(k, blocking=False) is not None for k in keys] == \
        [False, True, True]
    got = tel.StoreReducer(store, 0).collect(0, 2, [4])
    assert got[4][0] == {"n": 1} and got[4][1][0].tolist() == [2.0] * 3
    r.reset()                            # a reform: the old keys go
    assert store.num_keys() == 0


# ---------------------------------------------------- the sharded commit
def _threaded_saves(pkg, root, store, state, step=1, world=4, ns="g0",
                    timeout=15.0, backend="sharded"):
    errs = {}

    def save(r):
        mgr = pkg.Manager(root, backend=backend, store=store, rank=r,
                          world_size=world, sync_timeout_s=timeout,
                          commit_namespace=ns)
        try:
            mgr.save(step, state, meta={"step": step})
        except BaseException as e:  # noqa: BLE001 — collected for asserts
            errs[r] = e

    ts = [threading.Thread(target=save, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return errs


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_four_rank_commit_restores_in_both_packages(tmp_path, writer):
    ref, port = _states()
    pkg = PORT if writer == "port" else JAX
    root = str(tmp_path / "ck")
    errs = _threaded_saves(pkg, root, pkg.Store(),
                           port if writer == "port" else ref)
    assert not errs
    src = _flat(ref)
    for mgr in (CheckpointManager(root, backend="sharded"),
                JaxManager(root, backend="sharded")):
        assert mgr.latest_step() == 1
        assert mgr.validate(mgr._dir_for(1)) is None
        got = mgr.restore_latest(target_world_size=1, target_rank=0)
        assert got.meta == {"step": 1}
        assert [g.tobytes() for g in _flat(got.state)] == \
            [s.tobytes() for s in src]
    # rank 1 of 3 of the port reads its rows
    part = CheckpointManager(root, backend="sharded", rank=1,
                             world_size=3).restore_latest()
    a, b = tck.split_bounds(7, 3)[1]
    assert part.state["w"].numpy().tobytes() == ref["w"][a:b].tobytes()


def test_leader_crash_before_the_nonce_commits_nothing(tmp_path):
    chaos.inject_crash("ckpt.begin")
    errs = _threaded_saves(PORT, str(tmp_path / "ck"), InProcStore(),
                           _states()[1], world=2, timeout=1.0)
    assert isinstance(errs[0], chaos.InjectedCrash)
    assert isinstance(errs[1], TimeoutError) and "nonce" in str(errs[1])
    assert not os.path.isdir(str(tmp_path / "ck" / "step_00000001"))


def test_a_shard_crash_commits_nothing_and_names_the_dead(tmp_path):
    chaos.inject_crash("ckpt.shard")      # the first shard writer dies
    errs = _threaded_saves(PORT, str(tmp_path / "ck"), InProcStore(),
                           _states()[1], world=3, timeout=1.0)
    crashed = [r for r, e in errs.items()
               if isinstance(e, chaos.InjectedCrash)]
    timed_out = [e for e in errs.values() if isinstance(e, TimeoutError)]
    assert len(crashed) == 1 and len(timed_out) == 2
    for e in timed_out:
        assert "never reported ready" in str(e) and f"[{crashed[0]}]" in str(e)
    assert not os.path.isdir(str(tmp_path / "ck" / "step_00000001"))


def test_commit_namespaces_keep_generations_apart(tmp_path):
    store = InProcStore()
    root = str(tmp_path / "ck")
    g0 = CheckpointManager(root, backend="sharded", store=store, rank=0,
                           world_size=2, commit_namespace="g0")
    g1 = CheckpointManager(root, backend="sharded", store=store, rank=0,
                           world_size=2, commit_namespace="g1")
    assert g0._ckpt_key(5) != g1._ckpt_key(5)
    store.add(g0._ckpt_key(1) + "/ready", 2)   # a gen-0 save that died
    assert not _threaded_saves(PORT, root, store, _states()[1], world=2,
                               ns="g1")
    assert CheckpointManager(root).latest_step() == 1


def test_npy_followers_wait_for_the_leaders_commit(tmp_path):
    """The "npy" backend's synchronised commit: a follower writes nothing
    (replicated state); its save returns the path rank 0 committed."""
    store = InProcStore()
    root = str(tmp_path / "ck")
    state = {"w": torch.arange(6.0)}
    follower = CheckpointManager(root, store=store, rank=1, world_size=2,
                                 sync_timeout_s=20.0)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "path", follower.save(7, {"w": torch.zeros(6)})))
    t.start()
    time.sleep(0.1)
    assert not out                       # parked on the committed marker
    leader = CheckpointManager(root, store=store, rank=0, world_size=2,
                               sync_timeout_s=20.0)
    final = leader.save(7, state)
    t.join(timeout=20)
    assert out["path"] == final
    assert torch.equal(leader.restore_latest().state["w"], state["w"])
    lonely = CheckpointManager(str(tmp_path / "c2"), store=InProcStore(),
                               rank=0, world_size=2, sync_timeout_s=0.3)
    with pytest.raises(TimeoutError, match=r"never reported ready: \[1\]"):
        lonely.save(1, state)
    assert lonely.all_steps() == []


# ------------------------------------------------------------- rebalancer
def test_rebalancer_matches_the_reference_on_the_same_walls():
    rng = np.random.default_rng(0)
    for skew, k, m, world in ((0.5, 2.0, 3, 4), (0.3, 1.5, 2, 3),
                              (0.0, 2.0, 2, 2), (0.6, 2.0, 1, 5)):
        a = trel.MicroBatchRebalancer(skew=skew, k=k, m=m)
        b = jrel.MicroBatchRebalancer(skew=skew, k=k, m=m)
        members = list(range(world))
        for step in range(30):
            if step == 20:
                members = members[:-1]           # one reformed away
            walls = {mm: float(0.1 + 0.02 * rng.random()
                               + (0.5 if mm == 1 and 4 <= step < 15 else 0))
                     for mm in members}
            a.observe(step, dict(walls))
            b.observe(step, dict(walls))
            assert a.weights == b.weights
            assert [a.pinned_streak(mm) for mm in members] == \
                [b.pinned_streak(mm) for mm in members]
            for batch in (len(members), 17, 64):
                assert a.shares(batch, members) == b.shares(batch, members)
    with pytest.raises(ValueError, match="cannot feed"):
        trel.MicroBatchRebalancer(skew=0.0).shares(2, [0, 1, 2])


# ----------------------------------------------- chaos and preemption hooks
def test_rank_faults_and_preemption_on_a_shrinking_membership():
    def script(pkg):
        c = pkg.chaos
        c.reset_stats()
        c.kill_rank(2, at_step=5)
        c.slow_rank(1, 0.3)
        out = [c.should_kill_rank(2, 4), c.should_kill_rank(2, 5),
               c.should_kill_rank(1, 9), c.rank_delay(1), c.rank_delay(0)]
        c.note_rank_killed(2)
        c.slow_rank(1, 0.0)
        out += [c.should_kill_rank(2, 9), c.rank_delay(1),
                c.stats["ranks_killed"]]
        c.kill_rank(0, 1)
        c.clear()
        return out + [c.should_kill_rank(0, 5)]

    _both(script)

    class FakeElastic:
        def __init__(self):
            self.cbs = []

        def add_watch_callback(self, cb):
            self.cbs.append(cb)

    for handler in (PreemptionHandler, JaxPreemption):
        mgr = FakeElastic()
        h = handler().attach_elastic(mgr, expected_np=4)
        mgr.cbs[0]({0: 0.0, 1: 0.0, 2: 0.0, 3: 0.0})
        assert not h.requested
        mgr.cbs[0]({0: 0.0, 1: 0.0})
        assert h.requested and h.reason == "elastic:2/4 alive"
    # distributed.elastic's change records count their members
    store, fake = InProcStore(), [0.0]
    ms = _members(PORT, store, [0, 1, 2], lambda: fake[0])
    h = PreemptionHandler().attach_elastic(ms[0], expected_np=3)
    assert ms[0].poll() is None          # leases age from first sight
    fake[0] = 5.0
    ms[0].heartbeat()
    ms[2].heartbeat()
    assert _v(ms[0].poll()) == (1, [0, 2])
    assert h.requested and h.reason == "elastic:2/3 alive"


# --------------------------------------------------------- forward_backward
def test_forward_backward_is_the_steps_gradient_without_the_update():
    def build():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 1), torch.nn.Linear(1, 1))
        return m, AdamW(0.05, parameters=m.parameters())

    x, y = torch.randn(8, 4), torch.randn(8, 1)
    m, opt = build()
    unused = m[3].weight
    step = TrainStep(m, lambda a, b: ((m[:3](a) - b) ** 2).mean(), opt,
                     device="cpu")
    before = [p.detach().clone() for p in m.parameters()]
    loss, grads = step.forward_backward(x, y)
    assert all(torch.equal(a, b) for a, b in zip(before, m.parameters()))
    assert len(grads) == 6 and torch.equal(unused.grad, torch.zeros(1, 1))
    g = opt._groups[0].g                       # views of the flat buffer
    assert all(gr.untyped_storage().data_ptr() == g.untyped_storage()
               .data_ptr() for gr in grads)
    m2, opt2 = build()
    ref = TrainStep(m2, lambda a, b: ((m2[:3](a) - b) ** 2).mean(), opt2,
                    device="cpu")
    assert float(ref(x, y)) == float(loss)
    opt.step()
    got, want = list(m.parameters()), list(m2.parameters())
    assert all(torch.equal(p, q) for p, q in zip(got[:4], want[:4]))
    # the unreached layer took a zero gradient: only AdamW's decay moved it
    for p, q in zip(got[4:], want[4:]):
        assert torch.equal(p, q * (1 - 0.05 * 0.01))
    step._batch_dims, step._n_params = (8, None), 3
    step.invalidate_executables()
    assert step._batch_dims is None and step._n_params is None


# ------------------------------------------------------ ElasticTrainer e2e
class _Linear(torch.nn.Module):
    """The reference's Linear layout: weight [in, out], x @ W + b."""

    def __init__(self, i, o):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(i, o))
        self.bias = torch.nn.Parameter(torch.empty(o))

    def forward(self, x):
        return x @ self.weight + self.bias


def _jax_mlp():
    paddle.seed(3)
    return jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 1))


def _port_mlp():
    m = torch.nn.Sequential(_Linear(4, 8), torch.nn.Tanh(), _Linear(8, 1))
    load_jax_state_dict(m, {k: np.asarray(v.numpy())
                            for k, v in _jax_mlp().state_dict().items()})
    return m


def _batches(n=12, rows=16, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, 4).astype(np.float32),
             rng.randn(rows, 1).astype(np.float32)) for _ in range(n)]


def _elastic(pkg, root, store, mid, members, **kw):
    kw.setdefault("save_every", 3)
    kw.setdefault("lease_ttl_s", 1.0)
    kw.setdefault("heartbeat_s", 0.2)
    kw.setdefault("allreduce_timeout_s", 4.0)
    if pkg is JAX:
        m = _jax_mlp()
        mse = jnn.MSELoss()
        return jrel.ElasticTrainer(
            m, lambda a, b: mse(m(a), b), JaxAdamW(0.05, parameters=
                                                   m.parameters()),
            root, store=store, member_id=mid, members=members, **kw)
    m = _port_mlp()
    return trel.ElasticTrainer(
        m, lambda a, b: ((m(a) - b) ** 2).mean(),
        AdamW(0.05, parameters=m.parameters()), root, store=store,
        member_id=mid, members=members, device="cpu", **kw)


def _go(trainers, batches, nsteps):
    reports = {}

    def go(mid):
        reports[mid] = trainers[mid].run(batches, total_steps=nsteps)

    ts = [threading.Thread(target=go, args=(m,)) for m in trainers]
    for t in ts:
        t.start()
    return ts, reports


def _world(pkg, root, members, batches, nsteps, **kw):
    store = pkg.Store()
    trainers = {m: _elastic(pkg, root, store, m, members, **kw)
                for m in members}
    ts, reports = _go(trainers, batches, nsteps)
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return trainers, reports


def _params(tr):
    return [(p.detach().numpy() if torch.is_tensor(p)
             else np.asarray(p._value)) for p in
            (tr.model.parameters() if hasattr(tr.model, "named_buffers")
             else tr.step.params)]


def _close(got, want):
    assert set(got) == set(want)
    for s in want:
        assert abs(got[s] / want[s] - 1) <= RTOL, (s, got[s], want[s])


def _history(rep):
    return (rep["status"], rep["step"], rep["final_gen"],
            rep["final_members"],
            [(f["gen"], f["members"], f["detected_at_step"],
              f["resumed_step"]) for f in rep["reforms"]])


def test_single_member_runs_and_checkpoints(tmp_path):
    tr = _elastic(PORT, str(tmp_path / "solo"), InProcStore(), 0, [0])
    rep = tr.run(_batches(4), total_steps=4)
    assert rep["status"] == "completed" and rep["steps_run"] == 4
    assert CheckpointManager(str(tmp_path / "solo")).latest_step() == 4
    assert tr.step_parts[-1]["bytes"] == {"sent": 0, "received": 0}


def test_clean_world_matches_the_reference(tmp_path):
    batches = _batches()
    _, want = _world(JAX, str(tmp_path / "j"), [0, 1, 2], batches, 12)
    trainers, got = _world(PORT, str(tmp_path / "t"), [0, 1, 2], batches,
                           12)
    for m in (0, 1, 2):
        assert _history(got[m]) == _history(want[m])
        _close(got[m]["losses"], want[0]["losses"])
    p0 = _params(trainers[0])
    assert all(all(np.array_equal(a, b) for a, b in
                   zip(p0, _params(trainers[m]))) for m in (1, 2))
    parts = trainers[1].step_parts[-1]
    assert set(parts["parts"]) == set(trel.PARTS)
    assert parts["bytes"]["sent"] > 0 and parts["bytes"]["received"] > 0


def test_rank_kill_reforms_like_the_reference(tmp_path):
    """Kill one of four at step 7: the survivors reform at 3 from the
    step-6 checkpoint in both packages; losses to the bound above, the
    port's survivors bitwise equal."""
    batches = _batches()
    got = {}
    for pkg in (JAX, PORT):
        pkg.chaos.kill_rank(2, at_step=7)
        trainers, reps = _world(pkg, str(tmp_path / str(id(pkg))),
                                [0, 1, 2, 3], batches, 12)
        got[pkg is PORT] = (trainers, reps)
    (trainers, port), (_, ref) = got[True], got[False]
    assert port[2]["status"] == "killed" and port[2]["killed_at_step"] == 7
    assert chaos.stats["ranks_killed"] >= 1
    for m in (0, 1, 3):
        assert _history(port[m]) == _history(ref[m])
        assert port[m]["status"] == "completed"
        (reform,) = port[m]["reforms"]
        assert reform["members"] == [0, 1, 3] and reform["resumed_step"] == 6
        _close(port[m]["losses"], ref[m]["losses"])
    p0 = _params(trainers[0])
    assert all(all(np.array_equal(a, b) for a, b in
                   zip(p0, _params(trainers[m]))) for m in (1, 3))


def test_scale_up_join_reforms_like_the_reference(tmp_path):
    """A fourth member request_joins a world of three once it has taken
    four steps: every member ends at world 4 with bitwise-equal
    parameters, and the losses match the reference's uninterrupted
    world-3 run (the trajectory is a function of the global batch).

    The incumbents hold at step 5 until the join request is in the
    store, so they fold the joiner in at step 5 or 6 however late the
    test's thread gets to request it (a joiner that asked after the
    incumbents had finished was the failure this guards against)."""
    batches = _batches(6)
    _, clean = _world(JAX, str(tmp_path / "clean"), [0, 1, 2], batches, 12)
    store = InProcStore()
    root = str(tmp_path / "join")
    trainers = {m: _elastic(PORT, root, store, m, [0, 1, 2])
                for m in (0, 1, 2)}

    def held(tr, loss_fn):
        def loss(*batch):
            t0 = time.monotonic()
            while tr._gstep == 5 and \
                    store.add("/pt/elastic/join_seq", 0) < 1:
                if time.monotonic() - t0 > 120:
                    raise TimeoutError("no join request within 120 s")
                time.sleep(0.01)
            return loss_fn(*batch)
        return loss

    for tr in trainers.values():
        tr.step.loss_fn = held(tr, tr.step.loss_fn)
    ts, reports = _go(trainers, batches, 12)
    t0 = time.monotonic()
    while trainers[0]._gstep < 4 and time.monotonic() - t0 < 60:
        time.sleep(0.01)
    pre = tel.ElasticMembership(store, 3, [3], lease_ttl_s=1.0,
                                heartbeat_s=0.2)
    pre.start()
    try:
        view = pre.request_join(timeout_s=30)
        assert view.contains(3) and view.gen == 1
        trainers[3] = _elastic(PORT, root, store, 3, [0, 1, 2, 3])
        tj, more = _go({3: trainers[3]}, batches, 12)
        for t in ts + tj:
            t.join(timeout=120)
    finally:
        pre.stop()
    reports.update(more)
    want = clean[0]["losses"]
    for m in (0, 1, 2, 3):
        assert reports[m]["status"] == "completed"
        assert reports[m]["final_world_size"] == 4
        got = reports[m]["losses"]       # the joiner's from its first step
        _close(got, want if m < 3 else {s: want[s] for s in got})
    for m in (0, 1, 2):
        (reform,) = reports[m]["reforms"]
        assert reform["gen"] == 1 and reform["members"] == [0, 1, 2, 3]
    assert reports[3]["steps_run"] > 0
    p0 = _params(trainers[0])
    assert all(all(np.array_equal(a, b) for a, b in
                   zip(p0, _params(trainers[m]))) for m in (1, 2, 3))


def test_chronically_pinned_rank_is_ejected_like_the_reference(tmp_path):
    """FLAGS_elastic_eject_patience: member 1, 0.4 s slower a step, is
    pinned at the (1 - skew) clamp for two windows and ejected by member
    0, in both packages alike; the losses match."""
    before = tregistry.REGISTRY.get("membership_ejections_total").total()
    out = {}
    for pkg in (JAX, PORT):
        pkg.chaos.slow_rank(1, 0.4)
        store = pkg.Store()
        trainers = {m: _elastic(pkg, str(tmp_path / str(id(pkg))), store, m,
                                [0, 1], rebalance_skew=0.5,
                                eject_patience=2, sync_timeout_s=4.0)
                    for m in (0, 1)}
        for tr in trainers.values():
            tr.rebalancer.k, tr.rebalancer.m = 2.0, 2
        ts, reps = _go(trainers, _batches(10), 10)
        for t in ts:
            t.join(timeout=120)
        pkg.chaos.clear()
        out[pkg is PORT] = reps
    port, ref = out[True], out[False]
    assert port[0]["status"] == ref[0]["status"] == "completed"
    assert port[1]["status"] == ref[1]["status"] == "ejected"
    assert port[0]["final_world_size"] == 1
    (ej,) = port[0]["ejections"]
    assert {k: ej[k] for k in ("member", "by", "pinned_windows",
                               "weight")} == \
        {k: ref[0]["ejections"][0][k] for k in ("member", "by",
                                                "pinned_windows", "weight")}
    assert ej["weight"] == 0.5
    _close(port[0]["losses"], ref[0]["losses"])
    after = tregistry.REGISTRY.get("membership_ejections_total").total()
    assert after == before + 1


def _jax_gpt_trainer(root, store, mid, cfg, **kw):
    paddle.seed(0)
    jm = JaxGPT(cfg)
    opt = JaxAdamW(1e-3, parameters=jm.parameters(), weight_decay=0.01)
    return jrel.ElasticTrainer(jm, lambda x: jm(x, labels=x), opt, root,
                               store=store, member_id=mid, **kw), jm


def _port_gpt_trainer(root, store, mid, jm, **kw):
    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu", seed=9)
    load_jax_state_dict(model, {k: np.asarray(v.numpy())
                                for k, v in jm.state_dict().items()})
    opt = AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01)
    return trel.ElasticTrainer(model, lambda x: model(x, labels=x), opt,
                               root, store=store, member_id=mid,
                               device="cpu", **kw)


def test_gpt_ranks_and_a_reference_checkpoint_resume_in_the_port(tmp_path):
    """A tiny GPT, weights from the reference's: two port ranks train 3
    steps as two reference ranks do. Then the reference's ranks checkpoint
    step 3 of a six-step run (save_every 3); the port's single member
    resumes it and runs to step 6, as a single reference member does from
    the same checkpoint."""
    cfg = JaxGPTConfig.tiny()
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                            (6, 4, 32)).astype(np.int32)
    batches = [(x,) for x in ids]
    kw = dict(save_every=3, lease_ttl_s=5.0, heartbeat_s=0.2,
              allreduce_timeout_s=30.0)
    runs = {}
    for side in ("jax", "port"):
        store = JaxStore() if side == "jax" else InProcStore()
        root = str(tmp_path / side)
        trainers = {}
        for mid in (0, 1):
            jtr, jm = _jax_gpt_trainer(root, store, mid, cfg, members=[0, 1],
                                       **kw)
            trainers[mid] = jtr if side == "jax" else _port_gpt_trainer(
                root, store, mid, jm, members=[0, 1], **kw)
        ts, reps = _go(trainers, batches, 3)
        for t in ts:
            t.join(timeout=300)
        runs[side] = reps
    for m in (0, 1):
        _close(runs["port"][m]["losses"], runs["jax"][m]["losses"])

    # the reference's checkpoint of step 3, resumed by each package
    store = JaxStore()
    root = str(tmp_path / "ref6")
    trainers = {mid: _jax_gpt_trainer(root, store, mid, cfg, members=[0, 1],
                                      **kw)[0] for mid in (0, 1)}
    chaos_at = 3
    for tr in trainers.values():
        tr.save_every = chaos_at
    jchaos.kill_rank(0, at_step=chaos_at)
    jchaos.kill_rank(1, at_step=chaos_at)
    ts, _ = _go(trainers, batches, 6)
    for t in ts:
        t.join(timeout=300)
    jchaos.clear()
    assert JaxManager(root).latest_step() == chaos_at
    subprocess.run(["cp", "-r", root, str(tmp_path / "port6")], check=True)
    jtr, jm = _jax_gpt_trainer(root, JaxStore(), 0, cfg, members=[0], **kw)
    want = jtr.run(batches, total_steps=6)
    ptr = _port_gpt_trainer(str(tmp_path / "port6"), InProcStore(), 0, jm,
                            members=[0], **kw)
    got = ptr.run([(x.astype(np.int64),) for x in ids], total_steps=6)
    assert got["steps_run"] == want["steps_run"] == 3
    _close(got["losses"], want["losses"])
