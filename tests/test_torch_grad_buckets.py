"""Gradient buckets and the ring (paddle_tpu_torch/distributed/
grad_buckets.py, overlap.py) against the reference's: partition_buckets
on hypothesis-drawn shapes and dtypes; the cost model and its flag;
bucket_reduce over gloo ranks against one all-reduce of everything;
ring_all_reduce at worlds 3 and 4 with uneven chunks in fp32 and bf16
against the reference's ring under shard_map; reduce_flush with mixed
schedules; and the hook trigger's bookkeeping on a single rank.

Tolerances: bucket_reduce is bitwise equal to the single all-reduce at
world 2 (a sum of two is one addition). At world 4 it is held at 1e-6
relative: gloo's ring adds a bucket's chunk of the four contributions in
an order that depends on where the chunk boundaries fall, so another
bucket size can add an element in another order. The rings are held at
the reference's own ring test's tolerances (fp32 1e-5, bf16 5e-2), and
reduce_flush at its test's 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dp_ranks as ranks
from paddle_tpu.core import flags as jflags
from paddle_tpu.distributed import grad_buckets as jgb
from paddle_tpu.distributed import overlap as jov
from paddle_tpu.distributed._compat import shard_map
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.distributed import grad_buckets as tgb
from paddle_tpu_torch.distributed import overlap as tov
from paddle_tpu_torch.distributed import spawn

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16),
          ("float16", jnp.float16, torch.float16),
          ("int32", jnp.int32, torch.int32),
          ("float64", jnp.float64, torch.float64)]
SIZES = [16, 64, 1 << 62]
SHAPES = [(3, 5), (7,), (40, 40), (2, 3, 4), (1,), (11,)]


@pytest.fixture
def _restore_flags():
    keep = {k: (jflags.get_flag(k), tflags.get_flag(k))
            for k in ("dp_overlap_min_kb", "grad_bucket_mb")}
    yield
    jflags.set_flags({k: v[0] for k, v in keep.items()})
    tflags.set_flags({k: v[1] for k, v in keep.items()})


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(
    st.lists(st.integers(0, 40), min_size=0, max_size=3),
    st.integers(0, len(DTYPES) - 1)), min_size=0, max_size=12),
    st.sampled_from([1, 8, 16, 64, 100, 1000, 4096, 1 << 62]))
def test_partition_buckets_equals_the_reference(spec, bucket_bytes):
    """The same index lists, oversized tensors (one to a bucket), empty
    and scalar shapes and dtype changes included."""
    shapes = [tuple(s) for s, _ in spec]
    want = jgb.partition_buckets(shapes, [DTYPES[d][1] for _, d in spec],
                                 bucket_bytes)
    got = tgb.partition_buckets(shapes, [DTYPES[d][2] for _, d in spec],
                                bucket_bytes)
    assert got == want
    assert tgb.partition_buckets(
        shapes, [DTYPES[d][0] for _, d in spec], bucket_bytes) == want


def test_cost_model_and_its_flag_equal_the_reference(_restore_flags):
    for kb in (128, 1, 7):
        jflags.set_flags({"dp_overlap_min_kb": kb})
        tflags.set_flags({"dp_overlap_min_kb": kb})
        assert tov.min_ring_bytes() == jov.min_ring_bytes() == kb << 10
        for nbytes in (0, 1 << 10, 7 << 10, 28 << 10, 128 << 10, 1 << 20,
                       1 << 24):
            for world in (1, 2, 3, 4, 8):
                for rem in (0, 1, 3, 4, 6, 14, 100):
                    assert tov.choose_schedule(nbytes, world, rem) == \
                        jov.choose_schedule(nbytes, world, rem)
                    assert tov.choose_schedule(nbytes, world, rem, 4096) \
                        == jov.choose_schedule(nbytes, world, rem, 4096)
    for mb in (4, 0, -1, 2):
        jflags.set_flags({"grad_bucket_mb": mb})
        tflags.set_flags({"grad_bucket_mb": mb})
        assert tgb.default_bucket_bytes() == jgb.default_bucket_bytes()


def _grads(world, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((world,) + s).astype(np.float32)
            for s in SHAPES]


def _rings(world):
    rng = np.random.default_rng(world)
    # lengths that do and do not split evenly into `world` chunks
    arrays = [rng.random((world, n)).astype(np.float32)
              for n in (64, 1000, 10007)]
    return [(arrays, "float32"), (arrays, "bfloat16")]


def _ref_ring(arrays, world, dtype, mean):
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    f = jax.jit(shard_map(
        lambda *vs: tuple(jov.ring_all_reduce(v.ravel(), "dp", world=world,
                                              mean=mean) for v in vs),
        mesh=mesh, in_specs=(P("dp"),) * len(arrays),
        out_specs=(P(),) * len(arrays), axis_names=frozenset({"dp"}),
        check_vma=False))
    return [np.asarray(o, np.float32)
            for o in f(*[jnp.asarray(a, dtype) for a in arrays])]


def _ref_flush(grads, world):
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    jflags.set_flags({"dp_overlap_min_kb": 1})
    f = jax.jit(shard_map(
        lambda *g: tuple(jov.reduce_flush([x[0] for x in g], "dp",
                                          bucket_bytes=4096)),
        mesh=mesh, in_specs=(P("dp"),) * len(grads),
        out_specs=(P(),) * len(grads), axis_names=frozenset({"dp"}),
        check_vma=False))
    out = [np.asarray(x) for x in f(*[jnp.asarray(g) for g in grads])]
    sched = [jov.choose_schedule(4 * sum(int(np.prod(SHAPES[i]))
                                         for i in idxs), world, 0)
             for idxs in jgb.partition_buckets(SHAPES, [jnp.float32] *
                                               len(SHAPES), 4096)]
    return out, sched


@pytest.fixture(scope="module")
def worlds():
    """bucket_reduce, rings and reduce_flush at worlds 2, 3 and 4, the
    three spawns started together."""
    ctxs = {w: spawn(ranks.buckets, args=(
        _grads(w), SIZES, _rings(w) if w > 2 else []), nprocs=w,
        backend="cpu", join=False) for w in (2, 3, 4)}
    return {w: ctx.join(240) for w, ctx in ctxs.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_bucket_reduce_matches_one_all_reduce(worlds, world):
    res = worlds[world]
    for r in res:
        np.testing.assert_array_equal(r["single"], res[0]["single"])
        for size in SIZES:
            got = r["buckets"][size]
            if world == 2:
                np.testing.assert_array_equal(got, r["single"])
            else:
                np.testing.assert_allclose(got, r["single"], rtol=1e-6,
                                           atol=1e-7)
            np.testing.assert_array_equal(got, res[0]["buckets"][size])
    mean = np.concatenate([g.mean(0).ravel() for g in _grads(world)])
    np.testing.assert_allclose(res[0]["single"], mean, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", [3, 4])
@pytest.mark.parametrize("case,tol", [(0, 1e-5), (1, 5e-2)])
def test_ring_matches_the_reference_ring(worlds, world, case, tol):
    arrays, dtype = _rings(world)[case]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    for mean, key in ((True, "ring"), (False, "ring_sum")):
        want = _ref_ring(arrays, world, jdt, mean)
        pmean = [a.astype(np.float32).mean(0) if mean else a.sum(0)
                 for a in arrays]
        for r in worlds[world]:
            for got, w, m in zip(r["rings"][case][key], want, pmean):
                np.testing.assert_allclose(got, w, rtol=tol, atol=tol)
                np.testing.assert_allclose(got, m, rtol=tol, atol=tol)
        # every rank ends with the same bits
        for got in worlds[world][1:]:
            for a, b in zip(got["rings"][case][key],
                            worlds[world][0]["rings"][case][key]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [3, 4])
def test_reduce_flush_mixed_schedules(worlds, world, _restore_flags):
    grads = _grads(world)
    want, sched = _ref_flush(grads, world)
    assert "ring" in sched and "psum" in sched
    for r in worlds[world]:
        for got, w, g in zip(r["flush"], want, grads):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, g.mean(0), rtol=1e-5, atol=1e-5)


def test_coalesce_is_a_view_of_adjacent_gradients():
    """Neighbours in one flat buffer coalesce to a view of it (a reduction
    writes them in place); scattered tensors to a copy."""
    buf = torch.arange(10, dtype=torch.float32)
    views = [buf[0:3], buf[3:7].view(2, 2), buf[7:10]]
    flat = tgb.coalesce(views, [2, 1, 0])
    assert flat.data_ptr() == buf.data_ptr() and flat.numel() == 10
    loose = [torch.ones(3), torch.zeros(2)]
    flat = tgb.coalesce(loose, [1, 0])
    assert flat.data_ptr() not in (t.data_ptr() for t in loose)
    np.testing.assert_array_equal(flat.numpy(), [1, 1, 1, 0, 0])
    out = [None, None]
    tgb.uncoalesce(flat, [1, 0], [(3,), (2,)], out)
    np.testing.assert_array_equal(out[0].numpy(), [1, 1, 1])
    np.testing.assert_array_equal(out[1].numpy(), [0, 0])


def test_trigger_issues_buckets_in_order_at_world_one():
    """A group of one rank: the hooks still count positions and issue
    every bucket (bucket 0 first, holding the last parameters), and the
    gradients come out unchanged."""
    from paddle_tpu_torch.distributed.collective import Group

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 2))
    params = list(model.parameters())
    trig = tov.BucketTrigger(params, Group(0, 1), 64, "fine")
    loss = model(torch.randn(3, 4)).square().sum()
    want = torch.autograd.grad(loss, params, retain_graph=True)
    trig.run(loss.backward)
    for p, w in zip(params, want):
        torch.testing.assert_close(p.grad, w, rtol=0, atol=0)
    sched = tov.last_schedule()
    assert sched["n_hooks"] == 4 and sched["mode"] == "fine"
    assert [b["bucket"] for b in sched["buckets"]] == \
        list(range(sched["n_buckets"]))
    assert sched["ring_buckets"] == 0          # world 1: never a ring
    assert [b["ready_at"] for b in sched["buckets"]] == \
        sorted(b["ready_at"] for b in sched["buckets"])
