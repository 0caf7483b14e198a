"""The port's collectives (paddle_tpu_torch/distributed/collective.py) over
gloo rank processes against the reference's same calls inside a
shard_map over a 4-device CPU mesh, on the same per-rank blocks of seeded
numpy inputs; the hybrid group's layout over the ranks; and, at world 1
with no process group, every collective the identity as the reference's
are outside a mesh.

One spawn of four ranks runs every collective (tests/_torch_dp_ranks.py);
send/recv runs at world 2. Integer sums and float sums at world 2 must be
exact. At world 4 float results are held at 1e-6 relative: gloo adds the
four contributions in its ring's order, XLA in its own. PROD is held at
1e-5: the reference builds it from exp(sum(log|x|)), gloo multiplies.
"""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dp_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import spawn

W = 4


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "x": (rng.uniform(0.5, 2.0, (W, 6)) *
              rng.choice([-1.0, 1.0], (W, 6))).astype(np.float32),
        "xi": rng.integers(-50, 50, (W, 6)).astype(np.int32),
        "rs": rng.standard_normal((W * 8, 3)).astype(np.float32),
        "a2a": rng.standard_normal((W * 4, 3)).astype(np.float32),
        "sc": rng.standard_normal((W, 6)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def mesh4():
    before = jdist.get_mesh()
    mesh = jdist.build_mesh(dp=W)
    jdist.set_mesh(mesh)
    yield mesh
    jdist.set_mesh(before)


SEND = np.random.default_rng(3).standard_normal((2, 5)).astype(np.float32)


@pytest.fixture(scope="module")
def port():
    """The world-4 collectives and the world-2 send/recv, run together."""
    inputs = _inputs()
    ctx = spawn(ranks.collectives, args=(inputs,), nprocs=W, backend="cpu",
                join=False)
    pair = spawn(ranks.send_recv, args=(SEND[:1],), nprocs=2, backend="cpu",
                 join=False)
    return inputs, ctx.join(240), pair.join(240)


def _ref(mesh, fn, *arrays, out=P("dp"), specs=None):
    f = jdist.sharded_fn(fn, mesh, in_specs=specs or
                         tuple(P("dp") for _ in arrays), out_specs=out)
    res = f(*[paddle.to_tensor(a) for a in arrays])
    if isinstance(res, (list, tuple)):
        return [np.asarray(r.numpy()) for r in res]
    return np.asarray(res.numpy())


def _rows(res, key):
    return np.concatenate([r[key] for r in res])


@pytest.mark.parametrize("op", ["sum", "max", "min", "avg", "prod"])
def test_all_reduce_matches_the_reference(mesh4, port, op):
    inputs, res, _ = port
    g = jdist.new_group(axis_name="dp")
    want = _ref(mesh4, lambda t: jdist.all_reduce(t, op, group=g),
                inputs["x"])
    got = _rows(res, f"all_reduce_{op}")
    tol = 1e-5 if op == "prod" else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)
    # every rank holds the same bits
    assert all(np.array_equal(got[0], row) for row in got)
    if op == "avg":
        np.testing.assert_array_equal(_rows(res, "all_reduce_avg_async"),
                                      got)
        assert all(r["async_is_task"] for r in res)


def test_integer_sum_is_exact(mesh4, port):
    inputs, res, _ = port
    g = jdist.new_group(axis_name="dp")
    want = _ref(mesh4, lambda t: jdist.all_reduce(t, group=g), inputs["xi"])
    got = _rows(res, "all_reduce_int")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_gathers_and_scatters_match_the_reference(mesh4, port):
    inputs, res, _ = port
    g = jdist.new_group(axis_name="dp")
    x = inputs["x"]
    want = _ref(mesh4, lambda t: jdist.all_gather(None, t, group=g), x,
                out=P())
    for r in res:
        np.testing.assert_array_equal(r["all_gather"], want)
        np.testing.assert_array_equal(np.stack(r["all_gather_list"]), want)
    want = _ref(mesh4, lambda t: jdist.all_gather_concat(t, 1, group=g), x,
                out=P())
    for r in res:
        np.testing.assert_array_equal(r["all_gather_concat"], want)
    want = _ref(mesh4, lambda t: jdist.reduce_scatter(t, group=g),
                inputs["rs"])
    np.testing.assert_allclose(_rows(res, "reduce_scatter"), want,
                               rtol=1e-6, atol=1e-6)
    want = _ref(mesh4, lambda t: jdist.broadcast(t, src=2, group=g), x)
    np.testing.assert_array_equal(_rows(res, "broadcast"), want)
    # reduce: the reference replicates the result; Paddle's contract (and
    # the port's) defines it on dst alone
    want = _ref(mesh4, lambda t: jdist.reduce(t, dst=1, group=g), x)
    np.testing.assert_allclose(res[1]["reduce"], want[1:2], rtol=1e-6)
    # gather: every device of the reference gets the list, dst alone here
    want = _ref(mesh4, lambda t: jdist.gather(t, [], dst=0, group=g), x)
    assert len(want) == W and [len(r["gather"]) for r in res] == [W, 0, 0, 0]
    for j in range(W):
        np.testing.assert_array_equal(res[0]["gather"][j], want[j][:1])
    want = _ref(mesh4, lambda t, s: jdist.scatter(
        t, [s[i:i + 1] for i in range(W)], src=3, group=g), x, inputs["sc"],
        specs=(P("dp"), P()))
    np.testing.assert_array_equal(_rows(res, "scatter"), want)


def test_all_to_all_matches_the_reference(mesh4, port):
    inputs, res, _ = port
    g = jdist.new_group(axis_name="dp")
    want = _ref(mesh4, lambda t: jdist.all_to_all(
        [], [t * (i + 1) for i in range(W)], group=g), inputs["x"])
    for r, got in enumerate(res):
        for j in range(W):
            np.testing.assert_array_equal(got["all_to_all"][j],
                                          want[j][r:r + 1])
    want = _ref(mesh4, lambda t: jdist.alltoall_single(
        t, group=g, split_axis=0, concat_axis=1), inputs["a2a"])
    np.testing.assert_array_equal(_rows(res, "alltoall_single"), want)


def test_permutes_and_p2p_match_the_reference(mesh4, port):
    inputs, res, _ = port
    g = jdist.new_group(axis_name="dp")
    x = inputs["x"]
    ring = [(i, (i + 1) % W) for i in range(W)]
    want = _ref(mesh4, lambda t: jdist.collective_permute(t, ring, group=g),
                x)
    np.testing.assert_array_equal(_rows(res, "collective_permute"), want)
    np.testing.assert_array_equal(_rows(res, "batch_isend_irecv_ring"),
                                  want)
    want = _ref(mesh4, lambda t: jdist.collective_permute(
        t, [(0, 2), (1, 3)], group=g), x)
    np.testing.assert_array_equal(_rows(res, "collective_permute_partial"),
                                  want)

    def edge(t):     # one send 0 -> 1 as the reference pairs it
        buf = paddle.zeros_like(t)
        jdist.batch_isend_irecv([jdist.P2POp(jdist.isend, t, 1, g),
                                 jdist.P2POp(jdist.irecv, buf, 0, g)])
        return buf

    want = _ref(mesh4, edge, x)
    np.testing.assert_array_equal(_rows(res, "batch_isend_irecv"), want)


def test_send_recv_at_world_two_match_the_reference(port):
    x, res = SEND, port[2]
    mesh = jdist.build_mesh(dp=2)
    g = jdist.Group(0, 2, 99, [0, 1], axis_name="dp")

    def pair(t):
        buf = paddle.zeros_like(t)
        jdist.send(t, dst=1, group=g)
        jdist.recv(buf, src=0, group=g)
        return buf

    want = _ref(mesh, pair, x)
    a, b = res[1]
    np.testing.assert_array_equal(a, want[1:2])     # exact at world 2
    np.testing.assert_array_equal(b, 2 * want[1:2])
    assert res[0] is None


def test_subset_group_reduces_over_its_ranks_only(mesh4, port):
    """new_group([1, 3]): the port sums ranks 1 and 3 and leaves 0 and 2
    alone. The reference's subset group, bound to the dp axis, sums the
    whole axis (its psum takes no rank list): a fault of the reference."""
    inputs, res, _ = port
    x = inputs["x"]
    assert [r["subset_rank"] for r in res] == [-1, 0, -1, 1]
    for r in (0, 2):
        np.testing.assert_array_equal(res[r]["subset"], x[r:r + 1])
    for r in (1, 3):
        np.testing.assert_array_equal(res[r]["subset"],
                                      x[1:2] + x[3:4])
    sub = jdist.new_group([1, 3], axis_name="dp")
    want = _ref(mesh4, lambda t: jdist.all_reduce(t, group=sub), x)
    np.testing.assert_allclose(want[1], x.sum(0), rtol=1e-6)
    # get_rank and get_world_size are global, the group ignored, as the
    # reference's are
    assert [r["get_rank"] for r in res] == [[r, W, r, W] for r in range(W)]


def test_hybrid_group_layout_over_four_ranks(port):
    """fleet.init at dp 2 x mp 2: the reference's sizes; the port's ranks
    are the process's place on the grid (mp innermost), where the
    single-controller reference reports 0."""
    inputs, res, _ = port
    from paddle_tpu.distributed.mesh import (CommunicateTopology,
                                             HybridCommunicateGroup)

    before = jdist.get_mesh()
    try:
        ref = HybridCommunicateGroup(CommunicateTopology(
            ("data", "pipe", "sharding", "sep", "model"), (2, 1, 1, 1, 2)))
    finally:
        jdist.set_mesh(before)
    want_sizes = [ref.get_data_parallel_world_size(),
                  ref.get_model_parallel_world_size(),
                  ref.get_pipe_parallel_world_size(),
                  ref.get_sharding_parallel_world_size(),
                  ref.get_sep_parallel_world_size()]
    x = inputs["x"]
    for r, got in enumerate(res):
        h = got["hcg"]
        assert h["sizes"] == want_sizes == [2, 2, 1, 1, 1]
        assert h["ranks"] == [r // 2, r % 2, 0]
        assert h["dp_group"] == [r % 2, r % 2 + 2]
        assert h["mp_group"] == h["axis_group"] == [r - r % 2, r - r % 2 + 1]
        assert h["mp_src"] == r - r % 2
        np.testing.assert_array_equal(
            h["dp_sum"], x[r % 2:r % 2 + 1] + x[r % 2 + 2:r % 2 + 3])


def test_world_one_collectives_are_the_identity():
    """No process group in this process: as the reference's outside a
    mesh, every collective returns its input (lists take it as their one
    entry)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t, j = torch.from_numpy(x.copy()), paddle.to_tensor(x)
    pairs = [
        (tdist.all_reduce(t, "avg"), jdist.all_reduce(j, "avg")),
        (tdist.all_gather(None, t), jdist.all_gather(None, j)),
        (tdist.all_gather_concat(t, 1), jdist.all_gather_concat(j, 1)),
        (tdist.reduce_scatter(t), jdist.reduce_scatter(j)),
        (tdist.broadcast(t, 0), jdist.broadcast(j, 0)),
        (tdist.reduce(t, 0), jdist.reduce(j, 0)),
        (tdist.alltoall_single(t), jdist.alltoall_single(j)),
        (tdist.scatter(t, [t]), jdist.scatter(j, [j])),
        (tdist.collective_permute(t, [(0, 0)]),
         jdist.collective_permute(j, [(0, 0)])),
        (tdist.send(t, 0), jdist.send(j, 0)),
        (tdist.recv(t, 0), jdist.recv(j, 0)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert len(tdist.all_gather([], t)) == len(jdist.all_gather([], j)) == 1
    assert len(tdist.all_to_all([], [t])) == len(jdist.all_to_all([], [j]))
    assert len(tdist.gather(t)) == len(jdist.gather(j)) == 1
    got = torch.zeros_like(t)
    tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, t, 0),
                             tdist.P2POp(tdist.irecv, got, 0)])
    np.testing.assert_array_equal(got.numpy(), x)
    assert tdist.all_reduce(t, sync_op=False).wait()
    tdist.barrier()
    with tdist.axis_context("dp"):
        np.testing.assert_array_equal(tdist.all_reduce(t).numpy(), x)
    assert (tdist.get_rank(), tdist.get_world_size()) == (0, 1)
    assert tdist.get_group().nranks == tdist.new_group(axis_name="dp").nranks
