"""Data parallelism in the port (TrainStep(dp_axis=), DataParallel, fleet's
data-parallel API, init_parallel_env) over gloo rank processes, held
against the reference's TrainStep(mesh=build_mesh(dp=N), dp_axis="dp")
on the 8-device CPU mesh.

GPT tiny (2 layers, fp32), AdamW with a global-norm clip, from the JAX
model's seeded weights; a global batch of 8 x 32 tokens (12 x 32 at world
3), three steps. The port's N ranks each take the same global batch and
keep their rows, as the reference's call does. Losses are held to 1e-5
relative and parameters to 1e-5 absolute against the reference's, at
worlds 2 and 4 and bucket sizes -1 (one bucket), 0 (a tensor a bucket)
and 4 MB; the ranks' parameters must be bitwise equal to each other.
The learning rate is 1e-4: Adam divides each first moment by the root of
the second, so where a gradient is only rounding noise (the key
projection's bias, which the softmax ignores) the two packages' noise
moves the element by a share of lr each step. That share read 2.4e-5 at
lr 1e-3, past the bound; at 1e-4 it stays a tenth of it, while every
other element agrees to fp32 rounding.
The fine schedule at world 3, where buckets of 128 KB and more go to the
ring (which adds in ring order), is held at the same bounds against the
reference's bucketed run.

The three rank worlds run while this process computes the reference's
runs (tests/_torch_dp_ranks.py holds their bodies).
"""
import os

import numpy as np
import pytest
import torch

import _torch_dp_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.jit.trainer import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-4
STEPS = 3
MBS = [-1, 0, 4]
SEQ = 32
EXTRAS = ["nan_guard", "telemetry", "errors", "data_parallel", "env"]


def _ids(rows):
    return np.random.default_rng(1).integers(
        0, GPTConfig.tiny().vocab_size, (rows, SEQ)).astype(np.int64)


def _state():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _ref_run(state, ids, world, mb):
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    opt = JaxAdamW(LR, parameters=jm.parameters(), weight_decay=0.01,
                   grad_clip=JaxClip(1.0))
    step = JaxTrainStep(jm, lambda x: jm(x, labels=x), opt,
                        mesh=jdist.build_mesh(dp=world), dp_axis="dp",
                        grad_bucket_mb=mb)
    x = paddle.to_tensor(ids.astype(np.int32))
    losses = [float(step(x).numpy()) for _ in range(STEPS)]
    return {"losses": losses, "params": {
        k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    state = _state()
    tmp = str(tmp_path_factory.mktemp("dp"))
    ctxs = {
        2: spawn(ranks.dp_train, args=(state, _ids(8), LR, MBS, None, STEPS,
                                       EXTRAS, tmp), nprocs=2,
                 backend="cpu", join=False),
        4: spawn(ranks.dp_train, args=(state, _ids(8), LR, MBS, None, STEPS,
                                       [], tmp), nprocs=4, backend="cpu",
                 join=False),
        3: spawn(ranks.dp_train, args=(state, _ids(12), LR, [0], "fine",
                                       STEPS, [], tmp), nprocs=3,
                 backend="cpu", join=False),
        "nccl": spawn(ranks.nccl_clash, nprocs=2, backend="cpu",
                      join=False)}
    # the reference's AOT dispatch: its steps after the first skip jit's
    # per-call dispatch (the same program, ~1.6 s a step less here)
    fast = paddle.get_flags(["jit_fast_dispatch"])
    paddle.set_flags({"jit_fast_dispatch": True})
    try:
        ref = {(n, mb): _ref_run(state, _ids(8), n, mb)
               for n in (2, 4) for mb in MBS}
        ref[(3, 0)] = _ref_run(state, _ids(12), 3, 0)
    finally:
        paddle.set_flags(fast)
    port = {n: ctx.join(300) for n, ctx in ctxs.items()}
    return ref, port


def _same_across_ranks(res, mb):
    p0 = res[0]["runs"][mb]["params"]
    for r in res[1:]:
        assert r["runs"][mb]["losses"] == res[0]["runs"][mb]["losses"]
        for k, v in r["runs"][mb]["params"].items():
            np.testing.assert_array_equal(v, p0[k])


def _close_to(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("world,mb", [(n, mb) for n in (2, 4)
                                      for mb in MBS])
def test_dp_train_steps_match_the_reference(runs, world, mb):
    ref, port = runs
    got = port[world]
    _same_across_ranks(got, mb)
    _close_to(got[0]["runs"][mb], ref[(world, mb)])
    assert got[0]["runs"][mb]["losses"][-1] < got[0]["runs"][mb]["losses"][0]
    sched = got[0]["runs"][mb]["schedule"]
    n_params = len(ref[(world, mb)]["params"])
    assert sched["mode"] == "bucketed" and sched["world"] == world
    assert sched["n_buckets"] == {-1: 1, 0: n_params}.get(
        mb, sched["n_buckets"]) and sched["ring_buckets"] == 0


def test_fine_schedule_at_world_three_matches_the_bucketed_reference(runs):
    """Rings engage at world 3: buckets of 128 KB or more with enough
    hooks still to come go to the ring, the rest to one all-reduce; some
    ring steps run inline, between hooks."""
    ref, port = runs
    got = port[3]
    _same_across_ranks(got, 0)
    _close_to(got[0]["runs"][0], ref[(3, 0)])
    sched = got[0]["runs"][0]["schedule"]
    assert sched["mode"] == "fine" and sched["world"] == 3
    assert sched["ring_buckets"] > 0 and sched["psum_buckets"] > 0
    assert sched["inline_steps"] > 0
    assert sched["inline_steps"] + sched["drained_steps"] == \
        sched["ring_steps_total"] == 4 * sched["ring_buckets"]
    rings = [b for b in sched["buckets"] if b["schedule"] == "ring"]
    assert all(b["bytes"] >= 128 << 10 for b in rings)
    assert [b["ready_at"] for b in sched["buckets"]] == \
        sorted(b["ready_at"] for b in sched["buckets"])


def test_nan_on_one_rank_skips_the_step_on_every_rank(runs):
    _, port = runs
    for r in port[2]:
        assert r["nan_guard"] == {"skipped": [False, True, False],
                                  "unchanged": [False, True, False],
                                  "skipped_steps": 1}


def test_telemetry_records_carry_the_probed_reduce_time(runs):
    """Each record's `reduce` phase is the probe's time, and its grad_norm
    (before any update) is the whole batch's at world 1: the ranks
    average their gradients. AdamW is nearly blind to a gradient's scale,
    so the parity above alone would not see a sum in place of the mean."""
    _, port = runs
    from paddle_tpu_torch.models.convert import load_jax_state_dict

    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(model, _state())
    ids = torch.from_numpy(_ids(8))
    model(ids, labels=ids).backward()
    norm = float(torch.stack([p.grad.double().square().sum()
                              for p in model.parameters()]).sum().sqrt())
    # 1e-4: the record's norm is the root of the step's fp32 square-sum,
    # which reads 4e-5 under this float64 one (the CPU's fp32 norm sums
    # the 131,072 squares of the embedding's gradient in fp32); a sum in
    # place of the mean reads 2x
    for r in port[2]:
        assert r["telemetry"]["records"][0]["grad_norm"] == \
            pytest.approx(norm, rel=1e-4)
        tel = r["telemetry"]
        assert len(tel["records"]) == 2 and tel["reduce_s"] > 0
        for rec in tel["records"]:
            # carved out of the step's measured compute, at most all of it
            # (rounded to the microsecond)
            ph = rec["phases"]
            assert ph["reduce"] == pytest.approx(min(
                tel["reduce_s"], ph["reduce"] + ph["compute"]), abs=1e-6)
            assert ph["reduce"] > 0
        parts = tel["last_parts"]
        assert set(parts) == {"fwd_bwd_s", "reduce_wait_s", "apply_s"}
        assert all(v >= 0 for v in parts.values())
        assert tel["invalidated"] == [None, None] and tel["rebuilt"]


def test_constructor_errors_match_the_reference(runs):
    """Message for message: no mesh, an axis not in the mesh,
    in_shardings beside dp_axis, a bad schedule name, and (at world 2,
    from the ranks) a batch that does not split."""
    _, port = runs
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    topt = AdamW(LR, parameters=tm.parameters())
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    jopt = JaxAdamW(LR, parameters=jm.parameters())
    before = jdist.get_mesh()

    def both(kw_j, kw_t):
        msgs = []
        for build in (lambda: JaxTrainStep(jm, lambda x: jm(x), jopt,
                                           **kw_j),
                      lambda: TrainStep(tm, lambda x: tm(x), topt,
                                        device="cpu", **kw_t)):
            with pytest.raises(ValueError) as e:
                build()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
        return msgs[1]

    try:
        jdist.set_mesh(None)
        assert "needs an active mesh" in both({"dp_axis": "dp"},
                                              {"dp_axis": "dp"})
        jmesh, tmesh = jdist.build_mesh(dp=1), tdist.build_mesh(dp=1)
        assert "not an axis" in both(
            {"dp_axis": "tp", "mesh": jmesh}, {"dp_axis": "tp",
                                               "mesh": tmesh})
        assert "replaces in_shardings" in both(
            {"dp_axis": "dp", "mesh": jmesh, "in_shardings": ()},
            {"dp_axis": "dp", "mesh": tmesh, "in_shardings": ()})
        assert "expected 'bucketed' or 'fine'" in both(
            {"dp_overlap": "ring"}, {"dp_overlap": "ring"})
        # the divisibility check, at world 2 on both sides
        jmesh2 = jdist.build_mesh(dp=2)
        step = JaxTrainStep(jm, lambda x: jm(x, labels=x), jopt,
                            mesh=jmesh2, dp_axis="dp")
        with pytest.raises(ValueError) as e:
            step(paddle.to_tensor(_ids(3).astype(np.int32)))
    finally:
        jdist.set_mesh(before)
    for r in port[2]:
        assert r["errors"] == str(e.value)
        assert "leading dim 3 is not divisible by 2" in r["errors"]


def test_data_parallel_sums_at_world_two(runs):
    """The hooks sum each gradient over the ranks, as the reference's do
    (Paddle's own DataParallel averages: ROADMAP, faults of the
    reference); state_dict keys pass through unprefixed."""
    _, port = runs
    rng = np.random.default_rng(5)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    xs = rng.standard_normal((2, 6, 4)).astype(np.float32)
    local = []
    for r in range(2):
        m = ranks._Lin(w, b)
        (m(torch.from_numpy(xs[r])) ** 2).sum().backward()
        local.append([p.grad.numpy() for p in m.parameters()])
    for r in port[2]:
        got = r["data_parallel"]
        for g, a, b_ in zip(got["grads"], *local):
            np.testing.assert_allclose(g, a + b_, rtol=1e-6)
        assert got["state_keys"] == ["bias", "weight"]
    assert port[2][0]["data_parallel"]["grads"][0].tobytes() == \
        port[2][1]["data_parallel"]["grads"][0].tobytes()


def test_data_parallel_at_world_one_matches_the_reference():
    """No process group: both wrappers are the identity; the forward,
    the eager gradients and the state dict equal the reference's."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    jl = paddle.nn.Linear(4, 3)
    tl = ranks._Lin(np.asarray(jl.weight.numpy()),
                    np.asarray(jl.bias.numpy()))
    jdp, tdp = jdist.DataParallel(jl), tdist.DataParallel(tl)
    jy, ty = jdp(paddle.to_tensor(x)), tdp(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), rtol=1e-6)
    (jy ** 2).sum().backward()
    (ty ** 2).sum().backward()
    np.testing.assert_allclose(tl.weight.grad.numpy(), jl.weight.grad.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(tl.bias.grad.numpy(), jl.bias.grad.numpy(),
                               rtol=1e-5)
    assert sorted(tdp.state_dict()) == sorted(jdp.state_dict())
    tdp.set_state_dict({k: v * 0 for k, v in tdp.state_dict().items()})
    assert float(tl.weight.detach().abs().sum()) == 0.0
    assert tdp.scale_loss(ty) is ty and tdp.apply_collective_grads() is None


def test_fleet_strategy_and_dp_train_step_knob():
    """DistributedStrategy's defaults are the reference's; dp_train_step
    buckets at grad_bucket_mb (2 << 20) with bucketing on and in one
    bucket (1 << 62) with it off, as the reference's knob test holds."""
    assert vars(tfleet.DistributedStrategy()) == \
        vars(jfleet.DistributedStrategy())
    on = tfleet.DistributedStrategy()
    on.dp_comm_configs["bucketed_allreduce"] = True
    on.dp_comm_configs["grad_bucket_mb"] = 2
    mesh = tdist.build_mesh(dp=1)
    m = ranks._Lin(np.ones((4, 2), np.float32), np.zeros(2, np.float32))
    opt = AdamW(0.1, parameters=m.parameters())
    step = tfleet.dp_train_step(m, lambda a: m(a).sum(), opt, strategy=on,
                                mesh=mesh, device="cpu")
    assert step._dp_axis == "dp" and step._bucket_bytes == 2 << 20
    off = tfleet.DistributedStrategy()
    off.dp_comm_configs["bucketed_allreduce"] = False
    step2 = tfleet.dp_train_step(m, lambda a: m(a).sum(), opt, strategy=off,
                                 mesh=mesh, device="cpu")
    assert step2._bucket_bytes == 1 << 62
    assert tfleet.dp_train_step(m, lambda a: m(a).sum(), opt, mesh=mesh,
                                device="cpu")._bucket_bytes == 1 << 62
    # at world 1 the step is the plain one: no process group is touched
    step(np.ones((2, 4), np.float32))


def test_fleet_at_world_two(runs):
    """fleet.init(dp_degree=2): the hybrid group's sizes and this rank's
    place; distributed_model wraps only with dp_degree > 1, and with
    pp_degree > 1 hands the model to PipelineParallel, which refuses one
    that is not a PipelineLayer; worker_num and worker_index."""
    _, port = runs
    for r, got in enumerate(port[2]):
        d = got["data_parallel"]
        assert d["hcg"] == {"dp": 2, "dp_rank": r, "dp_group": [0, 1],
                            "worker": [2, r]}
        assert d["wrapped"] == "DataParallel" and d["unwrapped"] == "_Lin"
        assert d["pp"].startswith("TypeError: PipelineParallel wraps a "
                                  "PipelineLayer") and "_Lin" in d["pp"]


def test_init_parallel_env_reads_the_launcher_variables(runs):
    """Each rank joined the gloo group from PADDLE_MASTER,
    PADDLE_TRAINERS_NUM and PADDLE_TRAINER_ID (spawn sets them); a reform
    destroys the group and a second init meets the world again."""
    _, port = runs
    for r, got in enumerate(port[2]):
        e = got["env"]
        assert e["vars"] == [str(r), "2", str(r)] and e["master"]
        assert e["pg"] == [r, 2, "gloo"] and e["initialized"]
        assert e["after_reform"] == [False, False]
        assert e["again"] == 2.0


def test_nccl_with_two_ranks_on_one_device_raises_naming_it(runs):
    """A faked device map (no CUDA here): both ranks on one card under
    PADDLE_DISTRI_BACKEND=nccl raise before any process group starts."""
    for msg, up in runs[1]["nccl"]:
        assert msg is not None and not up
        assert "ranks 0 and 1 share the device" in msg
        assert "cuda:0" in msg and "NVIDIA H100" in msg
        assert "PADDLE_DISTRI_BACKEND" in msg
    ok = {0: "h/GPU-a (cuda:0, X)", 1: "h/GPU-b (cuda:1, X)"}
    tenv.check_device_clash("nccl", ok)
    same = {0: ok[0], 1: ok[0]}
    tenv.check_device_clash("gloo", same)      # gloo may share a card
    with pytest.raises(ValueError, match="cuda:0"):
        tenv.check_device_clash("nccl", same)
    assert not os.environ.get("PADDLE_DISTRI_BACKEND")


def test_hybrid_clip_and_optimizer_match_the_reference_at_world_one():
    """Over data parallelism alone the mp, pp and sharding groups are one
    rank: the hybrid clip scales as the reference's does (its square-sum
    over those groups reduces nothing), and the wrapper swaps the clip in
    and passes the optimizer's calls through."""
    from paddle_tpu.distributed.fleet.hybrid_optimizer import (
        HybridParallelClipGrad as JaxHybridClip)
    from paddle_tpu.distributed.mesh import (
        CommunicateTopology as JaxTopology,
        HybridCommunicateGroup as JaxHCG)
    from paddle_tpu_torch.distributed.mesh import (CommunicateTopology,
                                                   HybridCommunicateGroup)
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    rng = np.random.default_rng(7)
    grads = [rng.standard_normal(s).astype(np.float32) * 3
             for s in ((4, 3), (3,), (5,))]
    before = jdist.get_mesh()
    try:
        jclip = JaxHybridClip(1.0, JaxHCG(JaxTopology()))
    finally:
        jdist.set_mesh(before)
    hcg = HybridCommunicateGroup(CommunicateTopology())
    tdist.set_mesh(None)                  # the group set it; leave none
    tclip = tfleet.HybridParallelClipGrad(1.0, hcg)
    want = jclip.functional_clip([paddle.to_tensor(g)._value for g in grads])
    params = [torch.zeros(g.shape) for g in grads]
    got = tclip([(p, torch.from_numpy(g)) for p, g in zip(params, grads)])
    for (_, g), w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    sq = sum(float((g.astype(np.float64) ** 2).sum()) for g in grads)
    assert float(tclip.factor(torch.tensor(sq, dtype=torch.float32))) == \
        pytest.approx(1.0 / np.sqrt(sq), rel=1e-6)
    m = ranks._Lin(np.ones((4, 2), np.float32), np.zeros(2, np.float32))
    opt = AdamW(0.1, parameters=m.parameters(),
                grad_clip=ClipGradByGlobalNorm(0.5))
    wrapped = tfleet.HybridParallelOptimizer(opt, hcg)
    assert isinstance(opt._grad_clip, tfleet.HybridParallelClipGrad)
    assert opt._grad_clip.clip_norm == 0.5
    assert wrapped.get_lr() == 0.1 and wrapped._inner is opt
    m(torch.ones(3, 4)).sum().backward()
    wrapped.step()
    wrapped.clear_grad()
    assert float(m.weight.detach().sum()) < 8.0
