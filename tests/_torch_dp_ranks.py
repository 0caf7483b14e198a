"""Rank bodies for the port's data-parallel tests: each runs in a process
of its own, started by paddle_tpu_torch.distributed.spawn(backend="cpu"),
joins the gloo process group through init_parallel_env and returns numpy
results for the test process to hold against the JAX reference. This
module imports torch and the port only (no JAX), so a rank starts in
about a second."""
import os

import numpy as np
import torch


def _init():
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(device="cpu")
    return dist


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


# ------------------------------------------------------------ collectives
def collectives(inputs):
    """Every collective on this rank's block of each input of `inputs`
    (the block a 4-device shard_map hands device r), plus a subset group
    and the hybrid group's layout at dp 2 x mp 2."""
    dist = _init()
    from paddle_tpu_torch.distributed import fleet

    r, n = dist.get_rank(), dist.get_world_size()

    def block(name, rows=1):
        return torch.from_numpy(inputs[name][r * rows:(r + 1) * rows].copy())

    x, xi = block("x"), block("xi")
    out = {"rank": r, "world": n}
    for op in ("sum", "max", "min", "prod", "avg"):
        out[f"all_reduce_{op}"] = _np(dist.all_reduce(x.clone(), op))
    out["all_reduce_int"] = _np(dist.all_reduce(xi.clone()))
    t = x.clone()
    task = dist.all_reduce(t, dist.ReduceOp.AVG, sync_op=False)
    out["async_is_task"] = not torch.is_tensor(task)
    task.wait()
    out["all_reduce_avg_async"] = _np(t)
    out["all_gather_list"] = [_np(a) for a in dist.all_gather([], x)]
    out["all_gather"] = _np(dist.all_gather(None, x))
    out["all_gather_concat"] = _np(dist.all_gather_concat(x, axis=1))
    out["reduce_scatter"] = _np(dist.reduce_scatter(block("rs", 8)))
    out["broadcast"] = _np(dist.broadcast(x.clone(), src=2))
    out["reduce"] = _np(dist.reduce(x.clone(), dst=1))
    out["all_to_all"] = [_np(a) for a in dist.all_to_all(
        [], [x * (i + 1) for i in range(n)])]
    out["alltoall_single"] = _np(dist.alltoall_single(
        block("a2a", 4), split_axis=0, concat_axis=1))
    out["gather"] = [_np(a) for a in dist.gather(x, [], dst=0)]
    sc = torch.from_numpy(inputs["sc"].copy())
    out["scatter"] = _np(dist.scatter(
        torch.zeros_like(x), [sc[i:i + 1] for i in range(n)] if r == 3
        else None, src=3))
    perm = [(i, (i + 1) % n) for i in range(n)]
    out["collective_permute"] = _np(dist.collective_permute(x, perm))
    out["collective_permute_partial"] = _np(
        dist.collective_permute(x, [(0, 2), (1, 3)]))
    got = torch.zeros_like(x)
    ops = {0: [dist.P2POp(dist.isend, x.clone(), 1)],
           1: [dist.P2POp(dist.irecv, got, 0)]}.get(r, [])
    dist.batch_isend_irecv(ops)
    out["batch_isend_irecv"] = _np(got)
    ring = torch.zeros_like(x)
    dist.batch_isend_irecv([dist.P2POp(dist.isend, x.clone(), (r + 1) % n),
                            dist.P2POp(dist.irecv, ring, (r - 1) % n)])
    out["batch_isend_irecv_ring"] = _np(ring)
    sub = dist.new_group([1, 3])
    out["subset_rank"] = sub.rank
    out["subset"] = _np(dist.all_reduce(x.clone(), group=sub))
    out["get_rank"] = [dist.get_rank(), dist.get_world_size(),
                       dist.get_rank(sub), dist.get_world_size(sub)]
    dist.barrier()
    hcg = _hybrid(fleet, dp=2, mp=2)
    out["hcg"] = {
        "sizes": [hcg.get_data_parallel_world_size(),
                  hcg.get_model_parallel_world_size(),
                  hcg.get_pipe_parallel_world_size(),
                  hcg.get_sharding_parallel_world_size(),
                  hcg.get_sep_parallel_world_size()],
        "ranks": [hcg.get_data_parallel_rank(),
                  hcg.get_model_parallel_rank(), hcg.get_stage_id()],
        "dp_group": hcg.get_data_parallel_group().ranks,
        "mp_group": hcg.get_model_parallel_group().ranks,
        "mp_src": hcg.get_model_parallel_group_src_rank(),
        "dp_sum": _np(dist.all_reduce(
            x.clone(), group=hcg.get_data_parallel_group())),
        "axis_group": dist.new_group(axis_name="mp").ranks}
    dist.barrier()
    return out


def _hybrid(fleet, **degrees):
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(
        {f"{k}_degree": v for k, v in degrees.items()})
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def send_recv(x):
    """Rank 0 sends to rank 1, blocking then with isend/irecv."""
    dist = _init()
    r = dist.get_rank()
    t = torch.from_numpy(x.copy())
    if r == 0:
        dist.send(t, dst=1)
        dist.isend(t * 2, dst=1).wait()
        return None
    a, b = torch.zeros_like(t), torch.zeros_like(t)
    dist.recv(a, src=0)
    dist.irecv(b, src=0).wait()
    return _np(a), _np(b)


# --------------------------------------------------------------- buckets
def buckets(grads, sizes, rings):
    """bucket_reduce of this rank's gradients at each bucket size against
    one all-reduce of them all; ring_all_reduce and reduce_flush on each
    case of `rings` (this rank's arrays, a dtype name)."""
    dist = _init()
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed import grad_buckets, overlap

    r, n = dist.get_rank(), dist.get_world_size()
    dist.set_mesh(dist.build_mesh(dp=n))
    mine = [torch.from_numpy(g[r].copy()) for g in grads]
    flat = torch.cat([g.reshape(-1) for g in mine])
    dist.all_reduce(flat)
    flat /= n
    out = {"single": flat.numpy(), "buckets": {}}
    for size in sizes:
        red = grad_buckets.bucket_reduce([g.clone() for g in mine], "dp",
                                         size)
        out["buckets"][size] = np.concatenate([_np(g).ravel() for g in red])
    out["rings"] = []
    for arrays, dtype in rings:
        dt = getattr(torch, dtype)
        xs = [torch.from_numpy(a[r].copy()).to(dt) for a in arrays]
        out["rings"].append({
            "ring": [_np(overlap.ring_all_reduce(x, "dp")) for x in xs],
            "ring_sum": [_np(overlap.ring_all_reduce(x, "dp", mean=False))
                         for x in xs]})
    flags.set_flags({"dp_overlap_min_kb": 1})
    flush = overlap.reduce_flush([g.clone() for g in mine], "dp", 4096,
                                 mode="fine")
    out["flush"] = [_np(g) for g in flush]
    return out


# ------------------------------------------------------- data parallelism
def _gpt(state, lr):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_jax_state_dict(model, state)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return model, opt


def _params(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def dp_train(state, ids, lr, mbs, mode, steps, extras, tmp):
    """Three TrainSteps of GPT tiny at each bucket size in `mbs`, from the
    same weights, on the global batch `ids`; then the checks named in
    `extras`."""
    dist = _init()
    from paddle_tpu_torch.distributed import overlap
    from paddle_tpu_torch.jit import TrainStep

    n = dist.get_world_size()
    dist.set_mesh(dist.build_mesh(dp=n))
    out = {"rank": dist.get_rank(), "runs": {}}
    for mb in mbs:
        model, opt = _gpt(state, lr)
        step = TrainStep(model, lambda x: model(x, labels=x), opt,
                         device="cpu", dp_axis="dp", grad_bucket_mb=mb,
                         dp_overlap=mode)
        losses = [float(step(ids)) for _ in range(steps)]
        out["runs"][mb] = {"losses": losses, "params": _params(model),
                           "schedule": overlap.last_schedule()}
    for name in extras:
        out[name] = globals()["_" + name](dist, state, ids, lr, tmp)
    return out


def _nan_guard(dist, state, ids, lr, tmp):
    """Rank 1's loss is NaN at the second step: every rank skips it."""
    from paddle_tpu_torch.jit import TrainStep

    model, opt = _gpt(state, lr)
    calls = [0]

    def loss_fn(x):
        calls[0] += 1
        loss = model(x, labels=x)
        if calls[0] == 2 and dist.get_rank() == 1:
            loss = loss * float("nan")
        return loss

    step = TrainStep(model, loss_fn, opt, device="cpu", nan_guard=True,
                     dp_axis="dp")
    skipped, same = [], []
    for _ in range(3):
        before = [p.detach().clone() for p in model.parameters()]
        step(ids)
        skipped.append(step.last_skipped)
        same.append(all(torch.equal(a, p) for a, p in
                        zip(before, model.parameters())))
    return {"skipped": skipped, "unchanged": same,
            "skipped_steps": step.skipped_steps}


def _telemetry(dist, state, ids, lr, tmp):
    """Step records under FLAGS_metrics: each carries the probed reduce
    time in its `reduce` phase."""
    import json

    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.observability import telemetry

    d = os.path.join(tmp, f"metrics{dist.get_rank()}")
    flags.set_flags({"metrics": "on", "metrics_dir": d})
    model, opt = _gpt(state, lr)
    step = TrainStep(model, lambda x: model(x, labels=x), opt, device="cpu",
                     dp_axis="dp", grad_bucket_mb=0)
    for _ in range(2):
        step(ids)
    telemetry.get_telemetry().finalize()
    flags.set_flags({"metrics": "off", "metrics_dir": ""})
    with open(os.path.join(d, "events.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    out = {"records": [r for r in recs if r.get("kind") == "step"],
           "reduce_s": step._reduce_s, "last_parts": step.last_parts}
    # invalidate_executables drops the bucket plan and the probe's reading
    step.invalidate_executables()
    out["invalidated"] = [step._trigger, step._reduce_s]
    step(ids)
    out["rebuilt"] = step._trigger is not None and step._reduce_s > 0
    telemetry.get_telemetry().finalize()
    return out


class _Lin(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x):
        return x @ self.weight + self.bias


def _data_parallel(dist, state, ids, lr, tmp):
    """DataParallel's hooks at world 2: this rank's gradients of its own
    rows' loss, summed over the ranks; plus fleet's choice of wrapper."""
    from paddle_tpu_torch.distributed import fleet

    rng = np.random.default_rng(5)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    xs = rng.standard_normal((2, 6, 4)).astype(np.float32)
    r = dist.get_rank()
    model = dist.DataParallel(_Lin(w, b))
    (model(torch.from_numpy(xs[r])) ** 2).sum().backward()
    out = {"grads": [_np(p.grad) for p in model.parameters()],
           "state_keys": sorted(model.state_dict())}
    hcg = _hybrid(fleet, dp=2)
    out["hcg"] = {"dp": hcg.get_data_parallel_world_size(),
                  "dp_rank": hcg.get_data_parallel_rank(),
                  "dp_group": hcg.get_data_parallel_group().ranks,
                  "worker": [fleet.fleet.worker_num,
                             fleet.fleet.worker_index]}
    out["wrapped"] = type(fleet.distributed_model(_Lin(w, b))).__name__
    fleet.fleet._strategy.hybrid_configs["dp_degree"] = 1
    out["unwrapped"] = type(fleet.distributed_model(_Lin(w, b))).__name__
    fleet.fleet._strategy.hybrid_configs["pp_degree"] = 2
    try:
        fleet.distributed_model(_Lin(w, b))
        out["pp"] = None
    except NotImplementedError as e:
        out["pp"] = str(e)
    return out


def _env(dist, state, ids, lr, tmp):
    """The launcher's variables as init_parallel_env read them, then a
    reform: the process group is destroyed and a second init meets the
    same world again under a fresh prefix."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import env

    out = {"vars": [os.environ.get(k) for k in (
        "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK")],
        "master": bool(os.environ.get("PADDLE_MASTER")),
        "pg": [tdist.get_rank(), tdist.get_world_size(),
               tdist.get_backend()], "initialized": env.is_initialized()}
    r, n = dist.get_rank(), dist.get_world_size()
    env.reform_parallel_env(r, n)
    out["after_reform"] = [tdist.is_initialized(), env.is_initialized()]
    dist.init_parallel_env(device="cpu")
    out["again"] = float(dist.all_reduce(torch.ones(())))
    return out


def nccl_clash():
    """init_parallel_env under PADDLE_DISTRI_BACKEND=nccl with both ranks
    given one (faked) CUDA device: the ValueError's text, raised before
    any backend starts."""
    torch.set_num_threads(1)
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import env

    os.environ["PADDLE_DISTRI_BACKEND"] = "nccl"
    env._local_cuda_device = lambda local_rank: torch.device("cuda", 0)
    env._device_identity = \
        lambda dev: "host-a/GPU-0f (cuda:0, NVIDIA H100 80GB HBM3)"
    try:
        env.init_parallel_env()
        msg = None
    except ValueError as e:
        msg = str(e)
    up = tdist.is_initialized()
    env.get_store().barrier("clash")    # rank 0 hosts the store: stay up
    return msg, up


def _errors(dist, state, ids, lr, tmp):
    """The divisibility error of a global batch of 3 rows at world 2."""
    from paddle_tpu_torch.jit import TrainStep

    model, opt = _gpt(state, lr)
    step = TrainStep(model, lambda x: model(x, labels=x), opt, device="cpu",
                     dp_axis="dp")
    try:
        step(ids[:3])
    except ValueError as e:
        return str(e)
    return None
