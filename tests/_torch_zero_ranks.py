"""Rank bodies for the port's ZeRO tests (tests/test_torch_sharding.py):
each runs in a process of its own, started by
paddle_tpu_torch.distributed.spawn(backend="cpu"), joins the gloo process
group through init_parallel_env and returns numpy results for the test
process to hold against the JAX reference and the port at world 1. This
module imports torch and the port only (no JAX)."""
import os
import time

import numpy as np
import torch

LEVELS = ("os", "os_g", "p_g_os")


def _init():
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(device="cpu")
    return dist


def _fleet(dist, **degrees):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(degrees)
    fleet.init(is_collective=True, strategy=strategy)
    return fleet


def _np_state(model):
    """The model's whole parameters as numpy (gathered at stage 3)."""
    from paddle_tpu_torch.models.convert import gather_state_dict

    zero = getattr(model, "_zero", None)
    if zero is None:
        return gather_state_dict(model)
    with zero.gathered():
        return gather_state_dict(model)


def _np_opt(opt):
    """opt.state_dict()'s tensors as numpy (whole: a collective)."""
    out = {}
    for k, v in opt.state_dict().items():
        if k == "master_weights":
            out.update({f"master.{n}": t.float().numpy().copy()
                        for n, t in v.items()})
        elif torch.is_tensor(v):
            out[k] = v.float().numpy().copy()
    return out


def _held_bytes(model, opt):
    """Bytes of the distinct storages this rank's parameters, gradients
    and optimizer buffers hold (between steps)."""
    seen = {}

    def add(t):
        if t is not None and torch.is_tensor(t):
            st = t.untyped_storage()
            seen[st.data_ptr()] = max(seen.get(st.data_ptr(), 0),
                                      st.nbytes())

    for p in model.parameters():
        add(p)
        add(p.grad)
    for g in opt._groups:
        for name in ("p", "g", "m", "v", "master", "full_p", "full_g"):
            add(getattr(g, name, None))
    return sum(seen.values())


def _model(cfg_kw, state, seed=0):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.convert import load_jax_state_dict

    model = GPTForCausalLM(GPTConfig(**cfg_kw), device="cpu", seed=seed)
    load_jax_state_dict(model, state)
    return model


def _train(dist, level, cfg_kw, state, batches, lr, clip, hybrid=False,
           dp_axis=None, o2=False):
    """Three TrainSteps (of `batches`) at `level` (None: no ZeRO) over the
    current mesh: the losses, the whole final parameters and moments,
    the bytes held between steps, the parts of the last step and the
    model and optimizer (for more cases)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = _model(cfg_kw, state)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    if o2:
        model, opt = amp.decorate(model, opt, level="O2")
    if hybrid:
        opt = fleet.distributed_optimizer(opt)
    if level is not None:
        model, opt, _ = dist.group_sharded_parallel(model, opt, level)
    level_o2 = "O2" if o2 else "O1"

    def loss_fn(x):
        with amp.auto_cast(enable=o2, level=level_o2, dtype="bfloat16"):
            return model(x, labels=x)

    step = TrainStep(model, loss_fn, opt, device="cpu", dp_axis=dp_axis,
                     telemetry=True)
    losses, held = [], []
    for b in batches:
        losses.append(float(step(b)))
        if level is not None:
            held.append(_held_bytes(model, opt))
    return {"losses": losses, "params": _np_state(model),
            "opt": _np_opt(opt), "held": held,
            "n_params": sum(p.numel() for p in model.parameters()),
            "parts": dict(step.last_parts),
            "clip": type(opt._grad_clip).__name__}, model, opt, loss_fn


LLAMA = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
             num_layers=2, num_heads=4, num_key_value_heads=2,
             max_position_embeddings=32)


class _Mlp(torch.nn.Module):
    """Two linear layers in a ModuleList and a parameter of the model's
    own: stage 3's units for a model that declares none."""

    def __init__(self, d=16):
        super().__init__()
        gen = torch.Generator().manual_seed(7)
        self.fc = torch.nn.ModuleList([torch.nn.Linear(d, 4 * d),
                                       torch.nn.Linear(4 * d, d)])
        self.scale = torch.nn.Parameter(torch.ones(d))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)

    def forward(self, x):
        h = torch.nn.functional.gelu(self.fc[0](x))
        return self.fc[1](h) * self.scale


class _Undeclared(_Mlp):
    """Declares units that leave the second layer and the scale out."""

    def zero_units(self):
        return [([self.fc[0]], self.fc[0], self.fc[0], ())]


def _small(kind, cfg_kw):
    """A seeded model of `kind` and its loss: the MLP (mse), GPTModel (the
    mean square of its hidden states) or a tiny Llama (its causal loss)."""
    if kind == "mlp":
        model = _Mlp()
        return model, lambda x, y: ((model(x) - y) ** 2).mean()
    if kind == "gpt_model":
        from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

        model = GPTForCausalLM(GPTConfig(**cfg_kw), device="cpu").gpt
        return model, lambda x: model(x).square().mean()
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu")
    return model, lambda x: model(x, labels=x)


def _small_train(dist, kind, cfg_kw, level, batches, dp_axis=None):
    """Three steps of a `_small` model: the losses and the whole
    parameters; under ZeRO also the units' gathered bytes and each step's
    peak of live gathered bytes."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    model, loss_fn = _small(kind, cfg_kw)
    opt = AdamW(1e-2, parameters=model.parameters(), weight_decay=0.01)
    if level is not None:
        model, opt, _ = dist.group_sharded_parallel(model, opt, level)
    step = TrainStep(model, loss_fn, opt, device="cpu", dp_axis=dp_axis,
                     telemetry=True)
    losses, peaks = [], []
    for b in batches:
        losses.append(float(step(*(b if isinstance(b, tuple) else (b,)))))
        peaks.append(step.last_parts.get("gathered_peak_bytes"))
    out = {"losses": losses, "params": _np_state(model)}
    zero = getattr(model, "_zero", None)
    if zero is not None:
        out.update(peaks=peaks, unit_bytes=[
            sum(u.padded * u.buf.element_size() for u in s.units)
            for s in zero.scopes])
    return out


def _square_sum_case(model, opt, loss_fn, batch, group):
    """At "os": one backward, then the optimizer's square-sum (from the
    reduce-scattered shards) and its clip's factor, against the square-sum
    of the averaged whole gradient (every rank's gradient all-reduced
    here) and the factor from it."""
    from paddle_tpu_torch.distributed import collective

    zero = opt._zero
    zero.begin_step()
    loss_fn(torch.from_numpy(zero.shard_batch((batch,))[0])).backward()
    whole = torch.cat([g.full_g.clone() for g in opt._groups])
    collective.all_reduce(whole, group=group)
    whole /= group.nranks
    want = float(whole.double().square().sum())
    zero.reduce_gradients()
    sq = opt.grad_square_sum()
    factor = opt._grad_clip.factor(sq)
    clip = opt._grad_clip.clip_norm
    opt.clear_grad()
    return {"square_sum": float(sq), "want": want,
            "factor": float(factor),
            "want_factor": clip / max(want ** 0.5, clip)}


def _errors(dist, cfg_kw, state):
    """The refusals, as 'Type: message' strings."""
    from paddle_tpu_torch.optimizer import AdamW

    out = {}

    def catch(key, fn):
        try:
            fn()
            out[key] = None
        except (ValueError, NotImplementedError, RuntimeError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    def gsp(level="os", mesh=True, **kw):
        model = _model(cfg_kw, state)
        opt = AdamW(1e-3, parameters=model.parameters())
        return dist.group_sharded_parallel(model, opt, level, **kw)

    mesh = dist.get_mesh()
    catch("offload", lambda: gsp(offload=True))
    catch("sync_buffers", lambda: gsp(sync_buffers=True))
    catch("buffer_max_size", lambda: gsp(buffer_max_size=1 << 23))
    catch("sync_comm", lambda: gsp(sync_comm=True))
    catch("segment_size", lambda: gsp(segment_size=1 << 20))
    catch("dp_group", lambda: gsp(dp_group=mesh.group("sharding")))
    catch("dp_group_of_the_mesh", lambda: gsp(dp_group=mesh.group("dp")))
    catch("level", lambda: gsp(level="p_g"))

    def undeclared():
        model = _Undeclared()
        opt = AdamW(1e-3, parameters=model.parameters())
        dist.group_sharded_parallel(model, opt, "p_g_os")

    catch("units", undeclared)
    for axis in ("mp", "sep"):
        dist.set_mesh(dist.build_mesh(**{axis: 2}))
        catch(axis, gsp)
    dist.set_mesh(None)
    catch("no_mesh", gsp)
    dist.set_mesh(dist.build_mesh(dp=2))
    catch("no_axis", lambda: gsp(group=type("G", (), {"axis_name": "zz"})))
    dist.set_mesh(mesh)
    return out


def zero_world(cfg_kw, state, batches, lr, clip, ckpt_root, ref_ckpt,
               o2_lr):
    """World 2 (sharding 2, through fleet.init): the three stages with
    the hybrid optimizer's clip (against the reference); the three stages
    and TrainStep(dp_axis="dp") without a clip (bitwise); the square-sum
    at "os"; the master form at "os_g" under O2, with a clip (against
    world 1) and without (against dp, bitwise); stage 3 of an MLP (units
    it does not declare), of GPTModel and of a tiny Llama against dp;
    checkpoints written at
    "p_g_os" (async) and "os", and the reference's rank-sharded write
    (once the test process has written it to `ref_ckpt`) loaded at
    "os_g"; the refusals."""
    dist = _init()
    fleet = _fleet(dist, sharding_degree=2)
    hcg = fleet.get_hybrid_communicate_group()
    group = hcg.get_sharding_parallel_group()
    rank = dist.get_rank()
    out = {"rank": rank, "sharding_ranks": group.ranks,
           "sharding_degree": hcg.get_sharding_parallel_world_size()}
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed import sharding

    for level in LEVELS:
        res, model, opt, loss_fn = _train(dist, level, cfg_kw, state,
                                          batches, lr, clip, hybrid=True)
        res["owned_state"] = sharding.zero_state_sharding(
            opt, list(model.parameters()))
        res["owned_grad"] = sharding.zero_grad_sharding(
            opt, list(model.parameters()))
        if level == "os":
            res["square_sum"] = _square_sum_case(model, opt, loss_fn,
                                                 batches[0], group)
            ck.save_model_sharded(model, os.path.join(ckpt_root, level),
                                  opt)
        if level == "p_g_os":
            sharding.save_group_sharded_model(
                model, os.path.join(ckpt_root, level), opt, async_save=True)
            ck.wait_all()
        out[("clip", level)] = res
    for level in LEVELS:
        out[("plain", level)] = _train(dist, level, cfg_kw, state, batches,
                                       lr, None)[0]
    out["o2"] = _train(dist, "os_g", cfg_kw, state, batches, o2_lr, clip,
                       o2=True)[0]
    out["o2_plain"] = _train(dist, "os_g", cfg_kw, state, batches, o2_lr,
                             None, o2=True)[0]
    rng = np.random.default_rng(5)
    small = {"mlp": [(rng.standard_normal((8, 16)).astype(np.float32),
                      rng.standard_normal((8, 16)).astype(np.float32))
                     for _ in range(3)],
             "gpt_model": batches, "llama": batches}
    for kind, bs in small.items():
        out[kind] = _small_train(dist, kind, cfg_kw, "p_g_os", bs)
    mesh = dist.get_mesh()
    dist.set_mesh(dist.build_mesh(dp=2))
    out["dp"] = _train(dist, None, cfg_kw, state, batches, lr, None,
                       dp_axis="dp")[0]
    out["o2_dp"] = _train(dist, None, cfg_kw, state, batches, o2_lr, None,
                          dp_axis="dp", o2=True)[0]
    for kind, bs in small.items():
        out[f"{kind}_dp"] = _small_train(dist, kind, cfg_kw, None, bs,
                                         dp_axis="dp")
    dist.set_mesh(mesh)
    _, model, opt, _ = _train(dist, "os_g", cfg_kw, state, batches[:1], lr,
                              None)
    deadline = time.monotonic() + 240     # the test process writes it
    while not ck.is_rank_sharded(ref_ckpt):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no checkpoint at {ref_ckpt}")
        time.sleep(0.05)
    ck.load_model_sharded(model, ref_ckpt, opt)
    out["loaded"] = {"params": _np_state(model), "opt": _np_opt(opt)}
    out["errors"] = _errors(dist, cfg_kw, state)
    return out


def dp_sharding_world(cfg_kw, state, batches, lr, clip):
    """World 4, dp 2 x sharding 2 through fleet, at "os_g" with the
    hybrid optimizer's clip: the groups and the run."""
    dist = _init()
    fleet = _fleet(dist, dp_degree=2, sharding_degree=2)
    hcg = fleet.get_hybrid_communicate_group()
    res = _train(dist, "os_g", cfg_kw, state, batches, lr, clip,
                 hybrid=True)[0]
    res.update(rank=dist.get_rank(),
               dp_group=hcg.get_data_parallel_group().ranks,
               sharding_group=hcg.get_sharding_parallel_group().ranks)
    return res
