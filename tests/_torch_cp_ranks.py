"""Rank bodies for the port's context-parallel tests: each runs in a process
of its own, started by paddle_tpu_torch.distributed.spawn(backend="cpu"),
joins the gloo process group through init_parallel_env and returns numpy
results for the test process to hold against the JAX reference. This
module imports torch and the port only (no JAX)."""
import numpy as np
import torch


def _init():
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(device="cpu")
    return dist


def _np(t):
    return t.detach().float().numpy().copy()


def _shard(x, r, n, axis=1):
    m = x.shape[axis] // n
    return torch.from_numpy(np.take(x, range(r * m, (r + 1) * m),
                                    axis=axis).copy())


def _attention(fn, inputs, r, n, **kw):
    """fn on this rank's shards of q, k, v; the output shard and the
    shards' gradients under this rank's shard of the cotangent."""
    q, k, v = (_shard(inputs[x], r, n).requires_grad_(True)
               for x in ("q", "k", "v"))
    o = fn(q, k, v, **kw)
    (o * _shard(inputs["g"], r, n)).sum().backward()
    return {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad)}


def _attention_cases(dist, inputs, group):
    from paddle_tpu_torch.core import flags
    from paddle_tpu_torch.distributed import context_parallel as cp

    r, n = group.rank, group.nranks
    out = {}
    for flash in (True, False):
        flags.set_flags({"use_flash_attention": flash})
        for causal in (True, False):
            for mode, fn in (("ring", cp.ring_attention),
                             ("ulysses", cp.ulysses_attention)):
                out[(mode, causal, flash)] = _attention(
                    fn, inputs, r, n, axis_name=group, causal=causal)
    flags.set_flags({"use_flash_attention": True})
    return out


def attention(inputs):
    """Ring and Ulysses attention, causal and not, flash chunks on and off,
    over a sep mesh of the whole world."""
    dist = _init()
    n = dist.get_world_size()
    dist.set_mesh(dist.build_mesh(sep=n))
    group = dist.get_mesh().group("sep")
    return {"rank": group.rank,
            "cases": _attention_cases(dist, inputs, group)}


def _collectives(dist, inputs, group):
    """The differentiable permute and all-to-all, the sequence utilities'
    round trip, and the reference's errors."""
    from paddle_tpu_torch.distributed import context_parallel as cp

    r, n = group.rank, group.nranks
    out = {}
    x = torch.from_numpy(inputs["x"][r].copy()).requires_grad_(True)
    y = torch.from_numpy(inputs["y"][r].copy()).requires_grad_(True)
    perm = [(i, (i + 1) % n) for i in range(n)]
    px, py = dist.collective_permute((x, y), perm, group)
    c = torch.from_numpy(inputs["c"][r].copy())
    ((px * c).sum() + (py * 2 * c).sum()).backward()
    out["permute"] = [_np(px), _np(py), _np(x.grad), _np(y.grad)]
    a = torch.from_numpy(inputs["a2a"][r].copy()).requires_grad_(True)
    b = dist.alltoall_single(a, group, split_axis=2, concat_axis=1)
    cb = torch.from_numpy(inputs["a2a_cot"][r].copy())
    (b * cb).sum().backward()
    out["alltoall"] = [_np(b), _np(a.grad)]
    out["scatter"] = _np(cp.scatter_seq(
        torch.from_numpy(inputs["seq"][r].copy()), group))
    t = torch.from_numpy(inputs["ag_in"][r].copy()).requires_grad_(True)
    g = cp.all_gather_seq(t, group)
    (g * torch.from_numpy(inputs["ag_cot"][r].copy())).sum().backward()
    out["gather"] = [_np(g), _np(t.grad)]
    out["gather_alias"] = _np(cp.gather_seq(t, group))
    u = torch.from_numpy(inputs["rs_in"][r].copy()).requires_grad_(True)
    y = cp.reduce_scatter_seq(u, group)
    (y * torch.from_numpy(inputs["rs_cot"][r].copy())).sum().backward()
    out["reduce_scatter"] = [_np(y), _np(u.grad)]
    q = torch.zeros(1, 4, 3, 8)
    try:
        cp.ulysses_attention(q, q, q, group)
        out["heads_error"] = None
    except ValueError as e:
        out["heads_error"] = str(e)
    try:
        cp.sequence_parallel_attention(q, q, q, mode="zigzag")
        out["mode_error"] = None
    except ValueError as e:
        out["mode_error"] = str(e)
    return out


def _gpt_cfg(mode, rotary):
    from paddle_tpu_torch.models import GPTConfig

    return GPTConfig(vocab_size=128, hidden_size=32, num_layers=1,
                     num_heads=4, max_position_embeddings=32,
                     hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                     sequence_parallel=mode, use_rotary=rotary)


def _grads(model):
    out = {k: _np(p.grad) for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


def _gpt_grads(states, ids):
    """Each GPT case's loss and every gradient after backward(), on this
    rank; the gradients after a second, accumulating backward; the
    gradients of a loss taken on the gathered logits (model(x), no
    labels), and of one on GPTModel's gathered hidden states beside the
    same loss on a model that is not sequence-parallel, in fp32 and in
    float64."""
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.models.generation import causal_lm_loss

    out = {}
    x = torch.from_numpy(ids)
    for rotary in (False, True):
        w = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (*ids.shape, 32)).astype(np.float32))
        hidden_dense = []
        for dtype in (torch.float32, torch.float64):
            dense = GPTForCausalLM(_gpt_cfg(None, rotary), device="cpu")
            load_jax_state_dict(dense, states[rotary])
            (dense.to(dtype).gpt(x) * w.to(dtype)).sum().backward()
            hidden_dense.append({k: p.grad.double().numpy()
                                 for k, p in dense.named_parameters()})
        for mode in ("ring", "ulysses"):
            model = GPTForCausalLM(_gpt_cfg(mode, rotary), device="cpu")
            load_jax_state_dict(model, states[rotary])
            loss = model(x, labels=x)
            loss.backward()
            grads = {k: _np(p.grad) for k, p in model.named_parameters()}
            model(x, labels=x).backward()
            accumulated = _grads(model)
            logits = model(x)
            causal_lm_loss(logits, x).backward()
            on_logits = _grads(model)
            (model.gpt(x) * w).sum().backward()
            out[(mode, rotary)] = {
                "loss": float(loss.detach()), "grads": grads,
                "accumulated": accumulated, "logits": _np(logits),
                "on_logits": on_logits, "hidden": _grads(model),
                "hidden_dense": hidden_dense}
    return out


def sep_world(inputs, states, ids):
    """World 2: the attention cases, the collectives, and tiny GPT with
    sequence_parallel 'ring' and 'ulysses' (learned and rotary)."""
    dist = _init()
    n = dist.get_world_size()
    dist.set_mesh(dist.build_mesh(sep=n))
    group = dist.get_mesh().group("sep")
    out = {"rank": group.rank,
           "cases": _attention_cases(dist, inputs, group),
           "collectives": _collectives(dist, inputs, group),
           "gpt": _gpt_grads(states, ids)}
    return out


def _train(dist, state, batches, lr, mode):
    """Steps of TrainStep(dp_axis="dp") over the current mesh: the losses,
    the final parameters and the model hooks' state (mode None: a GPT
    that is not sequence-parallel)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.models.convert import load_jax_state_dict
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(_gpt_cfg(mode, True), device="cpu")
    load_jax_state_dict(model, state)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, lambda x: model(x, labels=x), opt, device="cpu",
                     dp_axis="dp", telemetry=True)
    losses = [float(step(b)) for b in batches]
    return {"losses": losses,
            "params": {k: _np(v) for k, v in model.state_dict().items()},
            "reduce_world": step._reduce_world,
            "parts": sorted(step.last_parts),
            "hooked": model.__dict__.get("_sp_grad_sum") is not None}


def dp_sep_world(inputs, state, batches, lr):
    """World 4: the attention cases over sep 4, then TrainSteps over dp 2
    x sep 2 (ring, Ulysses, and a GPT that is not sequence-parallel) from
    the same weights."""
    dist = _init()
    dist.set_mesh(dist.build_mesh(sep=4))
    group = dist.get_mesh().group("sep")
    out = {"rank": dist.get_rank(),
           "cases": _attention_cases(dist, inputs, group)}
    mesh = dist.build_mesh(dp=2, sep=2)
    dist.set_mesh(mesh)
    out["coord"] = mesh.coordinate(dist.get_rank())
    out["joint"] = mesh.joint_group(("dp", "sep")).ranks
    out["train"] = {mode: _train(dist, state, batches, lr, mode)
                    for mode in ("ring", "ulysses", None)}
    return out
