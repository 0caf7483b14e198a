"""Rank bodies for the port's tensor-parallel tests: each runs in a process
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(layer, **arrays):
    """Fill each named parameter with its block of the whole array."""
    from paddle_tpu_torch.distributed.mesh import shard_block

    with torch.no_grad():
        for name, a in arrays.items():
            p = getattr(layer, name)
            p.copy_(shard_block(_t(a), p))


def _run(layer, x, cot, params):
    """layer(x) and the gradients of (out * cot).sum() (`cot` this rank's
    block of the cotangent when the output is), as numpy: the output,
    x's gradient and each parameter's (this rank's blocks)."""
    x = x.clone().requires_grad_(x.is_floating_point())
    out = layer(x)
    (out * cot).sum().backward()
    res = {"out": _np(out), **{k: _np(getattr(layer, k).grad)
                               for k in params}}
    if x.is_floating_point():
        res["dx"] = _np(x.grad)
    return res


def _block(a, group, axis):
    m = a.shape[axis] // group.nranks
    return np.take(a, range(group.rank * m, (group.rank + 1) * m), axis=axis)


def _layers(inputs, group):
    """Every mp layer at mp 2 on the reference's inputs and weights (see
    the test module): outputs and gradients, this rank's blocks."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import nn_ops

    i, g = inputs, group
    out = {}
    for gather in (True, False):
        col = fleet.ColumnParallelLinear(8, 16, gather_output=gather,
                                         mp_group=g)
        _load(col, weight=i["wc"], bias=i["bc"])
        cot = i["cot_cg"] if gather else _block(i["cot_cn"], g, -1)
        out[("col", gather)] = _run(col, _t(i["x8"]), _t(cot),
                                    ("weight", "bias"))
    for parallel in (True, False):
        row = fleet.RowParallelLinear(16, 8, input_is_parallel=parallel,
                                      mp_group=g)
        _load(row, weight=i["wr"], bias=i["br"])
        x = _block(i["x16"], g, -1) if parallel else i["x16"]
        out[("row", parallel)] = _run(row, _t(x), _t(i["cot_r"]),
                                      ("weight", "bias"))
    emb = fleet.VocabParallelEmbedding(32, 8, mp_group=g)
    _load(emb, weight=i["we"])
    out["emb"] = _run(emb, _t(i["ids"]), _t(i["cot_e"]), ("weight",))
    for key in ("labels", "labels_ig"):
        lg = _t(_block(i["logits"], g, -1)).requires_grad_(True)
        loss = fleet.ParallelCrossEntropy(mp_group=g)(lg, _t(i[key]))
        (loss * _t(i["cot_ce"])).sum().backward()
        out[("pce", key)] = {"out": _np(loss), "dlogits": _np(lg.grad)}
    col = fleet.ColumnSequenceParallelLinear(16, 32, mp_group=g)
    row = fleet.RowSequenceParallelLinear(32, 16, mp_group=g)
    _load(col, weight=i["w1"], bias=i["b1"])
    _load(row, weight=i["w2"], bias=i["b2"])
    xs = _t(_block(i["xs"], g, 1)).requires_grad_(True)
    y = row(nn_ops.gelu(col(xs), approximate=True))
    (y * _t(_block(i["cot_sp"], g, 1))).sum().backward()
    out["sp"] = {"out": _np(y), "dx": _np(xs.grad),
                 "w1": _np(col.weight.grad), "b1": _np(col.bias.grad),
                 "w2": _np(row.weight.grad),
                 "b2_partial": _np(row.bias.grad),
                 "marked": [bool(getattr(p, "sequence_parallel", False))
                            for p in (col.weight, col.bias, row.weight,
                                      row.bias)]}
    return out


def _split(inputs, weights):
    """collective.split in its three forms at mp 2: built at the first
    call, then given this rank's blocks of the reference's weights and
    called again (the per-name cache hands back the same layer)."""
    from paddle_tpu_torch.distributed import collective

    out = {}
    for key, x, size, op, axis in (
            ("emb", inputs["ids"], (32, 8), "embedding", 0),
            ("row", inputs["x16"], (16, 8), "linear", 0),
            ("col", inputs["x8"], (8, 16), "linear", 1)):
        x = _t(x)
        first = collective.split(x, size, operation=op, axis=axis,
                                 name=f"t_{key}")
        layer = collective._split_layer_cache[f"t_{key}"]
        _load(layer, **weights[key])
        again = collective.split(x, size, operation=op, axis=axis,
                                 name=f"t_{key}")
        out[key] = {"first_shape": list(first.shape), "out": _np(again),
                    "cached": collective._split_layer_cache[f"t_{key}"]
                    is layer}
    return out


def _grads(model):
    from paddle_tpu_torch.models.convert import gather_state_dict

    replicated = {k: _np(p.grad) for k, p in model.named_parameters()
                  if getattr(p, "_mp_shard", None) is None}
    for p in model.parameters():
        p.data = p.grad           # gather the gradients through the blocks
    return gather_state_dict(model), replicated


def _model(kind, cfg_kw, state, under_mesh, dist):
    """A tiny GPT or Llama filled with the reference's state: built under
    the mp mesh (cut at construction), or built whole with no mesh and cut
    afterwards by shard_model_parameters."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.models.convert import load_jax_state_dict

    cls, cfg = ((GPTForCausalLM, GPTConfig(**cfg_kw)) if kind == "gpt"
                else (LlamaForCausalLM, LlamaConfig(**cfg_kw)))
    mesh = dist.get_mesh()
    if under_mesh:
        model = cls(cfg, device="cpu")
        load_jax_state_dict(model, state)
        return model
    dist.set_mesh(None)
    model = cls(cfg, device="cpu")
    load_jax_state_dict(model, state)
    dist.set_mesh(mesh)
    return dist.shard_model_parameters(model, mesh)


def _model_case(kind, cfg_kw, state, ids, under_mesh, dist):
    """Loss and every gathered gradient; the replicated gradients of this
    rank; the gathered logits."""
    model = _model(kind, cfg_kw, state, under_mesh, dist)
    x = _t(ids)
    loss = model(x, labels=x)
    loss.backward()
    logits = model(x)
    grads, replicated = _grads(model)
    return {"loss": float(loss.detach()), "grads": grads,
            "replicated": replicated, "logits": _np(logits)}


def _heads(cfg_kw, state, ids, group, dist):
    """GPT's head-major qkv: this rank's q, k and v (from its block of the
    qkv_proj columns) against heads rank * H/n onwards of the whole
    model's."""
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.convert import load_jax_state_dict

    cfg = GPTConfig(**cfg_kw)
    hd = cfg.hidden_size // cfg.num_heads
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, cfg.hidden_size)).astype(np.float32))
    mesh = dist.get_mesh()
    dist.set_mesh(None)
    whole = GPTForCausalLM(cfg, device="cpu")
    load_jax_state_dict(whole, state)
    with torch.no_grad():
        full = whole.gpt.blocks[0].attn.qkv_proj(x).reshape(
            2, 5, cfg.num_heads, 3 * hd).split(hd, dim=-1)
    dist.set_mesh(mesh)
    cut = GPTForCausalLM(cfg, device="cpu")
    load_jax_state_dict(cut, state)
    with torch.no_grad():
        mine = cut.gpt.blocks[0].attn.qkv_proj(x).reshape(
            2, 5, -1, 3 * hd).split(hd, dim=-1)
    h = mine[0].shape[2]
    return {"heads_a_rank": h, "diff": [float((
        m - f[:, :, group.rank * h:(group.rank + 1) * h]).abs().max())
        for m, f in zip(mine, full)]}


def _replicated(model):
    return [_np(p) for p in model.parameters()
            if getattr(p, "_mp_shard", None) is None]


def _train(cfg_kw, state, batches, lr, clip, hybrid, dist, dp_axis=None):
    """Steps of TrainStep over the current mesh: the losses, the replicated
    parameters after every step, the gathered final parameters and the
    step's parts. `hybrid`: the optimizer through fleet's
    distributed_optimizer (HybridParallelClipGrad.factor)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.convert import gather_state_dict
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = _model("gpt", cfg_kw, state, True, dist)
    opt = AdamW(lr, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(clip))
    if hybrid:
        opt = fleet.distributed_optimizer(opt)
    step = TrainStep(model, lambda x: model(x, labels=x), opt, device="cpu",
                     dp_axis=dp_axis, telemetry=True)
    losses, replicated = [], []
    for b in batches:
        losses.append(float(step(b)))
        replicated.append(_replicated(model))
    return {"losses": losses, "replicated": replicated,
            "params": gather_state_dict(model),
            "parts": sorted(step.last_parts), "clip": type(
                opt._grad_clip).__name__, "mp_world": step._mp_world}


class _PairNet(torch.nn.Module):
    """LayerNorm -> ColumnSequenceParallelLinear -> GELU (tanh) ->
    RowSequenceParallelLinear on this rank's sequence shard; the norm's
    parameters marked sequence-parallel."""

    def __init__(self, group=None):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet import mp_layers
        from paddle_tpu_torch.nn import LayerNorm

        self.ln = LayerNorm(16)
        for p in self.ln.parameters():
            mp_layers.mark_as_sequence_parallel_parameter(p)
        self.col = mp_layers.ColumnSequenceParallelLinear(16, 32,
                                                          mp_group=group)
        self.row = mp_layers.RowSequenceParallelLinear(32, 16,
                                                       mp_group=group)

    def forward(self, x):
        from paddle_tpu_torch.ops import nn_ops

        return self.row(nn_ops.gelu(self.col(self.ln(x)), approximate=True))


def _pair_train(state, batches, lr, group):
    """Three TrainSteps of _PairNet at mp 2, each rank on its half of the
    sequence; the loss is the mean square of the whole output (the ranks'
    sums all-reduced)."""
    from paddle_tpu_torch.distributed.collective import all_reduce_autograd
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.convert import (gather_state_dict,
                                                 load_jax_state_dict)
    from paddle_tpu_torch.optimizer import AdamW

    net = _PairNet(group)
    load_jax_state_dict(net, state)
    opt = AdamW(lr, parameters=net.parameters(), weight_decay=0.01)

    def loss_fn(x):
        y = net(_t(_block(x.numpy(), group, 1)))
        return all_reduce_autograd((y * y).sum(), group) / x.numel()

    step = TrainStep(net, loss_fn, opt, device="cpu")
    losses = [float(step(_t(b))) for b in batches]
    return {"losses": losses, "params": gather_state_dict(net),
            "sp_params": len(step._sp_params)}


def _errors(dist):
    """The refusals at mp 2, message by message."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    out = {}
    kw = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=4,
              max_position_embeddings=32, hidden_dropout_prob=0.0,
              attention_dropout_prob=0.0)

    def catch(key, fn):
        try:
            fn()
            out[key] = None
        except (ValueError, NotImplementedError, RuntimeError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    catch("heads", lambda: GPTForCausalLM(GPTConfig(
        **dict(kw, num_heads=1)), device="cpu"))
    catch("vocab", lambda: GPTForCausalLM(GPTConfig(
        **dict(kw, vocab_size=127)), device="cpu"))
    catch("inter", lambda: GPTForCausalLM(GPTConfig(
        **dict(kw, intermediate_size=33)), device="cpu"))
    catch("sep", lambda: GPTForCausalLM(GPTConfig(
        **dict(kw, sequence_parallel="ring")), device="cpu"))
    model = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    catch("zero", lambda: dist.shard_model_parameters(
        model, dist.get_mesh(), zero_axis="sharding"))
    catch("cache", lambda: model.generate(torch.zeros(1, 4,
                                                      dtype=torch.int64),
                                          max_new_tokens=2))
    catch("axis", lambda: dist.annotate_param(
        torch.nn.Parameter(torch.zeros(4)), dist.PartitionSpec("xx")))
    catch("annotate_dim", lambda: dist.annotate_param(
        torch.nn.Parameter(torch.zeros(3, 4)), ("mp", None), "w3"))
    catch("rsp", lambda: fleet.RowSequenceParallelLinear(
        8, 4, input_is_parallel=False)(torch.zeros(1, 2, 4)))
    mesh = dist.get_mesh()
    dist.set_mesh(None)
    whole = fleet.ColumnParallelLinear(4, 8)
    dist.set_mesh(mesh)
    catch("whole", lambda: whole(torch.zeros(2, 4)))
    return out


def mp_world(inputs, states, cfgs, ids, batches, lr, clip, seeded_kw):
    """World 2, mp 2 (fleet.init at mp_degree 2): the layers, split, the head layout, tiny GPT (cut
    at construction) and Llama (cut by shard_model_parameters), a seeded
    GPT gathered, TrainSteps (plain and hybrid clip), the Megatron pair in
    TrainStep, and the refusals."""
    dist = _init()
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["mp_degree"] = 2
    fleet.init(is_collective=True, strategy=strategy)
    group = dist.get_mesh().group("mp")
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.convert import gather_state_dict

    out = {"rank": group.rank, "mp_ranks": group.ranks,
           "layers": _layers(inputs, group),
           "split": _split(inputs, states["split"]),
           "heads": _heads(cfgs["gpt"], states["gpt"], ids, group, dist),
           "gpt": _model_case("gpt", cfgs["gpt"], states["gpt"], ids, True,
                              dist),
           "llama": _model_case("llama", cfgs["llama"], states["llama"],
                                ids, False, dist),
           "seeded": gather_state_dict(GPTForCausalLM(
               GPTConfig(**cfgs["gpt"]), device="cpu", seed=seeded_kw))}
    out["train"] = {hybrid: _train(cfgs["gpt"], states["gpt"], batches, lr,
                                   clip, hybrid, dist)
                    for hybrid in (False, True)}
    out["pair_train"] = _pair_train(states["pair"], inputs["pair_batches"],
                                    lr, group)
    out["errors"] = _errors(dist)
    return out


def dp_mp_world(cfgs, states, batches, lr, clip):
    """World 4, dp 2 x mp 2 through fleet: the mesh's groups, shard_batch,
    distributed_model, and TrainStep(dp_axis="dp") with the hybrid
    optimizer."""
    dist = _init()
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dp_degree=2, mp_degree=2)
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    mesh = dist.get_mesh()
    rows = dist.shard_batch({"ids": batches[0], "both": (batches[0],)},
                            mesh)
    wrapped = fleet.distributed_model(torch.nn.Linear(2, 2))
    out = {"rank": dist.get_rank(),
           "dp_group": hcg.get_data_parallel_group().ranks,
           "mp_group": hcg.get_model_parallel_group().ranks,
           "rows": rows, "wrapped": [type(wrapped).__name__,
                                     wrapped._group.ranks],
           "train": _train(cfgs["gpt"], states["gpt"], batches, lr, clip,
                           True, dist, dp_axis="dp")}
    return out
