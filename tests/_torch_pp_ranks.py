"""Rank bodies for the port's pipeline tests (tests/test_torch_pipeline.py):
each runs in a process of its own, started by
paddle_tpu_torch.distributed.spawn(backend="cpu"), joins the gloo process
group through init_parallel_env and returns numpy results for the test
process to hold against the JAX reference. This module imports torch and
the port only (no JAX)."""
import numpy as np
import torch


def _init():
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(device="cpu")
    return dist


def _t(tree):
    """numpy leaves (float64 rigs as float32) -> torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy().copy()


# -- the reference's rigs (tests/test_pipeline.py), in torch ----------------

def stage_fn(p, x):
    return torch.tanh(x @ p["W"] + p["b"])


def loss_fn(lp, y, lab):
    return ((y @ lp["w"] - lab) ** 2).mean()


def pre_fn(sh, x):
    return sh["emb"][x]


def post_fn(sh, y):
    return y @ sh["emb"].t()


def ce_fn(lp, logits, lab):
    logits = logits + lp["bias"]
    lse = torch.logsumexp(logits, -1)
    tok = logits.gather(-1, lab[..., None].long())[..., 0]
    return (lse - tok).mean()


def _engine_case(mesh, case):
    """One engine run on this rank's block; its results as numpy."""
    from paddle_tpu_torch.distributed import pipeline as pl

    S, V = case["S"], case.get("V", 1)
    r = mesh.group("pp").rank
    sp = _t(pl.rank_block(case["sp"], r, S, V))
    lp, xs, labels = _t(case["lp"]), _t(case["xs"]), _t(case["labels"])
    kind = case["kind"]
    out = {}
    if kind in ("1F1B", "FThenB"):
        loss, d_sp, d_lp, d_xs = pl.ENGINES[kind](
            stage_fn, loss_fn, mesh, S, sp, lp, xs, labels)
    elif kind == "Interleave":
        loss, d_sp, d_sh, d_lp, d_xs = pl.pipeline_interleave(
            stage_fn, loss_fn, mesh, S, sp, lp, xs, labels, n_virtual=V)
    else:               # the tied-embedding rig
        loss, d_sp, d_sh, d_lp, d_xs = pl.pipeline_interleave(
            stage_fn, ce_fn, mesh, S, sp, lp, xs, labels, n_virtual=V,
            pre_fn=pre_fn, post_fn=post_fn, shared_params=_t(case["sh"]))
        out["d_sh"] = _np(d_sh)
    out.update(loss=float(loss), d_sp=_np(d_sp), d_lp=_np(d_lp),
               d_xs=_np(d_xs), stats=pl.last_stats())
    return out


# -- the layer-level models --------------------------------------------------

class Block(torch.nn.Module):
    """The reference test's _Block: tanh(fc(x)), fc [in, out] + bias."""

    def __init__(self, d):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet import ColumnParallelLinear

        self.fc = ColumnParallelLinear(d, d)

    def forward(self, x):
        return torch.tanh(self.fc(x))


class Other(torch.nn.Module):
    def __init__(self, d, k):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet import ColumnParallelLinear

        self.fc = ColumnParallelLinear(d, k)

    def forward(self, x):
        return self.fc(x)


def mse(out, label):
    return ((out - label) ** 2).mean()


def ce(out, label):
    from paddle_tpu_torch.ops import nn_ops

    return nn_ops.cross_entropy(out.reshape(-1, out.shape[-1]),
                                label.reshape(-1))


def head_fwd(layer, x):
    from paddle_tpu_torch.ops import nn_ops

    return nn_ops.matmul(x, layer.weight, transpose_y=True)


def _strategy(fleet, **pipeline):
    st = fleet.DistributedStrategy()
    st.pipeline_configs.update(pipeline)
    return st


def _adamw(params, spec, hybrid_hcg=None):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    clip = spec.get("clip")
    opt = AdamW(spec["lr"], epsilon=spec.get("eps", 1e-8),
                parameters=params, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    if hybrid_hcg is not None:
        return fleet.HybridParallelOptimizer(opt, hybrid_hcg)
    return opt


def _square_sums(model, opt, batch):
    """The global square-sum of one batch's pipeline gradients as the
    fused AdamW, its clip (plain or hybrid) and nn/clip.grad_square_sum
    compute it on this rank; the gradients are cleared after."""
    from paddle_tpu_torch.nn.clip import grad_square_sum

    _, grads = model._run_engine(model._micro(batch[0]),
                                 model._micro(batch[1]))
    params = model.parameters()
    for p, g in zip(params, grads):
        p.grad = g
    out = {"adamw": float(opt.grad_square_sum()),
           "grad_square_sum": float(grad_square_sum(grads, params))}
    clip = opt._grad_clip
    if hasattr(clip, "global_square_sum"):
        out["hybrid"] = float(clip.global_square_sum(grads, params))
    opt.clear_grad()
    return out


def _train(model, opt, batches):
    """train_batch over `batches`: the losses, the engine's counters, this
    rank's mesh coordinate, the whole state (every stage broadcast to
    every rank, each mp block gathered) and this rank's own state_dict
    (its mp blocks)."""
    from paddle_tpu_torch.distributed import get_mesh, get_rank
    from paddle_tpu_torch.distributed import pipeline as pl
    from paddle_tpu_torch.models.convert import gather_state_dict

    losses = [float(model.train_batch(b, opt)) for b in batches]
    local = _np(dict(model.state_dict()))
    return {"losses": losses, "stats": pl.last_stats(),
            "coord": get_mesh().coordinate(get_rank()),
            "state": gather_state_dict(model._layers), "local": local,
            "cut": sorted(n for n, p in model._layers.named_parameters()
                          if getattr(p, "_mp_shard", None) is not None)}


def _errors(fn):
    try:
        fn()
    except Exception as e:      # the refusal, as 'Type: message'
        return f"{type(e).__name__}: {e}"
    return None


def _lm(kind, cfg_kw, state, whole=False):
    """A port GPT or Llama on the CPU holding the reference's weights, its
    pipeline_descs and a PipelineLayer of two stages filled by
    copy_weights. The model is built under the current mesh (its mp
    blocks), or `whole` with no mesh; the PipelineLayer under the mesh."""
    from paddle_tpu_torch.distributed import get_mesh, set_mesh
    from paddle_tpu_torch.distributed.fleet import PipelineLayer
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.models.convert import load_jax_state_dict

    mesh = get_mesh()
    if whole:
        set_mesh(None)
    try:
        if kind == "llama":
            model = LlamaForCausalLM(LlamaConfig(**cfg_kw), device="cpu")
        else:
            model = GPTForCausalLM(GPTConfig(**cfg_kw), device="cpu")
        load_jax_state_dict(model, state)
    finally:
        set_mesh(mesh)
    descs, loss, copy_weights = model.pipeline_descs()
    pl = PipelineLayer(descs, num_stages=2, loss_fn=loss)
    copy_weights(pl)
    return model, pl, copy_weights


def world2(engine_cases, lms, batches, spec):
    """pp 2: the engines' cases, then GPT (tied, through
    fleet.distributed_model and the hybrid optimizer's clip; untied, a
    plain clip) and Llama through pipeline_descs, one train_batch each
    after the square-sum probe, and the refusals of a pp-2 mesh."""
    dist = _init()
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import (LayerDesc, PipelineLayer,
                                                    PipelineParallel)

    mesh = dist.build_mesh(pp=2)
    res = {"engines": {k: _engine_case(mesh, c)
                       for k, c in engine_cases.items()}}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["pp_degree"] = 2
    strategy.pipeline_configs["accumulate_steps"] = spec["M"]
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    for name, (kind, cfg_kw, state) in lms.items():
        model, pl, copy_weights = _lm(kind, cfg_kw, state)
        copied = _np(dict(pl.state_dict()))
        if name == "gpt":
            pp = fleet.distributed_model(pl)
            opt = fleet.distributed_optimizer(
                _adamw(pp.parameters(), spec))
        else:
            pp = PipelineParallel(pl, hcg, strategy)
            opt = _adamw(pp.parameters(), spec)
        batch = tuple(torch.from_numpy(b) for b in batches[0])
        sq = _square_sums(pp, opt, batch)
        out = _train(pp, opt, [batch])
        copy_weights(pl, reverse=True)
        back = {n: float((p.detach() - dict(pl.named_parameters())[
            n_pl].detach()).abs().max())
            for n, p, n_pl in _mapped(model, pl, kind, cfg_kw)}
        res[name] = {**out, "copied": copied, "square_sums": sq,
                     "reverse_max_dev": max(back.values()),
                     "wrapper": type(pp).__name__,
                     "clip": type(opt._grad_clip).__name__,
                     "devices": sorted({str(p.device)
                                        for p in pp.parameters()})}
    d = 8
    errs = {}
    errs["heterogeneous"] = _errors(lambda: PipelineParallel(PipelineLayer(
        [Block(d), Block(d), Block(d), Other(d, 4)], num_stages=2,
        loss_fn=mse), hcg, strategy))
    errs["vpp_mismatch"] = _errors(lambda: PipelineParallel(PipelineLayer(
        [LayerDesc(Block, d) for _ in range(4)], num_stages=2,
        loss_fn=mse), hcg, _strategy(fleet, virtual_pp_degree=2)))
    errs["stage_count"] = _errors(lambda: PipelineParallel(PipelineLayer(
        [LayerDesc(Block, d) for _ in range(4)], num_stages=4,
        loss_fn=mse), hcg, strategy))
    res["errors"] = errs
    return res


def _mapped(model, pl, kind, cfg_kw):
    """(model name, model parameter, PipelineLayer name) of the block
    weights copy_weights carries (the ends are checked by state_dict)."""
    blocks = model.model.layers if kind == "llama" else model.gpt.blocks
    prefix = "block." if kind == "llama" else ""
    for i, blk in enumerate(blocks):
        for n, p in blk.named_parameters():
            yield f"{i}.{n}", p, f"run_function.{i}.{prefix}{n}"


def _reverse_dev(model, pl, kind):
    """The largest |model - pipeline| over the block weights after
    copy_weights(reverse=True), each pipeline block against the model's
    block of it (a whole model against a cut pipeline)."""
    from paddle_tpu_torch.distributed.mesh import shard_block

    named = dict(pl.named_parameters())
    devs = []
    for _, p, n_pl in _mapped(model, pl, kind, None):
        q = named[n_pl].detach()
        m = p.detach()
        m = m if m.shape == q.shape else shard_block(m, named[n_pl])
        devs.append(float((m - q).abs().max()))
    return max(devs)


def _lm_run(kind, cfg_kw, state, batch, spec, via_fleet, whole, probe):
    """One LM through pipeline_descs on the current hybrid mesh: the
    copied state (gathered), the square-sum probe (without dp), one
    train_batch on this rank's rows and the reverse copy's deviation."""
    from paddle_tpu_torch.distributed import fleet, get_mesh
    from paddle_tpu_torch.distributed.fleet import PipelineParallel
    from paddle_tpu_torch.distributed.sharding_utils import shard_batch
    from paddle_tpu_torch.models.convert import gather_state_dict

    model, pl, copy_weights = _lm(kind, cfg_kw, state, whole)
    copied = gather_state_dict(pl)
    hcg = fleet.get_hybrid_communicate_group()
    if via_fleet:
        pp = fleet.distributed_model(pl)
        opt = fleet.distributed_optimizer(_adamw(pp.parameters(), spec))
    else:
        pp = PipelineParallel(pl, hcg, fleet.fleet._strategy)
        opt = _adamw(pp.parameters(), spec)
    mine = shard_batch(tuple(torch.from_numpy(b) for b in batch),
                       get_mesh(), ("dp",))
    sq = _square_sums(pp, opt, mine) if probe else None
    out = _train(pp, opt, [mine])
    copy_weights(pl, reverse=True)
    return {**out, "copied": copied, "square_sums": sq,
            "reverse_max_dev": _reverse_dev(model, pl, kind),
            "wrapper": type(pp).__name__,
            "clip": type(opt._grad_clip).__name__,
            "whole_model": whole}


def _hybrid(fleet, M, **degrees):
    st = fleet.DistributedStrategy()
    st.hybrid_configs.update(degrees)
    st.pipeline_configs["accumulate_steps"] = M
    fleet.init(is_collective=True, strategy=st)


def world4(engine_cases, block_state, tied_state, block_batch, tied_batch,
           spec, lms, lm_batch, lm_spec):
    """pp 4: the engines' cases; the block model (1F1B, then F-then-B) and
    the tied-embedding model (S = 4, V = 2) from the reference's
    PipelineLayer state_dict, one train_batch each. dp 2 x pp 2: the
    block model (two blocks a stage, 1F1B) and the tied GPT through
    fleet.distributed_model, on this rank's rows. pp 2 x mp 2: GPT and
    Llama, tied and untied, through pipeline_descs (Llama's model whole,
    GPT's cut, so copy_weights takes blocks one way and gathers the
    other). Then pp beside sep, which PipelineParallel refuses."""
    dist = _init()
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import (LayerDesc, PipelineLayer,
                                                    PipelineParallel,
                                                    SharedLayerDesc)
    from paddle_tpu_torch.distributed.sharding_utils import shard_batch
    from paddle_tpu_torch.models.convert import load_jax_state_dict

    mesh = dist.build_mesh(pp=4)
    res = {"engines": {k: _engine_case(mesh, c)
                       for k, c in engine_cases.items()}}
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["pp_degree"] = 4
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    d, vocab, S, V = spec["d"], spec["vocab"], 4, 2
    batch = tuple(torch.from_numpy(b) for b in block_batch)
    for schedule in ("1F1B", "FThenB"):
        pl = PipelineLayer([Block(d) for _ in range(S)], num_stages=S,
                           loss_fn=mse)
        load_jax_state_dict(pl, block_state)
        pp = PipelineParallel(pl, hcg, _strategy(
            fleet, accumulate_steps=spec["M"], schedule=schedule))
        res[("block", schedule)] = _train(
            pp, _adamw(pp.parameters(), spec), [batch])
    descs = [SharedLayerDesc("embed", tnn.Embedding, None, "weight", vocab,
                             d)]
    descs += [LayerDesc(Block, d) for _ in range(S * V)]
    descs += [SharedLayerDesc("embed", tnn.Embedding, head_fwd, "weight",
                              vocab, d)]
    pl = PipelineLayer(descs, num_stages=S, loss_fn=ce,
                       num_virtual_pipeline_stages=V)
    load_jax_state_dict(pl, tied_state)
    res["one_instance"] = pl.shared_post[0] is pl.shared_pre
    pp = PipelineParallel(pl, hcg, _strategy(
        fleet, accumulate_steps=spec["M"], virtual_pp_degree=V))
    res["tied_schedule"] = pp.schedule
    res["tied"] = _train(pp, _adamw(pp.parameters(), spec),
                         [tuple(torch.from_numpy(b) for b in tied_batch)])

    _hybrid(fleet, spec["M"], dp_degree=2, pp_degree=2)
    pl = PipelineLayer([Block(d) for _ in range(S)], num_stages=2,
                       loss_fn=mse)
    load_jax_state_dict(pl, block_state)
    pp = PipelineParallel(pl, fleet.get_hybrid_communicate_group(),
                          _strategy(fleet, accumulate_steps=spec["M"],
                                    schedule="1F1B"))
    res[("dp_pp", "block")] = _train(
        pp, _adamw(pp.parameters(), spec),
        [shard_batch(batch, dist.get_mesh(), ("dp",))])
    res[("dp_pp", "gpt")] = _lm_run(
        "gpt", *lms["gpt"][1:], lm_batch, lm_spec, via_fleet=True,
        whole=False, probe=False)

    _hybrid(fleet, lm_spec["M"], pp_degree=2, mp_degree=2)
    for kind, (family, cfg_kw, state) in lms.items():
        res[("pp_mp", kind)] = _lm_run(
            family, cfg_kw, state, lm_batch, lm_spec,
            via_fleet=kind == "gpt", whole=family == "llama", probe=True)

    _hybrid(fleet, spec["M"], pp_degree=2, sep_degree=2)
    res["beside_sep"] = _errors(lambda: fleet.distributed_model(
        PipelineLayer([LayerDesc(Block, d) for _ in range(2)],
                      num_stages=2, loss_fn=mse)))
    return res
