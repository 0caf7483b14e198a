"""Rank bodies for tests/test_torch_hybrid_parallel.py: pipeline parallelism
beside data and tensor parallelism, dp 2 x pp 2 x mp 2 over eight gloo
rank processes. Each runs in a process of its own, started by
paddle_tpu_torch.distributed.spawn(backend="cpu"), and returns numpy
results for the test process to hold against the JAX reference. This
module imports torch and the port only (no JAX)."""
import numpy as np
import torch


def _np(tree):
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in tree.items()}


def one_rank_inf(inf_rank):
    """A GradScaler whose found-inf flag global rank `inf_rank` alone
    raises, as an overflow in that rank's gradients alone would."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.amp import GradScaler

    class Scaler(GradScaler):
        def unscale_(self, optimizer):
            super().unscale_(optimizer)
            if dist.get_rank() == inf_rank:
                self._found_inf_t = torch.ones_like(self._found_inf_t)

    return Scaler(init_loss_scaling=1024.0)


def _model(family, cfg_kw, state):
    """The port's GPT or Llama on the CPU, built under the current mesh
    (its mp blocks), holding the reference's weights."""
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         LlamaConfig, LlamaForCausalLM)
    from paddle_tpu_torch.models.convert import load_jax_state_dict

    if family == "llama":
        model = LlamaForCausalLM(LlamaConfig(**cfg_kw), device="cpu")
    else:
        model = GPTForCausalLM(GPTConfig(**cfg_kw), device="cpu")
    load_jax_state_dict(model, state)
    return model


def world8(lms, batches, spec, inf_rank):
    """fleet.init(hybrid_configs dp 2, pp 2, mp 2); for each LM, its
    pipeline_descs into a PipelineLayer of two stages (built under the
    mesh: cut over mp), copy_weights, fleet.distributed_model and the
    hybrid optimizer, then a train_batch a global batch (this rank's
    rows). Then one step under a GradScaler whose found-inf flag only
    `inf_rank` raises: every rank must skip it."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import PipelineLayer
    from paddle_tpu_torch.distributed.sharding_utils import shard_batch
    from paddle_tpu_torch.models.convert import gather_state_dict
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    torch.set_num_threads(1)
    dist.init_parallel_env(device="cpu")
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dp_degree=2, pp_degree=2, mp_degree=2)
    strategy.pipeline_configs["accumulate_steps"] = spec["M"]
    fleet.init(is_collective=True, strategy=strategy)
    mesh = dist.get_mesh()
    hcg = fleet.get_hybrid_communicate_group()
    res = {"coord": mesh.coordinate(dist.get_rank()),
           "groups": {
               "dp": hcg.get_data_parallel_group().ranks,
               "pp": hcg.get_pipe_parallel_group().ranks,
               "mp": hcg.get_model_parallel_group().ranks},
           "ranks": [hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                     hcg.get_model_parallel_rank()]}
    for name, (family, cfg_kw, state) in lms.items():
        model = _model(family, cfg_kw, state)
        descs, loss_fn, copy_weights = model.pipeline_descs()
        pl = PipelineLayer(descs, num_stages=2, loss_fn=loss_fn)
        copy_weights(pl)
        pp = fleet.distributed_model(pl)
        opt = fleet.distributed_optimizer(AdamW(
            spec["lr"], epsilon=spec["eps"], parameters=pp.parameters(),
            weight_decay=0.01, grad_clip=ClipGradByGlobalNorm(spec["clip"])))
        losses, locals_ = [], []
        for b in batches:
            mine = shard_batch(torch.from_numpy(b), mesh, ("dp",))
            losses.append(float(pp.train_batch((mine, mine), opt)))
            locals_.append(_np(dict(pp.state_dict())))
        out = {"losses": losses, "local": locals_,
               "state": gather_state_dict(pl),
               "wrapper": type(pp).__name__,
               "clip": type(opt._grad_clip).__name__,
               "parts": sorted(pp.last_parts),
               "cut": sorted(n for n, p in pl.named_parameters()
                             if getattr(p, "_mp_shard", None) is not None)}
        scaler = one_rank_inf(inf_rank)
        before = _np(dict(pp.state_dict()))
        mine = shard_batch(torch.from_numpy(batches[0]), mesh, ("dp",))
        pp.train_batch((mine, mine), opt, scaler=scaler)
        after = _np(dict(pp.state_dict()))
        out["skip"] = {
            "unchanged": all(np.array_equal(before[k], after[k])
                             for k in before),
            "scale": scaler.get_loss_scaling()}
        res[name] = out
    return res
