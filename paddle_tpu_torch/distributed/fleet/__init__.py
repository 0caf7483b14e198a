"""Fleet (counterpart of paddle_tpu/distributed/fleet; reference: Paddle's
fleet.py:167 init, model.py:30 distributed_model, topology.py): the
hybrid topology over the ranks and the data-parallel API, the
tensor-parallel layers (`mp_layers`), and activation recomputation (also
as `fleet.utils.recompute`). A `sep_degree` above 1 makes the sep groups
that GPT's `sequence_parallel` shards its sequence over
(distributed/context_parallel.py); an `mp_degree` above 1 the mp groups
whose ranks each hold a block of the mp layers' weights, alone or beside
dp (dp x mp: the mesh's dp groups are the ranks of one mp position); a
`sharding_degree` above 1 the sharding groups that
distributed.group_sharded_parallel (ZeRO) shards over, alone or beside
dp (`get_hybrid_communicate_group().get_sharding_parallel_group()`).

`init` runs init_parallel_env (a rank that must stay on the CPU calls
`init_parallel_env(device="cpu")` first: it is idempotent) and builds the
HybridCommunicateGroup of the strategy's degrees, which sets the mesh.
`distributed_model` wraps a PipelineLayer in PipelineParallel when
pp_degree > 1 (fleet/pipeline_parallel.py: one rank a stage, the
strategy's pipeline_configs; beside dp_degree or mp_degree > 1 too, and
then it averages its gradients over the dp group itself, so it is never
wrapped in a DataParallel), else a model in DataParallel over the dp
group only when dp_degree > 1 and the world has more than one rank (an
mp rank's gradients are its own blocks', or alike on every mp rank).
`dp_train_step` builds the TrainStep of the data-parallel path.
The role makers, UtilBase and the data generators wait in ROADMAP queue
1 (the rest of `distributed/`).
"""
from __future__ import annotations

from typing import Optional

from ..env import get_rank, get_world_size, init_parallel_env
from ..mesh import CommunicateTopology, HybridCommunicateGroup
from .hybrid_optimizer import (  # noqa: F401
    HybridParallelClipGrad,
    HybridParallelOptimizer,
)
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ColumnSequenceParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    RowSequenceParallelLinear,
    VocabParallelEmbedding,
)
from .pipeline_parallel import (  # noqa: F401
    LayerDesc,
    PipelineLayer,
    PipelineParallel,
    SharedLayerDesc,
)
from .recompute import recompute, recompute_sequential
from . import utils  # noqa: F401

__all__ = ["recompute", "recompute_sequential", "DistributedStrategy",
           "Fleet", "fleet", "init", "get_hybrid_communicate_group",
           "distributed_model", "distributed_optimizer", "dp_train_step",
           "HybridParallelClipGrad", "HybridParallelOptimizer",
           "ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel"]


class DistributedStrategy:
    """The reference's strategy knobs, with its defaults."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.find_unused_parameters = False
        # data-parallel gradient reduction (dp_train_step): bucketed
        # all-reduce of grad_bucket_mb buckets when on, one bucket
        # otherwise; "overlap" is the schedule ('bucketed' or 'fine',
        # None follows FLAGS_dp_overlap)
        self.dp_comm_configs = {
            "bucketed_allreduce": False,
            "grad_bucket_mb": 4,
            "overlap": None,
        }


class _Fleet:
    def __init__(self):
        self._hcg: Optional[HybridCommunicateGroup] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_init = False

    def init(self, role_maker=None, is_collective=True, strategy=None):
        init_parallel_env()
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        topo = CommunicateTopology(
            ("data", "pipe", "sharding", "sep", "model"),
            (hc.get("dp_degree", 1), hc.get("pp_degree", 1),
             hc.get("sharding_degree", 1), hc.get("sep_degree", 1),
             hc.get("mp_degree", 1)),
        )
        self._hcg = HybridCommunicateGroup(topo)
        self._is_init = True
        return self

    def get_hybrid_communicate_group(self) -> HybridCommunicateGroup:
        if self._hcg is None:
            raise RuntimeError("call fleet.init first")
        return self._hcg

    @property
    def worker_num(self):
        return get_world_size()

    @property
    def worker_index(self):
        return get_rank()

    def distributed_model(self, model):
        """PipelineParallel over the pp group when pp_degree > 1 (which
        reduces over the dp group itself, beside dp); DataParallel over
        the dp group when dp_degree > 1 and the world has more than one
        rank; else the model itself."""
        from ..parallel import DataParallel

        hc = self._strategy.hybrid_configs if self._strategy else {}
        if hc.get("pp_degree", 1) > 1:
            return PipelineParallel(model, self._hcg, self._strategy)
        if hc.get("dp_degree", 1) > 1 and get_world_size() > 1:
            return DataParallel(
                model, group=self._hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        return HybridParallelOptimizer(optimizer, self._hcg, self._strategy)


Fleet = _Fleet  # the reference exports the class beside the singleton
fleet = _Fleet()


def init(role_maker=None, is_collective=True, strategy=None):
    return fleet.init(role_maker, is_collective, strategy)


def get_hybrid_communicate_group():
    return fleet.get_hybrid_communicate_group()


def distributed_model(model):
    return fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)


def dp_train_step(model, loss_fn, optimizer, strategy=None, mesh=None,
                  dp_axis="dp", **kwargs):
    """A TrainStep on the data-parallel path. With
    `strategy.dp_comm_configs['bucketed_allreduce']` on (or no strategy),
    gradients are reduced in grad_bucket_mb buckets issued from the
    backward's hooks; off, in one bucket after the whole backward.
    `dp_comm_configs['overlap']` picks the schedule ('bucketed' or
    'fine'; None follows FLAGS_dp_overlap)."""
    from ...jit.trainer import TrainStep

    cfg = (strategy.dp_comm_configs if strategy is not None
           else DistributedStrategy().dp_comm_configs)
    bucket_mb = (cfg.get("grad_bucket_mb", 4)
                 if cfg.get("bucketed_allreduce", True) else -1)
    kwargs.setdefault("dp_overlap", cfg.get("overlap"))
    return TrainStep(model, loss_fn, optimizer, mesh=mesh, dp_axis=dp_axis,
                     grad_bucket_mb=bucket_mb, **kwargs)
