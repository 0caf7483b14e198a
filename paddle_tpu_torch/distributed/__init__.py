"""Distributed training (counterpart of paddle_tpu/distributed).

Design stance: multi-controller, not single-controller. The reference is
one program over a named jax mesh: its collectives are XLA ops inside a
shard_map over a mesh axis (`collective._bound_axis`), and outside a mesh
they are the identity. The port runs one process a rank over
torch.distributed process groups (`init_parallel_env` joins them):

  * a reference mesh axis maps to the process group of that axis's ranks
    (`build_mesh` lays the ranks out over the axes and makes each line's
    group; `new_group(axis_name=)` hands out this rank's);
  * at world 1, with no process group initialised, every collective stays
    the identity, as in the reference;
  * `TrainStep(dp_axis=...)` and `fleet.dp_train_step` take the global
    batch, keep this rank's rows and all-reduce the gradients in buckets
    issued from the backward's hooks (`grad_buckets`, `overlap`);
  * context parallelism (`context_parallel`): ring and Ulysses attention
    over a `sep` group, each rank on its shard of the sequence, and
    GPT's `sequence_parallel`;
  * tensor parallelism (`fleet.mp_layers`, `split`): each rank of an
    `mp` group holds its block of the sharded weights (`annotate_param`,
    `shard_model_parameters`) and issues Megatron's collectives;
  * ZeRO (`sharding.group_sharded_parallel`, stages "os", "os_g" and
    "p_g_os"): the ranks of a `sharding` group split the batch, and each
    keeps and updates its shard of the optimizer state, the gradients
    and, at stage 3, the parameters (gathered where they are used);
  * pipeline parallelism (`pipeline`: the 1F1B, F-then-B and interleaved
    engines; `fleet.PipelineLayer`, `fleet.PipelineParallel`): one
    process a stage hands microbatches on over its `pp` group, alone or
    beside dp and mp (each stage's blocks cut over its mp group, its
    gradients averaged over its dp group).

Also here: the single-device `fleet.recompute`; in `env`, the process
environment, the process-group store (in-process, or native.TCPStore
across processes) and the serving fleet's replica registry; elastic
membership and the store-based gradient exchange (`elastic`); the
rank-sharded checkpoint (`checkpoint`: also `save_sharded`,
`save_model_sharded` and their loads, in the same layout); `spawn`; and
`DataParallel`. The package imports torch, never jax or paddle_tpu.
"""
from . import checkpoint  # noqa: F401
from .checkpoint import (  # noqa: F401
    load_model_sharded,
    load_sharded,
    save_model_sharded,
    save_sharded,
    split_bounds,
)
from .elastic import (  # noqa: F401
    ElasticMembership,
    MembershipView,
    PeerLostError,
    StoreReducer,
)
from .spawn import spawn  # noqa: F401
from .env import (  # noqa: F401
    ParallelEnv,
    ReplicaRegistry,
    get_rank,
    get_world_size,
    init_parallel_env,
    is_initialized,
    reform_parallel_env,
)
from .collective import (  # noqa: F401
    Group,
    ReduceOp,
    P2POp,
    all_gather,
    all_gather_autograd,
    all_gather_concat,
    all_reduce,
    all_reduce_autograd,
    all_to_all,
    alltoall,
    alltoall_single,
    axis_context,
    barrier,
    batch_isend_irecv,
    broadcast,
    collective_permute,
    gather,
    get_group,
    irecv,
    isend,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    reduce_scatter_autograd,
    scatter,
    send,
    split,
)
from .mesh import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
    PartitionSpec,
    ProcessMesh,
    annotate_param,
    auto_mesh,
    build_mesh,
    get_mesh,
    set_mesh,
)
from .sharding_utils import shard_batch, shard_model_parameters  # noqa: F401
from .sharding import (  # noqa: F401
    group_sharded_parallel,
    save_group_sharded_model,
)
from .context_parallel import (  # noqa: F401
    RingAttention,
    all_gather_seq,
    gather_seq,
    reduce_scatter_seq,
    ring_attention,
    scatter_seq,
    ulysses_attention,
)
from .parallel import DataParallel  # noqa: F401
from .overlap import (  # noqa: F401
    choose_schedule,
    last_schedule,
    reduce_flush,
    ring_all_reduce,
)
from . import fleet  # noqa: F401
from . import checkpoint as io  # noqa: F401,E402  (distributed.io)
