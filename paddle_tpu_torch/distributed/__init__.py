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
    issued from the backward's hooks (`grad_buckets`, `overlap`).

Also here: the single-device `fleet.recompute`; in `env`, the process
environment, the process-group store (in-process, or native.TCPStore
across processes) and the serving fleet's replica registry; elastic
membership and the store-based gradient exchange (`elastic`); the
rank-sharded checkpoint (`checkpoint`); `spawn`; and `DataParallel`.
Sharding, pipeline and tensor parallelism wait for later slices. The
package imports torch, never jax or paddle_tpu.
"""
from . import checkpoint  # noqa: F401
from .checkpoint import load_sharded, split_bounds  # noqa: F401
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
    all_gather_concat,
    all_reduce,
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
    scatter,
    send,
)
from .mesh import (  # noqa: F401
    CommunicateTopology,
    HybridCommunicateGroup,
    ProcessMesh,
    auto_mesh,
    build_mesh,
    get_mesh,
    set_mesh,
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
