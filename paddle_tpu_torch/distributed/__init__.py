"""Distributed training (counterpart of paddle_tpu/distributed): the
single-device `fleet.recompute`; in `env`, the process environment, the
process-group store (in-process, or native.TCPStore across processes) and
the serving fleet's replica registry; elastic membership and the
store-based gradient exchange (`elastic`); the rank-sharded checkpoint
(`checkpoint`); and `spawn`. The mesh, collectives and device-sharded
state wait for later slices."""
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
    is_initialized,
)
from . import checkpoint as io  # noqa: F401,E402  (distributed.io)
