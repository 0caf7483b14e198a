"""Serving (counterpart of paddle_tpu/serving): continuous batching over a
paged KV pool with prefix caching, self-speculative decoding, every tick
kind as a CUDA graph, the KV-block wire, request traces and SLO metrics,
the HTTP front end, and the fleet (a router over replica threads:
prefix-affinity routing, leases and breakers, re-dispatch, hedges, drains
with live KV migration, disaggregated prefill and decode, autoscaling,
FleetServer). Replicas in processes of their own (the reference's
fleet_proc.py) wait for the distributed slice."""
from .blocks import BlockAllocator  # noqa: F401
from .observability import (  # noqa: F401
    RequestTrace,
    ServingObservability,
    export_request_trace,
)
from .paged import PagedKVPool, PagedLayerCache, write_prefix  # noqa: F401
from .scheduler import Request, Scheduler  # noqa: F401
from .speculative import NgramDrafter, SpecState  # noqa: F401
from .engine import (  # noqa: F401
    EngineDrainingError,
    QueueFullError,
    ServingEngine,
)
from .fleet import (  # noqa: F401
    CircuitBreaker,
    FleetAutoscaler,
    FleetRequest,
    FleetRouter,
    Replica,
    build_fleet,
    parse_fleet_roles,
)
from .fleet_observability import (  # noqa: F401
    FleetObservability,
    export_fleet_trace,
)
from .server import (  # noqa: F401
    FleetServer,
    ServingServer,
    kv_wire_decode,
    kv_wire_encode,
)

__all__ = [
    "BlockAllocator",
    "CircuitBreaker",
    "EngineDrainingError",
    "FleetAutoscaler",
    "FleetObservability",
    "FleetRequest",
    "FleetRouter",
    "FleetServer",
    "NgramDrafter",
    "PagedKVPool",
    "PagedLayerCache",
    "QueueFullError",
    "Replica",
    "Request",
    "RequestTrace",
    "Scheduler",
    "ServingEngine",
    "ServingObservability",
    "ServingServer",
    "SpecState",
    "build_fleet",
    "export_fleet_trace",
    "export_request_trace",
    "kv_wire_decode",
    "kv_wire_encode",
    "parse_fleet_roles",
    "write_prefix",
]
