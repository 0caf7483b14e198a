"""Serving (counterpart of paddle_tpu/serving, without the fleet):
continuous batching over a paged KV pool with prefix caching,
self-speculative decoding, fused greedy decode as CUDA graphs, the KV-block
wire, request traces and SLO metrics, and the HTTP front end."""
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
from .server import ServingServer, kv_wire_decode, kv_wire_encode  # noqa

__all__ = [
    "BlockAllocator",
    "EngineDrainingError",
    "NgramDrafter",
    "PagedKVPool",
    "PagedLayerCache",
    "QueueFullError",
    "Request",
    "RequestTrace",
    "Scheduler",
    "ServingEngine",
    "ServingObservability",
    "ServingServer",
    "SpecState",
    "export_request_trace",
    "kv_wire_decode",
    "kv_wire_encode",
    "write_prefix",
]
