"""Serving (counterpart of paddle_tpu/serving): continuous batching over a
paged KV pool with prefix caching and self-speculative decoding."""
from .blocks import BlockAllocator
from .engine import EngineDrainingError, QueueFullError, ServingEngine
from .paged import PagedKVPool, PagedLayerCache, write_prefix
from .scheduler import Request, Scheduler
from .speculative import NgramDrafter, SpecState
