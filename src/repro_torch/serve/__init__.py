"""Serving of the port: the one-shot engine, the paged KV cache, the
continuous-batching scheduler and the broadcast weight fan-out to
replicas (ported from ``repro/serve``)."""
from .engine import ServeEngine, eos_done_mask  # noqa: F401
from .kv_cache import (BlockAllocator, OutOfBlocks,  # noqa: F401
                       PagedKVCache, blocks_per_request, scratch_table)
from .replica import ReplicaSet  # noqa: F401
from .scheduler import Request, Scheduler  # noqa: F401
