"""Data parallelism over torch.distributed (counterpart of surfd_tpu/parallel)."""

from .mesh import data_sharding, make_mesh, replicate, replicated, shard_batch
from .multihost import (
    all_gather_host,
    broadcast_from_main,
    global_batch_from_local,
    initialize,
    is_main_process,
    process_count,
    process_index,
)

__all__ = ["all_gather_host", "broadcast_from_main", "data_sharding", "global_batch_from_local",
           "initialize", "is_main_process", "make_mesh", "process_count", "process_index",
           "replicate", "replicated", "shard_batch"]
