"""Process-group utilities (counterpart of surfd_tpu/parallel/multihost.py).

The JAX package runs one controller over every device and joins hosts with
`jax.distributed.initialize`. PyTorch's idiom is one process per GPU
(`torchrun`) in a `torch.distributed` process group; these helpers keep the
JAX names with that meaning. Without a process group every helper answers
as a single process does.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from ..utils.device import resolve_device

DEFAULT_TIMEOUT_S = 600.0


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a process group; a no-op for a single process or when one exists.
    Returns whether this call joined one (its caller then leaves it with
    `shutdown`).

    With `coordinator_address` ("host:port", or an init URL such as
    "tcp://..." or "file://...") the explicit `num_processes` and
    `process_id` are used; else torchrun's environment (`WORLD_SIZE`,
    `RANK`, `MASTER_ADDR`, `MASTER_PORT`) when `WORLD_SIZE` > 1; else
    nothing happens, as JAX's does on one host. The backend is NCCL on CUDA
    (the default device; each process takes `cuda:LOCAL_RANK`, else
    `cuda:process_id`) and gloo only when `device` names the CPU. A failed
    NCCL start raises. A rank that does not arrive within `timeout_s` makes
    the others raise instead of hang.
    """
    if dist.is_initialized():
        return False
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not coordinator_address and env_world <= 1:
        return False
    dev = resolve_device(device)
    if coordinator_address:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kw = {"init_method": url, "world_size": int(num_processes or 1),
              "rank": int(process_id or 0)}
        local = int(os.environ.get("LOCAL_RANK", kw["rank"]))
    else:
        kw = {"init_method": "env://"}
        local = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank-0 check (the reference's `comm.is_main_process`)."""
    return process_index() == 0


def global_batch_from_local(mesh, local_batch):
    """Each rank's slice of a batch → one global DTensor a leaf, sharded over
    'data' (`Shard(0)`) and replicated over 'model'. Arrays become tensors on
    the mesh's device type. Replaces the reference's DistributedSampler
    input scatter: each rank loads only its slice."""
    from torch.distributed.tensor import DTensor

    from .mesh import data_sharding, mesh_device

    def one(x):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
        return DTensor.from_local(t.to(mesh_device(mesh)), mesh, data_sharding(mesh),
                                  run_check=False)

    return tree_map(one, local_batch)


def broadcast_from_main(tree):
    """Rank 0's value of a picklable tree on every rank (the reference's
    `dist_util.sync_params` for host values)."""
    if process_count() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_gather_host(values):
    """Every rank's value of a small host value, in rank order (the
    reference's pickled `comm.all_gather`): arrays and scalars stacked along
    a new leading axis, other objects as a list."""
    out = [values]
    if process_count() > 1:
        out = [None] * process_count()
        dist.all_gather_object(out, values)
    if all(isinstance(v, (np.ndarray, np.generic, int, float)) for v in out):
        return np.stack([np.asarray(v) for v in out])
    return out
