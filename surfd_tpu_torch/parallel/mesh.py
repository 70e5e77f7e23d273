"""Device mesh and sharding helpers (counterpart of surfd_tpu/parallel/mesh.py).

The JAX package shards one program over a named ('data', 'model') mesh of
local devices. Here the mesh is a `torch.distributed` `DeviceMesh` over the
ranks of the process group, one process a card, with the same axis names:

  data   — the batch (DDP: gradients are averaged over it) and, at
           inference, the grid-query stream (`geometry.grid`), whose
           chunks are split over its ranks and gathered back;
  model  — reserved; 1 on every path.

The process group must exist first (`parallel.initialize`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.utils._pytree import tree_map

AXES = ("data", "model")


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A ('data', 'model') DeviceMesh over `devices` (global ranks; all of
    the group's by default). The device type follows the group's backend
    (NCCL: cuda, gloo: cpu). Raises when data·model ≠ the number of ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call parallel.initialize first")
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n = len(ranks)
    if data is None:
        data = n // model
    if data * model != n or n != dist.get_world_size():
        raise ValueError(f"mesh {data}x{model} != {dist.get_world_size()} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(data, model), mesh_dim_names=AXES)


def data_axis(mesh: DeviceMesh) -> tuple:
    """(process group, this rank's index, size) of the mesh's 'data' axis."""
    return mesh.get_group("data"), mesh.get_local_rank("data"), mesh.size(0)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh: its current CUDA card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """Every 'data' rank's `t` (rows of any count, the same trailing shape
    and dtype on all), concatenated along dim 0 in rank order, on every
    rank: two `all_gather_into_tensor`s, the row counts and then the rows
    padded to the longest."""
    group, _, n = data_axis(mesh)
    lens = torch.empty(n, dtype=torch.int64, device=t.device)
    dist.all_gather_into_tensor(lens, torch.tensor([len(t)], device=t.device), group=group)
    lens = lens.tolist()
    m = max(lens)
    src = t.view(torch.uint8) if t.dtype == torch.bool else t
    if len(src) < m:
        src = torch.cat([src, src.new_zeros((m - len(src),) + tuple(src.shape[1:]))])
    buf = src.new_empty((n * m,) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(buf, src.contiguous(), group=group)
    out = torch.cat([buf[i * m:i * m + k] for i, k in enumerate(lens)])
    return out.view(torch.bool) if t.dtype == torch.bool else out


def fork_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The same mesh with new process groups on its 'data' axis.

    Collectives of one group must reach every rank in the same order; two
    threads that issue collectives at once (the pipelined batch generator)
    each take a fork of their own. Every rank of the group calls this, in
    the same order."""
    ranks = mesh.mesh
    me, mine = dist.get_rank(), None
    for j in range(ranks.shape[1]):
        col = ranks[:, j].tolist()
        g = dist.new_group(col)
        if me in col:
            mine = g
    return DeviceMesh.from_group([mine, mesh.get_group("model")], mesh.device_type, mesh=ranks,
                                 mesh_dim_names=AXES)


def data_sharding(mesh: DeviceMesh) -> tuple:
    """Batch-dim sharding over 'data', replicated over 'model' (DTensor
    placements)."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(), Replicate())


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's equal slice, along dim 0, of every leaf of a global batch
    (arrays stay arrays, tensors stay tensors). Raises when a leaf does not
    split evenly over 'data'."""
    _, r, n = data_axis(mesh)

    def one(x):
        if len(x) % n:
            raise ValueError(f"batch of {len(x)} does not split over {n} data ranks")
        b = len(x) // n
        return x[r * b:(r + 1) * b]

    return tree_map(one, tree)


def replicate(mesh: DeviceMesh, tree):
    """Rank 0's values of a tree of tensors or arrays on every rank of the
    mesh (the reference's `sync_params`). Tensors are overwritten in place
    and must lie on the mesh's device type; arrays come back as new arrays."""
    src = int(mesh.mesh.reshape(-1)[0])

    def one(x):
        if torch.is_tensor(x):
            dist.broadcast(x, src=src)
            return x
        t = torch.from_numpy(np.array(x)).to(mesh_device(mesh))
        dist.broadcast(t, src=src)
        return t.cpu().numpy()

    return tree_map(one, tree)
