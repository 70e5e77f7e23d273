"""Batch mesh generation, with an optional host/device pipeline
(counterpart of surfd_tpu/pipelines/batch.py).

One extraction alternates device phases (grid fill, gradients, face-filter
masks: K1 and autograd on the card) with host phases (marching, edge prep,
cleanup: the native C++ passes). Neither side works during the other's
phases, so a pipeline `depth` deep runs that many extractions at once, each
in a worker thread: the native passes release the interpreter lock through
ctypes, and so do CUDA launches and copies.

Torch keeps some state per thread. Each worker takes the caller's current
CUDA device and stream, and the caller's open span (so that an `extract`
span sits in the caller's call tree); grad mode is per thread too, and
every extraction turns it off itself. Meshes come out in input order and
do not depend on the depth.

Over data ranks (a DeviceMesh in `cfg.mesh`) every extraction issues
collectives, and a process group's collectives must reach every rank in the
same order: two threads sharing one group could interleave differently on
two ranks and deadlock or mix up results. So the k-th extraction of a
pipeline runs on slot k mod depth, each slot with its own fork of the
DeviceMesh (new process groups, made once per DeviceMesh and slot, on every
rank in the same order), and extraction k + depth starts only after
extraction k has finished.
"""

from __future__ import annotations

import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import torch

from ..utils import profiling
from .generate import (
    MeshExtractionConfig,
    get_mesh_from_udf,
    get_watertight_mesh_from_udf,
    make_udf_fn,
)


def _on_callers_stream(fn: Callable) -> Callable:
    """fn, run in another thread on this thread's current CUDA device and
    stream (a new thread starts on device 0 and its default stream), with
    this thread's open span (`utils.profiling.current`) as the parent of
    the spans it opens."""
    parent = profiling.current()
    cuda = torch.cuda.is_available()
    if cuda:
        device = torch.cuda.current_device()
        stream = torch.cuda.current_stream(device)

    def run(*args):
        with profiling.adopt(parent):
            if not cuda:
                return fn(*args)
            with torch.cuda.device(device), torch.cuda.stream(stream):
                return fn(*args)

    return run


_FORKS: dict = {}  # id(ranks) → (ranks, [its forks, one a pipeline slot])


def _slot_configs(cfg: MeshExtractionConfig, depth: int) -> list:
    """One config a pipeline slot: `cfg` itself without data ranks or at
    depth 1, else `cfg` on the slot's own fork of its DeviceMesh."""
    ranks = cfg.mesh
    if ranks is None or depth == 1:
        return [cfg] * depth
    from ..parallel.mesh import fork_mesh

    _, forks = _FORKS.setdefault(id(ranks), (ranks, []))
    while len(forks) < depth:
        forks.append(fork_mesh(ranks))
    return [dataclasses.replace(cfg, mesh=fork) for fork in forks[:depth]]


def generate_meshes_pipelined(
    udf_fns: Iterable,
    cfg: MeshExtractionConfig = MeshExtractionConfig(),
    watertight: bool = False,
    depth: int = 1,
    return_stats: bool = False,
) -> Iterator:
    """Yield one mesh per evaluator, in order, extracting `depth` at a time.

    udf_fns: an iterable of `UdfEvaluator`s (`make_udf_fn`), drawn in the
    caller's thread as slots free up. Yields Mesh, or (Mesh, stats) with
    `return_stats`.
    """
    extract = get_watertight_mesh_from_udf if watertight else get_mesh_from_udf
    depth = max(1, depth)
    cfgs = _slot_configs(cfg, depth)
    work = _on_callers_stream(lambda fn, c: extract(fn, cfg=c, return_stats=return_stats))
    with ThreadPoolExecutor(max_workers=depth) as pool:
        it = enumerate(udf_fns)
        pending = [pool.submit(work, fn, cfgs[k % depth]) for k, fn in itertools.islice(it, depth)]
        while pending:
            fut = pending.pop(0)
            if cfg.mesh is not None:  # the slot's next extraction waits for this one
                fut.result()
            pending.extend(pool.submit(work, fn, cfgs[k % depth])
                           for k, fn in itertools.islice(it, 1))
            yield fut.result()


def generate_meshes(
    decoder,
    latents,
    cfg: MeshExtractionConfig = MeshExtractionConfig(),
    watertight: bool = False,
    pipelined: bool = False,
    max_dist: float = 0.1,
    on_mesh: Optional[Callable] = None,
    device=None,
) -> list:
    """(B, L) latents → one mesh each, through the decoder (a CbnDecoder,
    moved to `device`, CUDA by default). `pipelined` runs two extractions
    at a time; `on_mesh(k, mesh)` sees each mesh as it comes."""
    fns = (make_udf_fn(decoder, None, lat, max_dist, device=device, chunk=cfg.max_batch)
           for lat in latents)
    out = []
    gen = generate_meshes_pipelined(fns, cfg, watertight=watertight, depth=2 if pipelined else 1)
    for k, mesh in enumerate(gen):
        if on_mesh is not None:
            on_mesh(k, mesh)
        out.append(mesh)
    return out
