"""Batch mesh generation, with an optional host/device pipeline
(counterpart of surfd_tpu/pipelines/batch.py).

One extraction alternates device phases (grid fill, gradients, face-filter
masks: K1 and autograd on the card) with host phases (marching, edge prep,
cleanup: the native C++ passes). Neither side works during the other's
phases, so a pipeline `depth` deep runs that many extractions at once, each
in a worker thread: the native passes release the interpreter lock through
ctypes, and so do CUDA launches and copies.

Torch keeps some state per thread. Each worker takes the caller's current
CUDA device and stream; grad mode is per thread too, and every extraction
turns it off itself. Meshes come out in input order and do not depend on
the depth.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import torch

from .generate import (
    MeshExtractionConfig,
    get_mesh_from_udf,
    get_watertight_mesh_from_udf,
    make_udf_fn,
)


def _on_callers_stream(fn: Callable) -> Callable:
    """fn, run in another thread on this thread's current CUDA device and
    stream (a new thread starts on device 0 and its default stream)."""
    if not torch.cuda.is_available():
        return fn
    device = torch.cuda.current_device()
    stream = torch.cuda.current_stream(device)

    def run(*args):
        with torch.cuda.device(device), torch.cuda.stream(stream):
            return fn(*args)

    return run


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
    work = _on_callers_stream(lambda fn: extract(fn, cfg=cfg, return_stats=return_stats))
    depth = max(1, depth)
    with ThreadPoolExecutor(max_workers=depth) as pool:
        it = iter(udf_fns)
        pending = [pool.submit(work, fn) for fn in itertools.islice(it, depth)]
        while pending:
            fut = pending.pop(0)
            pending.extend(pool.submit(work, fn) for fn in itertools.islice(it, 1))
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
