"""Block-sparse coarse-to-fine UDF grid fill (counterpart of
surfd_tpu/geometry/grid.py).

The N³ vertex grid is cut into B³ blocks:
  1. coarse: the decoder at every block centre; a block is active when its
     centre UDF could hide surface inside it (< half diagonal + near band);
  2. sub-block: active blocks refined by the same test at B/4 granularity;
  3. fine: every vertex of the remaining blocks, as u16-quantised UDF
     where the evaluator offers it (`u16`), else as float32.
Each level's test is sound by the triangle inequality (`auto_block_size`).
Inactive regions keep max_dist. Vertex and sub-centre coordinates are
generated on the device from the active-block ids; the work goes out in
fixed-size slices through a `QueryStream`, the one owner of the queries'
device, slice size and data ranks. The u16 fine values come back to
the host and the native scatter writes them into the grid, subtracting the
surface-bias calibration on the way (float32 values: a numpy scatter).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .. import native
from ..utils.device import resolve_device

UdfFn = Callable[[torch.Tensor], torch.Tensor]  # (P, 3) f32 → (P,) f32, on device
GradFn = Callable[[torch.Tensor], torch.Tensor]  # (P, 3) f32 → (P, 3) f32, on device


def auto_block_size(resolution: int, spacing: float, max_dist: float, band_mult: float = 2.5) -> int:
    """Largest power-of-2 block whose centre test is sound: half diagonal +
    band must stay below 0.95·max_dist (clipped UDFs carry no distance)."""
    band = band_mult * spacing
    block = 1
    b = 2
    while resolution % b == 0 and b <= resolution:
        half_diag = 0.5 * math.sqrt(3.0) * b * spacing
        if half_diag + band <= 0.95 * max_dist:
            block = b
        else:
            break
        b *= 2
    return block


def estimate_surface_bias_field(ab, block_min, nb: int, spacing: float, radius: int = 2):
    """Per-block surface-bias floor field from the fine-pass block minima.

    The local floor is the min of block minima over a (2·radius+1)³
    neighbourhood, capped at min(3 voxels, 3×p5), with no correction at all
    when the global p5 is under 0.1 voxel. Returns (bias per active block,
    (nb,nb,nb) field) or None.
    """
    if block_min is None or len(block_min) < 16:
        return None
    p5 = float(np.percentile(block_min, 5.0))
    if p5 < 0.1 * spacing:
        return None
    cap = min(3.0 * spacing, 3.0 * p5)
    dense = np.full((nb, nb, nb), np.inf, dtype=np.float32)
    dense[ab[:, 0], ab[:, 1], ab[:, 2]] = block_min
    r = radius
    for axis in range(3):
        p = np.pad(dense, [(r, r) if a == axis else (0, 0) for a in range(3)],
                   constant_values=np.inf)
        sl = [slice(None)] * 3
        acc = None
        for off in range(2 * r + 1):
            sl[axis] = slice(off, off + nb)
            v = p[tuple(sl)]
            acc = v if acc is None else np.minimum(acc, v)
        dense = acc
    field = np.where(np.isfinite(dense), np.clip(dense, 0.0, cap), 0.0).astype(np.float32)
    return field[ab[:, 0], ab[:, 1], ab[:, 2]], field


def estimate_surface_bias(block_min, spacing: float) -> float:
    """Global surface-bias floor: p5 of the block minima, 0 under 0.1 voxel,
    capped at 3 voxels."""
    if block_min is None or len(block_min) < 16:
        return 0.0
    b = float(np.percentile(block_min, 5.0))
    if b < 0.1 * spacing:
        return 0.0
    return min(b, 3.0 * spacing)


def to_device(a, dev) -> torch.Tensor:
    """A host array on `dev`. On CUDA it is staged into pinned memory and
    uploaded with non_blocking: a copy from pageable memory would wait for
    every kernel queued on the stream before it. The caching host allocator
    keeps the staging buffer until the copy is done."""
    host = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(dev).type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)


class QueryStream:
    """How point queries run: on which device, in slices of how many rows,
    over which data ranks. Every query of an extraction goes through one.

    device: where host points go (None: CUDA, which raises without a card:
    never a silent CPU run). chunk: rows a slice. The JAX package pads its
    slices to a power-of-two count, which bounds its compiled executables;
    eager PyTorch compiles nothing, so the last slice here is simply
    shorter. ranks: an optional DeviceMesh with a 'data' axis
    (`parallel.make_mesh`): the slice count is padded to a multiple of the
    rank count, as the JAX package pads its slabs, each rank evaluates its
    contiguous share on its own device, and the results are gathered back
    to every rank in order (`parallel.mesh.all_gather_rows`, which reads the
    row counts on the host, so a sharded call blocks there). The slices are
    the unsharded ones, so the result is the unsharded result exactly.
    Every data rank must make every call, with the same points.
    """

    def __init__(self, device=None, chunk: int = 2**19, ranks=None):
        self.device = resolve_device(device)
        self.chunk = chunk
        self.ranks = ranks

    def sliced(self, chunk: int) -> QueryStream:
        """The same device and ranks, in slices of `chunk` rows."""
        return QueryStream(self.device, chunk, self.ranks)

    def run(self, fn, x: torch.Tensor) -> torch.Tensor:
        """fn over the slices of x's first axis, concatenated; x is used
        where it lies."""
        if len(x) == 0:
            return fn(x)
        starts = range(0, len(x), self.chunk)
        if self.ranks is None:
            return torch.cat([fn(x[i:i + self.chunk]) for i in starts])
        from ..parallel.mesh import all_gather_rows, data_axis

        _, rank, n = data_axis(self.ranks)
        per = -(-len(starts) // n)
        mine = starts[rank * per:(rank + 1) * per]
        out = torch.cat([fn(x[i:i + self.chunk]) for i in mine]) if len(mine) else fn(x[:0])
        return all_gather_rows(self.ranks, out)

    def start(self, fn, pts):
        """Start fn over (P, ...) points; return a finalize() that blocks
        until the result is on the host, as numpy.

        pts: a tensor, used where it lies, or a host array, uploaded to the
        device (`to_device`). On CUDA the upload, the slices' kernels and
        the download into a pinned host buffer are queued on the current
        stream with an event behind them, and only finalize() waits, on
        that event: so host work between the two overlaps the device's.
        Each call owns its buffers and its event, so that calls from several
        threads on one stream stay apart. On the CPU the result is computed
        at once."""
        if not torch.is_tensor(pts):
            pts = to_device(pts, self.device)
        out = self.run(fn, pts).detach()
        if out.device.type != "cuda":
            res = out.numpy()
            return lambda: res
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def finalize() -> np.ndarray:
            done.synchronize()
            return host.numpy()

        return finalize

    def fetch(self, fn, pts) -> np.ndarray:
        """fn over (P, ...) points as numpy: `start` waited on at once."""
        return self.start(fn, pts)()


GRAD_CHUNK = 2**16  # points per backward pass: it keeps every activation


def make_grad_fn(udf_fn, chunk: int = GRAD_CHUNK) -> GradFn:
    """∂udf/∂xyz by one VJP with a ones cotangent per chunk of `chunk`
    points: points are evaluated independently, so ∂(Σᵢ udfᵢ)/∂pⱼ =
    ∂udfⱼ/∂pⱼ. An evaluator whose values come from a kernel without a
    backward (K1) offers `autograd_udf`, the same field through
    differentiable ops, and that is what is differentiated."""
    f = getattr(udf_fn, "autograd_udf", udf_fn)

    def one(pts):
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            u = f(p)
            (g,) = torch.autograd.grad(u, p, grad_outputs=torch.ones_like(u))
        return g

    def grad_fn(pts: torch.Tensor) -> torch.Tensor:
        return QueryStream(pts.device, chunk).run(one, pts)

    return grad_fn


class GridFiller:
    """Fill an N³ UDF vertex grid from a per-point decoder function.

    queries: where and in slices of how many points the decoder runs
    (`QueryStream`; None: CUDA, slices of 2^19 points)."""

    def __init__(
        self,
        resolution: int,
        coords_range: tuple = (-1.0, 1.0),
        block: int | None = None,
        max_dist: float = 0.1,
        band_mult: float = 2.5,
        surface_bias: float | str = 0.0,
        queries: QueryStream | None = None,
    ):
        self.queries = queries if queries is not None else QueryStream()
        self.surface_bias = surface_bias
        self.N = resolution
        self.lo, self.hi = coords_range
        self.max_dist = max_dist
        self.band_mult = band_mult
        self.spacing = (self.hi - self.lo) / (resolution - 1)
        if block is None:
            block = auto_block_size(resolution, self.spacing, max_dist, band_mult)
        if resolution % block:
            raise ValueError("resolution must be a multiple of block")
        self.block = block
        self.nb = resolution // block
        half_diag = 0.5 * math.sqrt(3.0) * block * self.spacing
        self.threshold = half_diag + band_mult * self.spacing
        # intermediate level: block/4 when that still tightens the shell
        self.sub_block = block // 4 if block >= 8 else 0
        xs = np.linspace(self.lo, self.hi, resolution, dtype=np.float32)
        centers = xs.reshape(self.nb, self.block).mean(axis=1)
        cg = np.stack(np.meshgrid(centers, centers, centers, indexing="ij"), axis=-1)
        self._block_centers = cg.reshape(-1, 3)

    def _offsets(self, n: int) -> torch.Tensor:
        r = torch.arange(n, device=self.queries.device)
        return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)

    @torch.no_grad()
    def fill(self, udf_fn: UdfFn, return_stats: bool = False):
        """Return the (N, N, N) float32 UDF grid (numpy, host)."""
        N, B, nb, queries = self.N, self.block, self.nb, self.queries
        dev = queries.device
        sp = torch.tensor(self.spacing, dtype=torch.float32, device=dev)
        lo = torch.tensor(self.lo, dtype=torch.float32, device=dev)

        if B == 1:
            grid = fill_grid_dense(udf_fn, N, (self.lo, self.hi), queries)
            if self.surface_bias == "auto":
                vb = 4 if N % 4 == 0 else (2 if N % 2 == 0 else 1)
                nbv = N // vb
                vmin = grid.reshape(nbv, vb, nbv, vb, nbv, vb).min(axis=(1, 3, 5)).reshape(-1)
                bias = estimate_surface_bias(vmin, self.spacing)
            else:
                bias = float(self.surface_bias or 0.0)
            if bias:
                grid = np.maximum(grid - np.float32(bias), np.float32(0.0))
            if return_stats:
                return grid, {"active_blocks": N**3, "total_blocks": N**3,
                              "fine_points": N**3, "dense_points": N**3,
                              "surface_bias": bias}
            return grid

        centers = torch.from_numpy(self._block_centers).to(dev)
        coarse = queries.run(udf_fn, centers).reshape(nb, nb, nb)
        ab = torch.nonzero(coarse < self.threshold).to(torch.int32)  # (M, 3), C order

        B2 = self.sub_block
        if B2 and len(ab):
            n_sub = B // B2
            sub_thr = 0.5 * math.sqrt(3.0) * B2 * self.spacing + self.band_mult * self.spacing
            off = (self._offsets(n_sub) * B2 + (B2 - 1) / 2.0).to(torch.float32)

            def sub_centers(abc):
                vidx = abc[:, None, :].to(torch.float32) * B + off[None]
                return udf_fn(vidx.reshape(-1, 3) * sp + lo)

            per = max(queries.chunk // n_sub**3, 1)
            sub_vals = queries.sliced(per).run(sub_centers, ab).reshape(len(ab), n_sub, n_sub,
                                                                        n_sub)
            sub_idx = torch.nonzero(sub_vals < sub_thr)
            ab = (ab[sub_idx[:, 0]] * n_sub + sub_idx[:, 1:]).to(torch.int32)
            B = B2

        grid = np.full((N, N, N), self.max_dist, dtype=np.float32)
        ab32 = np.ascontiguousarray(ab.cpu().numpy(), np.int32)
        bias = 0.0
        bias_pb = None  # (M,) per-block calibration aligned with ab32
        bias_field = None  # (N/B)³ field for the face filter's per-point widening
        block_min = np.empty((0,), np.float32)
        if len(ab32):
            off = self._offsets(B).to(torch.int32)
            # the evaluator's u16 download and the native dequantise-scatter;
            # a plain callable's f32 values are scattered as they are
            u16 = getattr(udf_fn, "u16", None)
            fine = u16 if u16 is not None else udf_fn

            def block_vals(abc):
                vidx = abc[:, None, :] * B + off[None]
                return fine(vidx.reshape(-1, 3).to(torch.float32) * sp + lo)

            per = max(queries.chunk // B**3, 1)
            vals = queries.sliced(per).run(block_vals, ab).cpu().numpy()
            M = len(ab32)
            qstep = np.float32(self.max_dist / 65535.0)
            if u16 is not None:
                vals = vals.astype(np.uint16)
                block_min = vals.reshape(M, -1).min(axis=1).astype(np.float32) * qstep
            else:
                vals = vals.astype(np.float32).reshape(M, B, B, B)
                block_min = vals.reshape(M, -1).min(axis=1)
            if self.surface_bias == "auto":
                est = estimate_surface_bias_field(ab32, block_min, N // B, self.spacing)
                if est is not None:
                    bias_pb, bias_field = est
                    bias = float(np.median(bias_pb))
            else:
                bias = float(self.surface_bias or 0.0)
                if bias:
                    bias_pb = np.full(M, bias, np.float32)
            # keep the corrected field ≥ half a quantisation step: a slightly
            # negative endpoint would extrapolate spike vertices in marching
            clamp_min = float(0.5 * qstep) if bias_pb is not None else 0.0
            if u16 is not None:
                native.scatter_u16_blocks(grid, ab32, vals, B, qstep, bias_pb, clamp_min)
            else:
                if bias_pb is not None:
                    vals = np.maximum(vals - bias_pb[:, None, None, None], np.float32(clamp_min))
                ax, ay, az = (ab32.astype(np.int64) * B).T
                r = np.arange(B)
                grid[(ax[:, None] + r)[:, :, None, None], (ay[:, None] + r)[:, None, :, None],
                     (az[:, None] + r)[:, None, None, :]] = vals

        if return_stats:
            return grid, {
                "active_blocks": len(ab32),
                "total_blocks": int((N // B) ** 3),
                "fine_points": len(ab32) * B**3,
                "dense_points": N**3,
                "ab": ab32,  # active blocks at their final granularity
                "block": B,
                "surface_bias": bias,
                "surface_bias_field": bias_field,
                "block_min": block_min,
            }
        return grid


    def fill_gradients(self, grad_fn: GradFn, udf_grid: np.ndarray,
                       band_mult: float = 2.5) -> np.ndarray:
        """(N,N,N,3) float32 gradients where udf < band_mult·voxel, zero
        elsewhere: the reference's dense near-band gradient pass (threshold
        2.5·side/N). The marching oracles read it; the generation path asks
        for gradients only at the active cubes' corners instead.

        Deliberate deviation from the JAX package, which evaluates at the
        linspace coordinates: the nodes are taken at index·spacing + lo in
        float32, where the fill evaluated them and where the gradient
        queries by grid id do (the two differ by an ulp at most nodes)."""
        N = self.N
        gids = np.flatnonzero(udf_grid.reshape(-1) < band_mult * self.spacing)
        grads = np.zeros((N**3, 3), dtype=np.float32)
        if len(gids) == 0:
            return grads.reshape(N, N, N, 3)
        x, rem = gids // (N * N), gids % (N * N)
        idx = np.stack([x, rem // N, rem % N], axis=-1).astype(np.float32)
        pts = idx * np.float32(self.spacing) + np.float32(self.lo)
        grads[gids] = self.queries.fetch(grad_fn, pts)
        return grads.reshape(N, N, N, 3)


@torch.no_grad()
def fill_grid_dense(udf_fn: UdfFn, resolution: int, coords_range=(-1.0, 1.0),
                    queries: QueryStream | None = None) -> np.ndarray:
    """Naive dense fill — the oracle for GridFiller (`queries` as there)."""
    queries = queries if queries is not None else QueryStream()
    xs = np.linspace(coords_range[0], coords_range[1], resolution, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    vals = queries.run(udf_fn, torch.from_numpy(g).to(queries.device))
    return vals.cpu().numpy().reshape(resolution, resolution, resolution)
