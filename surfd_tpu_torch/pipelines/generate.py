"""End-to-end generation: latent → UDF grid → mesh → cleanup.

Counterpart of surfd_tpu/pipelines/generate.py: latent sampling (DDPM,
DDIM or PLMS), the per-latent decoder evaluator, block-sparse extraction at
every `MeshExtractionConfig` setting (the fused native face filter on u16 or
exact f32 points, one- or two-tier, or no filter and the numpy cleanup), the
numpy face filter `filter_faces_by_udf`, and the watertight alternative
(signed marching at a small iso on the filled grid). `get_mesh_from_udf`
also takes any torch point callable, such as an analytic field. Every
query of one extraction goes through one `geometry.QueryStream`, built from
the field's device, `MeshExtractionConfig.max_batch` and its `mesh`.

Which evaluator runs where. Every decoder value on a CUDA device goes
through kernel K1 (`ops.folded_udf`): precision "f32" for the coarse,
sub-block and fine fill, the single-tier, tier-2 and exact-point face-filter
values and the band calibration's reference; "bf16" for tier 1 of the
two-tier filter. Gradients are torch autograd through the float32
CbnDecoder. On CUDA the cleanup's Laplacian smoothing runs on the card
(`ops.mesh_laplacian`, numpy's result bit for bit); on the CPU it is
numpy's `geometry.mesh_ops.laplacian_smooth`.

Deliberate deviation from the JAX package: where the native library cannot
load, JAX falls back to `filter_faces_by_udf` and numpy marching; the port
raises, and reaches those only when the caller asks for them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..diffusion import Schedule, VarType, ddim_sample_loop, p_sample_loop, plms_sample_loop
from ..geometry import (
    GridFiller,
    Mesh,
    QueryStream,
    filter_small_components,
    keep_largest_component,
    laplacian_smooth,
    make_grad_fn,
    marching_tetrahedra,
    marching_tetrahedra_udf,
    merge_duplicate_vertices,
    remove_unreferenced_vertices,
    smooth_borders,
    stabilize,
)
from ..geometry.grid import GRAD_CHUNK, to_device
from ..geometry.marching import gid_positions
from ..geometry.mesh_ops import _unique_i64
from ..models.decoder import CbnDecoder, coords_encode, udf_from_logits
from ..ops import mesh_laplacian
from ..ops.decoder_kernel import fold_decoder, folded_udf
from ..utils.convert import strip_prefix
from ..utils.device import resolve_device
from ..utils.profiling import span


class BiasTable:
    """Per-block surface-bias floor field, uint8-quantised, on the device:
    `at(p)` is the local bias at each point (nearest containing block)."""

    def __init__(self, field: np.ndarray, lo: float, cell: float, device):
        self.nb = field.shape[0]
        self.scale = float(field.max()) / 255.0
        self.cell_inv = 1.0 / cell
        self.lo = lo
        self.table = to_device(np.rint(field.reshape(-1) / self.scale).astype(np.uint8), device)

    def at(self, pts: torch.Tensor) -> torch.Tensor:
        bi = ((pts - self.lo) * self.cell_inv).to(torch.int32).clamp(0, self.nb - 1)
        flat = (bi[:, 0] * self.nb + bi[:, 1]) * self.nb + bi[:, 2]
        return self.table[flat].to(torch.float32) * self.scale


class UdfEvaluator:
    """The decoder bound to one latent: (P, 3) → (P,) UDF and its forms.

    Counterpart of the closure `make_udf_fn` returns in the JAX package. All
    inputs and outputs of the device forms are tensors on `self.device`.
    `queries` is its own `QueryStream`: that device, slices of `chunk`
    points, no data ranks; the field's values go through it. The `*_bound`
    forms are per-slice functions that a stream runs, and the queries of an
    extraction run them in slices of `chunk` too (the autograd gradient
    works in slices of at most `geometry.grid.GRAD_CHUNK`: it keeps every
    activation of its slice for the backward pass).
    """

    def __init__(self, decoder: CbnDecoder, latent: torch.Tensor, max_dist: float,
                 device: torch.device, chunk: int = 2**19):
        self.device = device
        self.decoder = decoder
        self.latent = latent
        self.max_dist = float(max_dist)
        self.chunk = chunk
        self.queries = QueryStream(device, chunk)
        self.folded = fold_decoder(decoder, latent, self.max_dist)
        self._band = None

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        """Float32 UDF (K1 f32)."""
        return self.queries.run(lambda p: folded_udf(self.folded, p, "f32"), pts)

    def udf_bf16(self, pts: torch.Tensor) -> torch.Tensor:
        """Tier-1 UDF: bf16 matmul inputs, f32 sums (K1 bf16)."""
        return self.queries.run(lambda p: folded_udf(self.folded, p, "bf16"), pts)

    def u16(self, pts: torch.Tensor) -> torch.Tensor:
        """UDF quantised to max_dist/65535 steps (values 0..65535, int32)."""
        return torch.round(self(pts) * (65535.0 / self.max_dist)).to(torch.int32)

    @staticmethod
    def _dequant(qpts: torch.Tensor, qlo: float, qstep: float) -> torch.Tensor:
        """u16 coordinates → f32 points q·qstep + qlo. qpts: int32 values
        0..65535, or int16 holding the u16 bits (the 2-byte upload); the
        constants are f32 CPU scalars, which a CUDA op takes as arguments
        (a device copy of them would wait for the stream)."""
        if qpts.dtype == torch.int16:
            qpts = qpts.to(torch.int32) & 0xFFFF
        return (qpts.to(torch.float32) * torch.tensor(qstep, dtype=torch.float32)
                + torch.tensor(qlo, dtype=torch.float32))

    def below_q16_bound(self, thr: float, qlo: float, qstep: float,
                        bias: BiasTable | None = None):
        """udf(p) − bias(p) ≤ thr at u16-quantised points p = q·qstep + qlo,
        a slice at a time: (P, 3) u16 points → (P,) bool."""

        def one(q):
            pts = self._dequant(q, qlo, qstep)
            u = folded_udf(self.folded, pts, "f32")
            if bias is not None:
                u = u - bias.at(pts)
            return u <= torch.tensor(thr, dtype=torch.float32)

        return one

    def below2t_q16_bound(self, thr: float, qlo: float, qstep: float, band: float,
                          bias: BiasTable | None = None):
        """Tier 1 of the two-tier filter, a slice at a time: (P, 3) u16
        points → (P, 2) bool, (below, sure) on the tier-1 UDF; `sure` is
        False within `band` of the threshold, where the caller re-checks
        with `below_q16_bound`."""

        def one(q):
            pts = self._dequant(q, qlo, qstep)
            u = folded_udf(self.folded, pts, "bf16")
            if bias is not None:
                u = u - bias.at(pts)
            t = torch.tensor(thr, dtype=torch.float32)
            return torch.stack([u <= t, (u - t).abs() > torch.tensor(band, dtype=torch.float32)],
                               dim=1)

        return one

    def two_tier_band(self, queries: QueryStream) -> float:
        """Calibrated tier-1 error band for this decoder and latent: 2× the
        max |tier 1 − f32| over a fixed 128k-point probe, at least
        1e-4·max_dist; the probe runs through `queries` on the first call.

        Deliberate deviation from the JAX package: its tier 1 is the all-bf16
        folded decoder, the port's is K1 bf16 (the TPU kernel's math, bf16
        matmul inputs with f32 sums and an f32 affine chain). The band is
        calibrated against the port's own tier 1, so the final mask still
        equals the f32 decision; only which points are re-checked differs.
        """
        if self._band is None:
            probe = np.random.default_rng(0).uniform(-1.0, 1.0, (131072, 3)).astype(np.float32)
            p = torch.from_numpy(probe).to(queries.device)
            err = float(queries.run(lambda x: (folded_udf(self.folded, x, "bf16")
                                               - folded_udf(self.folded, x, "f32")).abs(),
                                    p).max())
            self._band = max(2.0 * err, 1e-4 * self.max_dist)
        return self._band

    def autograd_udf(self, pts: torch.Tensor) -> torch.Tensor:
        """The float32 UDF through the CbnDecoder's differentiable ops (K1
        has no backward): what `geometry.make_grad_fn` differentiates."""
        return udf_from_logits(
            self.decoder(coords_encode(pts)[None], self.latent[None])[0], self.max_dist)

    def grad(self, pts: torch.Tensor) -> torch.Tensor:
        """∂udf/∂p by autograd through the float32 CbnDecoder
        (`geometry.make_grad_fn` over this evaluator)."""
        return make_grad_fn(self, min(self.chunk, GRAD_CHUNK))(pts)

    def grad_i8_gid_bound(self, R: int, lo: float, spacing: float):
        """int8 unit gradients at flat grid ids of an R³ grid, a slice at a
        time: (K,) int64 → (K, 3) int8."""
        RR = R * R
        sp = torch.tensor(np.float32(spacing))  # f32 CPU scalars: no device copy
        lo_t = torch.tensor(np.float32(lo))

        def one(g):
            xyz = torch.stack([g // RR, (g % RR) // R, g % R], dim=-1).to(torch.float32)
            d = self.grad(xyz * sp + lo_t)
            n = d.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            return torch.round(d / n * 127.0).to(torch.int8)

        return one

    def grad_i8_gid_async(self, gids, R: int, lo: float, spacing: float,
                          queries: QueryStream):
        """Start the int8 unit gradients at flat grid ids (host int64)
        through `queries`; the returned finalize() gives them as host int8:
        marching's gradient starter."""
        return queries.start(self.grad_i8_gid_bound(R, lo, spacing), np.asarray(gids, np.int64))


def make_udf_fn(decoder: CbnDecoder, state, latent, max_dist: float = 0.1, device=None,
                chunk: int = 2**19) -> UdfEvaluator:
    """Bind a CbnDecoder to one latent on `device` (CUDA by default).

    `state`: an upstream-layout `decoder.*` state dict to load first, or None
    to use the module's weights. The module is moved to the device.
    """
    dev = resolve_device(device)
    if state is not None:
        decoder.load_state_dict(strip_prefix(state, "decoder."), strict=True)
    decoder = decoder.to(dev).eval()
    lat = torch.as_tensor(np.asarray(latent, np.float32) if not torch.is_tensor(latent)
                          else latent).reshape(-1).to(device=dev, dtype=torch.float32)
    return UdfEvaluator(decoder, lat, max_dist, dev, chunk)


@dataclass
class MeshExtractionConfig:
    """Extraction settings: the JAX package's `MeshExtractionConfig`."""

    resolution: int = 512
    coords_range: tuple = (-1.0, 1.0)
    max_dist: float = 0.1
    max_batch: int = 2**19
    # False: no face filter; the numpy cleanup chain runs instead
    filter_faces: bool = True
    # threshold = face_filter_mult / resolution (reference th_dist = 1/N)
    face_filter_mult: float = 1.0
    # "auto": per-block floor field from the fill's block minima, subtracted
    # in the scatter and widening the filter threshold point by point; a
    # float forces a uniform bias; 0.0 is the raw reference semantics
    surface_bias: float | str = 0.0
    do_stabilize: bool = True  # fill 3-edge holes (and merge, on the numpy chain)
    do_smooth_borders: bool = True  # 20 Laplacian steps of the open borders
    # filter points on the 2^16 coords grid (half-step 1.5e-5 on (-1, 1),
    # under 1 % of the 1/512 threshold); False re-queries the exact f32
    # points, as the reference does
    quantized_filter_points: bool = True
    # two-tier filter: tier 1 (K1 bf16) decides outside the calibrated band,
    # tier 2 (K1 f32) re-checks the points inside it; the mask equals the
    # single-tier f32 one. It runs only while band < threshold / 4.
    two_tier_filter: bool = True
    # None: the band calibrated per decoder and latent; a float overrides it
    two_tier_band: float | None = None
    final_laplacian_iters: int = 0
    min_component_faces: int = 0
    # optional DeviceMesh (parallel.make_mesh) with a 'data' axis: the data
    # ranks of the extraction's QueryStream. Every query (fills, gradients,
    # face filter, band calibration) is split over them and gathered back,
    # so that every rank holds the unsharded grid and runs the same host
    # passes; every rank must call
    mesh: object = None


def _queries(udf_fn, cfg: MeshExtractionConfig) -> QueryStream:
    """An extraction's queries: on the field's `device` (CUDA for a field
    without one, which raises without a card: never a silent CPU run), in
    slices of `cfg.max_batch`, over the data ranks of `cfg.mesh`."""
    return QueryStream(getattr(udf_fn, "device", None), cfg.max_batch, cfg.mesh)


def make_field_bias_at(bias_field: np.ndarray, lo: float, cell: float):
    """Host per-point lookup into the per-block surface-bias floor field
    (the containing block: the field is block-constant)."""
    nb = bias_field.shape[0]

    def bias_at(pts: np.ndarray) -> np.ndarray:
        bi = np.clip(((pts - lo) * (1.0 / cell)).astype(np.int32), 0, nb - 1)
        return bias_field[bi[:, 0], bi[:, 1], bi[:, 2]]

    return bias_at


def _below_f32(udf_fn, pts: np.ndarray, threshold: float, queries: QueryStream,
               bias_at=None) -> np.ndarray:
    """udf(p) − bias_at(p) ≤ threshold at exact f32 points (host bool)."""
    u = queries.fetch(udf_fn, pts)
    if bias_at is not None:
        u = u - bias_at(pts)
    return u <= threshold


def filter_faces_by_udf(mesh: Mesh, udf_fn, threshold: float, queries: QueryStream,
                        bias_at=None) -> Mesh:
    """Drop faces with a vertex or an edge midpoint whose UDF exceeds
    `threshold` (the reference's false-face filter, th_dist = 1/N), in numpy
    around one evaluation of the deduplicated points through `queries`.
    bias_at: optional host (P, 3) → (P,) local surface-bias floor; the test
    is then udf(p) − bias_at(p) ≤ threshold."""
    if len(mesh.faces) == 0:
        return mesh
    v, f = mesh.vertices, mesh.faces
    ea_all = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
    eb_all = np.concatenate([f[:, 1], f[:, 2], f[:, 0]])
    NV = len(v) + 1
    uniq, inv = _unique_i64(np.minimum(ea_all, eb_all) * NV + np.maximum(ea_all, eb_all))
    ea = (uniq // NV).astype(np.int64)
    eb = (uniq % NV).astype(np.int64)
    pts = np.concatenate([v, 0.5 * (v[ea] + v[eb])], axis=0).astype(np.float32)
    ok = _below_f32(udf_fn, pts, threshold, queries, bias_at)
    mid_ok = ok[len(v):][inv].reshape(3, -1)
    keep = ok[: len(v)][f].all(axis=1) & mid_ok.all(axis=0)
    return Mesh(v, f[keep])


@torch.no_grad()
def get_mesh_from_udf(udf_fn, grad_fn=None, cfg: MeshExtractionConfig = MeshExtractionConfig(),
                      return_stats: bool = False):
    """UDF → cleaned open mesh: block-sparse fill, marching at the
    near-band corners, the face filter and the cleanup, as `cfg` selects.

    udf_fn: a `UdfEvaluator` (make_udf_fn), or any callable (P, 3) f32
    tensor → (P,) on one device, such as a `geometry.TorchField`. An
    evaluator's own forms are used, as the JAX package probes its
    evaluator: int8 gradients by grid id (`grad_i8_gid_async`), the
    u16-point filter (`below_q16_bound`) and its two tiers
    (`below2t_q16_bound`, `two_tier_band`), all in slices of its `chunk`.
    A plain callable gets its gradients from grad_fn (a torch point
    callable), else from `make_grad_fn`, at the grid nodes, and its filter
    on exact f32 points. Every query goes through one `QueryStream`: on
    udf_fn's `device`, else CUDA, in slices of `cfg.max_batch`, over the
    data ranks of `cfg.mesh`. Raises if the native library cannot load.
    With `cfg.mesh` every rank of its 'data' axis makes the call on the
    same udf_fn; each evaluates its share of every query and all get the
    unsharded mesh.

    Spans (`utils.profiling.span`): `extract` around the call, and below it
    `extract.fill`, `extract.marching`, `extract.face_filter` and
    `extract.cleanup`, each adding its host seconds to `stats["times"]`
    under `grid_fill`, `marching`, `face_filter` and `cleanup`; their passes
    are spans below them with keys of their own (`mt_*`, `ff_*`,
    `cleanup_finalize`, `cleanup_laplacian`, `cleanup_components`).
    `stats["times"]` holds seconds, rounded once at the end.
    """
    if isinstance(grad_fn, MeshExtractionConfig):
        raise TypeError("the second argument is grad_fn; pass the config as cfg=")
    with span("extract"):
        mesh, stats = _extract(udf_fn, grad_fn, cfg)
    return (mesh, stats) if return_stats else mesh


def _extract(udf_fn, grad_fn, cfg: MeshExtractionConfig):
    """`get_mesh_from_udf`'s work: (mesh, stats)."""
    queries = _queries(udf_fn, cfg)
    # an evaluator's own forms run in slices of its chunk
    own = queries.sliced(udf_fn.chunk) if isinstance(udf_fn, UdfEvaluator) else None
    times = {}
    with span("extract.fill", times, "grid_fill"):
        gf = GridFiller(cfg.resolution, cfg.coords_range, max_dist=cfg.max_dist,
                        surface_bias=cfg.surface_bias, queries=queries)
        grid, stats = gf.fill(udf_fn, return_stats=True)
    lo_, hi_ = cfg.coords_range
    R = cfg.resolution
    voxel = (hi_ - lo_) / (R - 1)
    # the grid has the calibrated bias subtracted; re-queries of the decoder
    # widen the threshold by the local bias (the field), or by its median
    surf_bias = float(stats.get("surface_bias") or 0.0)
    bias_field = stats.get("surface_bias_field")
    if bias_field is not None and not float(bias_field.max()) > 0:
        bias_field, surf_bias = None, 0.0
    cell = (R // bias_field.shape[0]) * voxel if bias_field is not None else None
    active_blocks = (stats["ab"], stats["block"]) if len(stats.get("ab", ())) else None

    with span("extract.marching", times, "marching"):
        # marching starts the gradients before its host corner-rank pass, so the two overlap
        if grad_fn is None and own is not None:
            start_grads = lambda gids: udf_fn.grad_i8_gid_async(gids, R, lo_, voxel, own)
        else:
            point_grad = grad_fn if grad_fn is not None else make_grad_fn(udf_fn)
            start_grads = lambda gids: queries.start(
                point_grad, gid_positions(np.asarray(gids, np.int64), R, lo_, voxel))
        mesh = marching_tetrahedra_udf(grid, start_grads, cfg.coords_range, times=times,
                                       stats=stats, active_blocks=active_blocks)
    stats["raw_faces"] = len(mesh.faces)

    # Output guards: every MT vertex is a convex combination of grid nodes,
    # so out-of-domain vertices mean a regression — dropped and counted.
    stats["oob_vertices"] = 0
    if len(mesh.faces):
        vlo, vhi = lo_ - 2 * voxel, hi_ + 2 * voxel
        bad = ((mesh.vertices < vlo) | (mesh.vertices > vhi)).any(axis=1)
        stats["oob_vertices"] = int(bad.sum())
        if stats["oob_vertices"]:
            keep = ~bad[mesh.faces].any(axis=1)
            mesh = remove_unreferenced_vertices(Mesh(mesh.vertices, mesh.faces[keep]))
    stats["face_budget_ratio"] = round(len(mesh.faces) / max(stats.get("fine_points", 0), 1), 3)
    stats["face_explosion"] = stats["face_budget_ratio"] > 2.0

    if len(mesh.faces) and cfg.filter_faces:
        pre = own is not None and cfg.quantized_filter_points
        cleanup = dict(fill_holes=cfg.do_stabilize,
                       smooth_iters=20 if cfg.do_smooth_borders else 0,
                       lam=0.3, merge_decimals=6)
        with span("extract.face_filter", times, "face_filter"):
            if pre:
                with span("face_filter.prep", times, "ff_prep"):
                    bias_tbl = (BiasTable(bias_field, lo_, cell, queries.device)
                                if bias_field is not None else None)
                    threshold = cfg.face_filter_mult / R + (0.0 if bias_tbl is not None
                                                            else surf_bias)
                    qstep = (hi_ - lo_) / 65535.0
                    two_tier, band = cfg.two_tier_filter, None
                    if two_tier:
                        band = (cfg.two_tier_band if cfg.two_tier_band is not None
                                else udf_fn.two_tier_band(own))
                        # filter points sit on the surface, where |udf − thr| is
                        # small: a wide band re-checks most of them and one f32 pass
                        # is cheaper
                        two_tier = band < 0.25 * threshold
                    stats.update(ff_band=band, ff_threshold=threshold, ff_two_tier=two_tier)
                    qverts = np.clip(np.rint((mesh.vertices - lo_) * (1.0 / qstep)), 0,
                                     65535).astype(np.uint16)
                    # overlap: the vertex query runs on the device while the host
                    # builds the edge structure, then the midpoint query; the u16
                    # points go up as 2 bytes each (int16 bits, widened on the device)
                    bound = (udf_fn.below2t_q16_bound(threshold, lo_, qstep, band, bias_tbl)
                             if two_tier else udf_fn.below_q16_bound(threshold, lo_, qstep,
                                                                     bias_tbl))
                    query = lambda qp: own.start(bound, qp.view(np.int16))
                    verts_pending = query(qverts)
                    qmids, einv, ea, eb = native.face_filter_prep_q16(
                        mesh.vertices, mesh.faces, lo_, 1.0 / qstep)
                mids_pending = query(qmids)
                with span("face_filter.fetch", times, "ff_fetch"):
                    res = np.concatenate([verts_pending(), mids_pending()])
                if two_tier:
                    ok, sure = res[:, 0].copy(), res[:, 1]
                    uns = np.flatnonzero(~sure)
                    stats["ff_unsure"] = int(len(uns))
                    if len(uns):
                        # tier 2 (f32, exact): only the band points re-query
                        with span("face_filter.t2", times, "ff_t2"):
                            qall = np.concatenate([qverts, qmids])[uns]
                            ok[uns] = own.fetch(
                                udf_fn.below_q16_bound(threshold, lo_, qstep, bias_tbl),
                                qall.view(np.int16))
                else:
                    ok = res
                ok = ok.view(np.uint8)
            else:
                # exact f32 points, the bias field looked up point by point
                with span("face_filter.prep", times, "ff_prep"):
                    bias_at = (make_field_bias_at(bias_field, lo_, cell) if bias_field is not None
                               else None)
                    threshold = cfg.face_filter_mult / R + (0.0 if bias_at is not None
                                                            else surf_bias)
                    stats.update(ff_band=None, ff_threshold=threshold, ff_two_tier=False)
                    pts, einv = native.face_filter_prep(mesh.vertices, mesh.faces)
                ok = _below_f32(udf_fn, pts, threshold, queries, bias_at)
        with span("extract.cleanup", times, "cleanup"):
            with span("cleanup.finalize", times, "cleanup_finalize"):
                if pre:
                    v, f = native.finalize_mesh_pre(mesh.vertices, mesh.faces, ok, einv, ea, eb,
                                                    **cleanup)
                else:
                    v, f = native.finalize_mesh(mesh.vertices, mesh.faces, ok, einv, **cleanup)
                mesh = Mesh(v, f)
            mesh = _final_passes(mesh, cfg, times, queries.device)
    elif len(mesh.faces):
        # no filter: the numpy cleanup chain (MT output is duplicate-free)
        with span("extract.cleanup", times, "cleanup"):
            with span("cleanup.finalize", times, "cleanup_finalize"):
                if cfg.do_stabilize:
                    mesh = stabilize(mesh, assume_clean=True)
                if cfg.do_smooth_borders:
                    mesh = smooth_borders(mesh, iterations=20, lam=0.3)
            mesh = _final_passes(mesh, cfg, times, queries.device)
            with span("cleanup.finalize", times, "cleanup_finalize"):
                mesh = merge_duplicate_vertices(mesh)

    stats["final_faces"] = len(mesh.faces)
    stats["times"] = {k: round(v, 4) for k, v in times.items()}
    return mesh, stats


def _final_passes(mesh: Mesh, cfg: MeshExtractionConfig, times: dict,
                  dev: torch.device) -> Mesh:
    """The cleanup's passes after the finalize: the Laplacian smoothing and
    the small-component filter, where `cfg` asks for them. On CUDA the
    smoothing runs on the card: the mesh goes up pinned, the float32
    vertices come back; the faces stay on the host as they are."""
    if cfg.final_laplacian_iters:
        with span("cleanup.laplacian", times, "cleanup_laplacian"):
            if dev.type == "cuda":
                v = mesh_laplacian.laplacian_smooth(
                    to_device(np.asarray(mesh.vertices, np.float32), dev),
                    to_device(np.asarray(mesh.faces, np.int64), dev),
                    cfg.final_laplacian_iters, 0.5)
                mesh = Mesh(v.cpu().numpy(), mesh.faces)
            else:
                mesh = laplacian_smooth(mesh, iterations=cfg.final_laplacian_iters, lam=0.5)
    if cfg.min_component_faces:
        with span("cleanup.components", times, "cleanup_components"):
            mesh = filter_small_components(mesh, cfg.min_component_faces)
    return mesh


@torch.no_grad()
def get_watertight_mesh_from_udf(udf_fn, cfg: MeshExtractionConfig = MeshExtractionConfig(),
                                 iso: float = 0.01, return_stats: bool = False):
    """Evaluator → the iso-`iso` shell of the UDF: the grid fill (K1 f32,
    with `cfg.surface_bias`, so that iso applies to the bias-corrected
    field), signed marching tetrahedra on the host, the component with the
    longest bounding-box diagonal, renormalised to [-1, 1]. The shell of an
    open sheet is cut by the domain wall, so it may have a boundary.

    Spans: `extract` around the call, and below it `extract.fill` and
    `extract.marching`, adding their host seconds to `stats["times"]` under
    `grid_fill` and `marching`, then `extract.component`."""
    times = {}
    with span("extract"):
        with span("extract.fill", times, "grid_fill"):
            gf = GridFiller(cfg.resolution, cfg.coords_range, max_dist=cfg.max_dist,
                            surface_bias=cfg.surface_bias, queries=_queries(udf_fn, cfg))
            grid = gf.fill(udf_fn)
        with span("extract.marching", times, "marching"):
            mesh = marching_tetrahedra(grid, iso=iso, coords_range=cfg.coords_range)
        raw_faces = len(mesh.faces)
        with span("extract.component"):
            mesh = keep_largest_component(mesh, by_bbox=True)
            if len(mesh.vertices):
                v = mesh.vertices
                center = (v.max(0) + v.min(0)) / 2
                scale = np.abs(v - center).max()
                mesh = Mesh((v - center) / max(scale, 1e-9), mesh.faces)
    if return_stats:
        return mesh, {"raw_faces": raw_faces, "final_faces": len(mesh.faces),
                      "times": {k: round(v, 3) for k, v in times.items()}}
    return mesh


@torch.no_grad()
def sample_latents(
    sched: Schedule,
    model_fn,
    num_samples: int,
    latent_len: int,
    generator: torch.Generator | None = None,
    *,
    sampler: str = "ddpm",
    device=None,
    clip_denoised: bool = False,
    var_type: VarType = VarType.FIXED_SMALL,
    noise: torch.Tensor | None = None,
    step_noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample (B, L) latent codes with `sampler` ("ddpm", "ddim" at η 0, or
    "plms" of order 2); the model sees (B, L, 1). PLMS draws no step noise
    and takes no `step_noise`.

    clip_denoised defaults False as in every reference generate script:
    autoencoder latents are not bounded to [-1, 1].

    Spans (`utils.profiling.span`): `sample` around the loop, whose steps
    are `sample.step` spans, and `sample.denoise` around each model_fn call.
    """
    loops = {"ddpm": p_sample_loop, "ddim": ddim_sample_loop, "plms": plms_sample_loop}
    if sampler not in loops:
        raise ValueError(f"unknown sampler: {sampler}")
    if sampler == "plms" and step_noise is not None:
        raise ValueError("PLMS draws no step noise")
    kw = {} if sampler == "plms" else {"step_noise": step_noise}
    dev = resolve_device(device)

    def denoise(x, t):
        with span("sample.denoise"):
            return model_fn(x, t)

    with span("sample"):
        out = loops[sampler](
            sched, denoise, (num_samples, latent_len, 1), generator, device=dev, noise=noise,
            clip_denoised=clip_denoised, var_type=var_type, **kw,
        )
    return out[..., 0]
