"""End-to-end generation: latent → UDF grid → mesh → cleanup.

Counterpart of surfd_tpu/pipelines/generate.py on its main path: latent
sampling (DDPM, DDIM or PLMS), the per-latent decoder evaluator, block-sparse
extraction with the fused native face filter and cleanup, and the watertight
alternative (signed marching at a small iso on the filled grid).

Which evaluator runs where. Every decoder value on a CUDA device goes
through kernel K1 (`ops.folded_udf`): precision "f32" for the coarse,
sub-block and fine fill, the single-tier and tier-2 face-filter masks and the
band calibration's reference; "bf16" for tier 1 of the two-tier filter.
Gradients are torch autograd through the float32 CbnDecoder.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..diffusion import Schedule, VarType, ddim_sample_loop, p_sample_loop, plms_sample_loop
from ..geometry import (
    GridFiller,
    Mesh,
    filter_small_components,
    keep_largest_component,
    laplacian_smooth,
    marching_tetrahedra,
    marching_tetrahedra_udf,
    remove_unreferenced_vertices,
)
from ..models.decoder import CbnDecoder, coords_encode, udf_from_logits
from ..ops.decoder_kernel import fold_decoder, folded_udf
from ..utils.convert import strip_prefix
from ..utils.device import resolve_device

DOMAIN = (-1.0, 1.0)


class BiasTable:
    """Per-block surface-bias floor field, uint8-quantised, on the device:
    `at(p)` is the local bias at each point (nearest containing block)."""

    def __init__(self, field: np.ndarray, lo: float, cell: float, device):
        self.nb = field.shape[0]
        self.scale = float(field.max()) / 255.0
        self.cell_inv = 1.0 / cell
        self.lo = lo
        self.table = torch.from_numpy(
            np.rint(field.reshape(-1) / self.scale).astype(np.uint8)
        ).to(device)

    def at(self, pts: torch.Tensor) -> torch.Tensor:
        bi = ((pts - self.lo) * self.cell_inv).to(torch.int32).clamp(0, self.nb - 1)
        flat = (bi[:, 0] * self.nb + bi[:, 1]) * self.nb + bi[:, 2]
        return self.table[flat].to(torch.float32) * self.scale


class UdfEvaluator:
    """The decoder bound to one latent: (P, 3) → (P,) UDF and its forms.

    Counterpart of the closure `make_udf_fn` returns in the JAX package. All
    inputs and outputs of the device forms are tensors on `self.device`;
    every form works through its input in chunks of `chunk` points (the
    autograd gradient in chunks of at most GRAD_CHUNK: it keeps every
    activation of its chunk for the backward pass).
    """

    GRAD_CHUNK = 2**16

    def __init__(self, decoder: CbnDecoder, latent: torch.Tensor, max_dist: float,
                 device: torch.device, chunk: int = 2**19):
        self.device = device
        self.decoder = decoder
        self.latent = latent
        self.max_dist = float(max_dist)
        self.chunk = chunk
        self.folded = fold_decoder(decoder, latent, self.max_dist)
        self._band = None

    def _chunks(self, fn, x: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
        chunk = chunk or self.chunk
        if len(x) == 0:
            return fn(x)
        return torch.cat([fn(x[i:i + chunk]) for i in range(0, len(x), chunk)])

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        """Float32 UDF (K1 f32)."""
        return self._chunks(lambda p: folded_udf(self.folded, p, "f32"), pts)

    def udf_bf16(self, pts: torch.Tensor) -> torch.Tensor:
        """Tier-1 UDF: bf16 matmul inputs, f32 sums (K1 bf16)."""
        return self._chunks(lambda p: folded_udf(self.folded, p, "bf16"), pts)

    def u16(self, pts: torch.Tensor) -> torch.Tensor:
        """UDF quantised to max_dist/65535 steps (values 0..65535, int32)."""
        return torch.round(self(pts) * (65535.0 / self.max_dist)).to(torch.int32)

    def _dequant(self, qpts: torch.Tensor, qlo: float, qstep: float) -> torch.Tensor:
        return qpts.to(torch.float32) * torch.tensor(qstep, device=self.device) + torch.tensor(
            qlo, device=self.device)

    def below_q16(self, qpts: torch.Tensor, thr: float, qlo: float, qstep: float,
                  bias: BiasTable | None = None) -> torch.Tensor:
        """udf(p) − bias(p) ≤ thr at u16-quantised points p = q·qstep + qlo."""
        pts = self._dequant(qpts, qlo, qstep)
        u = self(pts)
        if bias is not None:
            u = u - bias.at(pts)
        return u <= torch.tensor(thr, dtype=torch.float32)

    def below2t_q16(self, qpts: torch.Tensor, thr: float, qlo: float, qstep: float,
                    band: float, bias: BiasTable | None = None):
        """Tier 1 of the two-tier filter: (below, sure) on the tier-1 UDF;
        `sure` is False within `band` of the threshold, where the caller
        re-checks with `below_q16`."""
        pts = self._dequant(qpts, qlo, qstep)
        u = self.udf_bf16(pts)
        if bias is not None:
            u = u - bias.at(pts)
        t = torch.tensor(thr, dtype=torch.float32)
        return u <= t, (u - t).abs() > torch.tensor(band, dtype=torch.float32)

    def two_tier_band(self) -> float:
        """Calibrated tier-1 error band for this decoder and latent: 2× the
        max |tier 1 − f32| over a fixed 128k-point probe, at least
        1e-4·max_dist.

        Deliberate deviation from the JAX package: its tier 1 is the all-bf16
        folded decoder, the port's is K1 bf16 (the TPU kernel's math, bf16
        matmul inputs with f32 sums and an f32 affine chain). The band is
        calibrated against the port's own tier 1, so the final mask still
        equals the f32 decision; only which points are re-checked differs.
        """
        if self._band is None:
            probe = np.random.default_rng(0).uniform(-1.0, 1.0, (131072, 3)).astype(np.float32)
            p = torch.from_numpy(probe).to(self.device)
            err = float((self.udf_bf16(p) - self(p)).abs().max())
            self._band = max(2.0 * err, 1e-4 * self.max_dist)
        return self._band

    def grad(self, pts: torch.Tensor) -> torch.Tensor:
        """∂udf/∂p by autograd through the float32 CbnDecoder."""
        def one(p):
            with torch.enable_grad():
                p = p.detach().requires_grad_(True)
                u = udf_from_logits(
                    self.decoder(coords_encode(p)[None], self.latent[None])[0], self.max_dist
                )
                (g,) = torch.autograd.grad(u.sum(), p)
            return g
        return self._chunks(one, pts, min(self.chunk, self.GRAD_CHUNK))

    def grad_i8_gid(self, gids, R: int, lo: float, spacing: float) -> np.ndarray:
        """int8 unit gradients at flat grid ids (host int64 in, host int8 out)."""
        g = torch.as_tensor(np.ascontiguousarray(gids, np.int64), device=self.device)
        RR = R * R
        xyz = torch.stack([g // RR, (g % RR) // R, g % R], dim=-1).to(torch.float32)
        pts = xyz * torch.tensor(np.float32(spacing), device=self.device) + torch.tensor(
            np.float32(lo), device=self.device)
        d = self.grad(pts)
        n = d.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.round(d / n * 127.0).to(torch.int8).cpu().numpy()


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
    """Extraction settings. The domain is [-1, 1]³; the face filter always
    runs two-tier with a calibrated band (off when the band reaches a
    quarter of the threshold); the cleanup always fills holes and smooths
    the borders."""

    resolution: int = 512
    max_dist: float = 0.1
    max_batch: int = 2**19
    # threshold = face_filter_mult / resolution (reference th_dist = 1/N)
    face_filter_mult: float = 1.0
    # "auto": per-block floor field from the fill's block minima, subtracted
    # in the scatter and widening the filter threshold point by point; a
    # float forces a uniform bias; 0.0 is the raw reference semantics
    surface_bias: float | str = 0.0
    final_laplacian_iters: int = 0
    min_component_faces: int = 0


@torch.no_grad()
def get_mesh_from_udf(udf_fn: UdfEvaluator, cfg: MeshExtractionConfig = MeshExtractionConfig(),
                      return_stats: bool = False):
    """Evaluator → cleaned open mesh: block-sparse fill, int8 gradients at
    the near-band corners, native marching, the u16-point face filter and
    the fused native cleanup. Raises if the native library cannot load."""
    dev = resolve_device(udf_fn.device)
    times = {}
    t0 = time.perf_counter()
    gf = GridFiller(cfg.resolution, DOMAIN, max_batch=cfg.max_batch,
                    max_dist=cfg.max_dist, surface_bias=cfg.surface_bias, device=dev)
    grid, stats = gf.fill(udf_fn, return_stats=True)
    times["grid_fill"] = time.perf_counter() - t0
    lo_, hi_ = DOMAIN
    voxel = (hi_ - lo_) / (cfg.resolution - 1)
    bias_field = stats.get("surface_bias_field")
    bias_tbl = None
    if bias_field is not None and float(bias_field.max()) > 0:
        bias_tbl = BiasTable(bias_field, lo_, (cfg.resolution // bias_field.shape[0]) * voxel,
                             dev)
    active_blocks = (stats["ab"], stats["block"]) if len(stats.get("ab", ())) else None

    t0 = time.perf_counter()
    grad_at = lambda gids: udf_fn.grad_i8_gid(gids, cfg.resolution, lo_, voxel)
    mesh = marching_tetrahedra_udf(grid, grad_at, DOMAIN, times=times,
                                   active_blocks=active_blocks)
    times["marching"] = time.perf_counter() - t0
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

    if len(mesh.faces):
        t0 = time.perf_counter()
        threshold = cfg.face_filter_mult / cfg.resolution + (
            0.0 if bias_tbl is not None else float(stats.get("surface_bias") or 0.0))
        qstep = (hi_ - lo_) / 65535.0
        band = udf_fn.two_tier_band()
        # filter points sit on the surface, where |udf − thr| is small:
        # a wide band re-checks most of them and one f32 pass is cheaper
        two_tier = band < 0.25 * threshold
        stats.update(ff_band=band, ff_threshold=threshold, ff_two_tier=two_tier)
        qverts = np.clip(np.rint((mesh.vertices - lo_) * (1.0 / qstep)), 0, 65535).astype(np.uint16)
        qmids, einv, ea, eb = native.face_filter_prep_q16(mesh.vertices, mesh.faces, lo_, 1.0 / qstep)
        times["ff_prep"] = round(time.perf_counter() - t0, 3)
        qall = np.concatenate([qverts, qmids])
        q = torch.from_numpy(qall.astype(np.int32)).to(dev)
        if two_tier:
            t1 = time.perf_counter()
            below, sure = udf_fn.below2t_q16(q, threshold, lo_, qstep, band, bias_tbl)
            uns = torch.nonzero(~sure)[:, 0]
            stats["ff_unsure"] = int(len(uns))
            if len(uns):
                below[uns] = udf_fn.below_q16(q[uns], threshold, lo_, qstep, bias_tbl)
            times["ff_t1_t2"] = round(time.perf_counter() - t1, 3)
        else:
            below = udf_fn.below_q16(q, threshold, lo_, qstep, bias_tbl)
        ok = below.to(torch.uint8).cpu().numpy()
        times["face_filter"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        v, f = native.finalize_mesh_pre(
            mesh.vertices, mesh.faces, ok, einv, ea, eb,
            fill_holes=True, smooth_iters=20,
            lam=0.3, merge_decimals=6,
        )
        mesh = Mesh(v, f)
        if cfg.final_laplacian_iters:
            mesh = laplacian_smooth(mesh, iterations=cfg.final_laplacian_iters, lam=0.5)
        if cfg.min_component_faces:
            mesh = filter_small_components(mesh, cfg.min_component_faces)
        times["cleanup"] = time.perf_counter() - t0

    if return_stats:
        stats["final_faces"] = len(mesh.faces)
        stats["times"] = {k: round(v, 3) for k, v in times.items()}
        return mesh, stats
    return mesh


@torch.no_grad()
def get_watertight_mesh_from_udf(udf_fn: UdfEvaluator,
                                 cfg: MeshExtractionConfig = MeshExtractionConfig(),
                                 iso: float = 0.01, return_stats: bool = False):
    """Evaluator → the iso-`iso` shell of the UDF: the grid fill (K1 f32,
    with `cfg.surface_bias`, so that iso applies to the bias-corrected
    field), signed marching tetrahedra on the host, the component with the
    longest bounding-box diagonal, renormalised to [-1, 1]. The shell of an
    open sheet is cut by the domain wall, so it may have a boundary."""
    dev = resolve_device(udf_fn.device)
    times = {}
    t0 = time.perf_counter()
    gf = GridFiller(cfg.resolution, DOMAIN, max_batch=cfg.max_batch, max_dist=cfg.max_dist,
                    surface_bias=cfg.surface_bias, device=dev)
    grid = gf.fill(udf_fn)
    times["grid_fill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = marching_tetrahedra(grid, iso=iso, coords_range=DOMAIN)
    times["marching"] = time.perf_counter() - t0
    raw_faces = len(mesh.faces)
    t0 = time.perf_counter()
    mesh = keep_largest_component(mesh, by_bbox=True)
    if len(mesh.vertices):
        v = mesh.vertices
        center = (v.max(0) + v.min(0)) / 2
        scale = np.abs(v - center).max()
        mesh = Mesh((v - center) / max(scale, 1e-9), mesh.faces)
    times["component"] = time.perf_counter() - t0
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
    """
    loops = {"ddpm": p_sample_loop, "ddim": ddim_sample_loop, "plms": plms_sample_loop}
    if sampler not in loops:
        raise ValueError(f"unknown sampler: {sampler}")
    if sampler == "plms" and step_noise is not None:
        raise ValueError("PLMS draws no step noise")
    kw = {} if sampler == "plms" else {"step_noise": step_noise}
    dev = resolve_device(device)
    out = loops[sampler](
        sched, model_fn, (num_samples, latent_len, 1), generator, device=dev, noise=noise,
        clip_denoised=clip_denoised, var_type=var_type, **kw,
    )
    return out[..., 0]
