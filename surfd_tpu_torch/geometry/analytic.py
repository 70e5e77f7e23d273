"""Analytic field fixtures for extraction checks (counterpart of
surfd_tpu/geometry/analytic.py).

Each numpy fixture returns float32 grids indexed [x, y, z] over [-1, 1]³ —
(sdf or None, udf, ∂udf/∂xyz, sample_surface(n, rng)) — bit-equal to the JAX
package's. The sphere and torus are closed, so the exact signs give an
oracle mesh (`marching_tetrahedra` on the sdf); the sheet is open, the case
only an unsigned extractor represents.

`TorchField` is the same unsigned field as a torch callable on an explicit
device, (P, 3) → (P,): what `pipelines.get_mesh_from_udf` takes as a plain
callable. Its gradient is autograd (`geometry.make_grad_fn`).
"""

from __future__ import annotations

import numpy as np
import torch


def _grid(R: int):
    xs = np.linspace(-1.0, 1.0, R, dtype=np.float32)
    return np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)


def sphere_fields(R: int, radius: float = 0.6):
    """Closed surface: the sphere of `radius`. Returns (sdf, udf, grad_udf,
    sample_surface(n, rng))."""
    g = _grid(R)
    d = np.linalg.norm(g, axis=-1)
    sdf = (d - radius).astype(np.float32)
    udf = np.abs(sdf)
    n = g / np.maximum(d[..., None], 1e-9)
    grad = (np.sign(sdf)[..., None] * n).astype(np.float32)

    def sample_surface(n_pts: int, rng: np.random.Generator):
        v = rng.normal(size=(n_pts, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        return (v * radius).astype(np.float32)

    return sdf, udf, grad, sample_surface


def torus_fields(R: int, ring: float = 0.55, tube: float = 0.25):
    """Closed genus-1 surface: the torus around the z axis."""
    g = _grid(R)
    rho = np.sqrt(g[..., 0] ** 2 + g[..., 1] ** 2)
    q = np.stack([rho - ring, g[..., 2]], axis=-1)
    qn = np.linalg.norm(q, axis=-1)
    sdf = (qn - tube).astype(np.float32)
    udf = np.abs(sdf)
    # ∇sdf: d/dxyz of |(rho − ring, z)| − tube
    safe_rho = np.maximum(rho, 1e-9)
    safe_qn = np.maximum(qn, 1e-9)[..., None]
    grad_sdf = np.stack(
        [
            q[..., 0] / safe_qn[..., 0] * g[..., 0] / safe_rho,
            q[..., 0] / safe_qn[..., 0] * g[..., 1] / safe_rho,
            q[..., 1] / safe_qn[..., 0],
        ],
        axis=-1,
    )
    grad = (np.sign(sdf)[..., None] * grad_sdf).astype(np.float32)

    def sample_surface(n_pts: int, rng: np.random.Generator):
        theta = rng.uniform(0, 2 * np.pi, n_pts)
        phi = rng.uniform(0, 2 * np.pi, n_pts)
        rr = ring + tube * np.cos(phi)
        return np.stack(
            [rr * np.cos(theta), rr * np.sin(theta), tube * np.sin(phi)], axis=-1
        ).astype(np.float32)

    return sdf, udf, grad, sample_surface


def sheet_fields(R: int, half: float = 0.5):
    """Open surface: the square sheet z = 0, |x|, |y| ≤ half. No sdf exists;
    returns (None, udf, grad_udf, sample_surface)."""
    g = _grid(R)
    cp = g.copy()
    cp[..., 0] = np.clip(cp[..., 0], -half, half)
    cp[..., 1] = np.clip(cp[..., 1], -half, half)
    cp[..., 2] = 0.0
    delta = g - cp
    udf = np.linalg.norm(delta, axis=-1).astype(np.float32)
    grad = (delta / np.maximum(udf[..., None], 1e-9)).astype(np.float32)

    def sample_surface(n_pts: int, rng: np.random.Generator):
        xy = rng.uniform(-half, half, (n_pts, 2))
        return np.concatenate([xy, np.zeros((n_pts, 1))], axis=-1).astype(np.float32)

    return None, udf, grad, sample_surface


FIXTURES = {
    "sphere": sphere_fields,
    "torus": torus_fields,
    "open_sheet": sheet_fields,
}


def _sphere_udf(p: torch.Tensor, radius: float = 0.6) -> torch.Tensor:
    return (torch.linalg.vector_norm(p, dim=-1) - radius).abs()


def _torus_udf(p: torch.Tensor, ring: float = 0.55, tube: float = 0.25) -> torch.Tensor:
    rho = torch.linalg.vector_norm(p[:, :2], dim=-1)
    q = torch.stack([rho - ring, p[:, 2]], dim=-1)
    return (torch.linalg.vector_norm(q, dim=-1) - tube).abs()


def _sheet_udf(p: torch.Tensor, half: float = 0.5) -> torch.Tensor:
    cp = torch.cat([p[:, :2].clamp(-half, half), torch.zeros_like(p[:, 2:])], dim=-1)
    return torch.linalg.vector_norm(p - cp, dim=-1)


_TORCH_UDFS = {"sphere": _sphere_udf, "torus": _torus_udf, "open_sheet": _sheet_udf}


class TorchField:
    """One of FIXTURES' unsigned fields, at the fixture's default shape, as a
    torch callable on `device`: (P, 3) f32 → (P,) f32, differentiable."""

    def __init__(self, name: str, device):
        if name not in _TORCH_UDFS:
            raise ValueError(f"unknown field {name!r}; one of {sorted(_TORCH_UDFS)}")
        self.name = name
        self.device = torch.device(device)

    def __call__(self, pts: torch.Tensor) -> torch.Tensor:
        return _TORCH_UDFS[self.name](pts.to(self.device))
