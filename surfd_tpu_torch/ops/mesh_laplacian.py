"""Uniform Laplacian smoothing of a triangle mesh, the cleanup's last-but-one
pass: `iterations` Jacobi steps v ← v + λ·(mean(neighbours) − v).

The kernel, `ops/csrc/mesh_laplacian.cu`, replaces no TPU kernel: the JAX
package smooths on the host in float64 numpy
(surfd_tpu/geometry/mesh_ops.py:184-200), and the port's CPU path still
does (`geometry.mesh_ops.laplacian_smooth`). On the card the pass is bound
by bytes: a pass reads the corner rows, the corners' vertex ids and the
float64 positions, ~60 MB at 256³ and mostly from L2. A call from the host
is bound by its PCIe copies (~50 MB of faces and vertices up, ~10 MB down).
The source note in the .cu file gives the design.

The neighbours are numpy's multiset of directed edges (both other vertices
of every face a vertex is in, a shared neighbour counted once per face),
the sums are float64 in numpy's order, and a vertex in no face stays: the
kernel and the plain version below give numpy's float32 result bit for bit.
"""

from __future__ import annotations

import threading

import torch

from . import _build


def _check(vertices: torch.Tensor, faces: torch.Tensor, iterations: int) -> None:
    if vertices.dim() != 2 or vertices.shape[1] != 3 or vertices.dtype != torch.float32:
        raise ValueError(f"vertices must be (V, 3) float32, got {tuple(vertices.shape)} "
                         f"{vertices.dtype}")
    if faces.dim() != 2 or faces.shape[1] != 3 or faces.dtype != torch.int64:
        raise ValueError(f"faces must be (F, 3) int64, got {tuple(faces.shape)} {faces.dtype}")
    if faces.device != vertices.device:
        raise ValueError(f"faces on {faces.device}, vertices on {vertices.device}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")


def _ids_outside(V: int) -> ValueError:
    return ValueError(f"faces hold vertex ids outside [0, {V})")


def laplacian_smooth_ref(vertices: torch.Tensor, faces: torch.Tensor, iterations: int = 3,
                         lam: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: numpy's passes (`geometry.mesh_ops`) in float64
    with `index_add_` over the directed edges in numpy's order; returns the
    (V, 3) float32 vertices."""
    laplacian_smooth_ref.calls += 1
    _check(vertices, faces, iterations)
    V = len(vertices)
    if len(faces) and (int(faces.min()) < 0 or int(faces.max()) >= V):
        raise _ids_outside(V)
    f = faces
    e = torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]],
                   f[:, [1, 0]], f[:, [2, 1]], f[:, [0, 2]]])
    v = vertices.to(torch.float64)
    cnt = torch.zeros(V, dtype=torch.float64, device=v.device)
    cnt.index_add_(0, e[:, 0], torch.ones(len(e), dtype=torch.float64, device=v.device))
    has = (cnt > 0)[:, None]
    for _ in range(iterations):
        acc = torch.zeros_like(v).index_add_(0, e[:, 0], v[e[:, 1]])
        mean = torch.where(has, acc / cnt.clamp(min=1)[:, None], v)
        v = v + lam * (mean - v)
    return v.to(torch.float32)


laplacian_smooth_ref.calls = 0

_launch = None  # the library's surfd_mesh_laplacian, bound at the first launch


def _launch_kernel(vertices: torch.Tensor, faces: torch.Tensor, iterations: int,
                   lam: float) -> torch.Tensor:
    """The kernel on the current stream; waits for it only to read the
    flag of out-of-range ids."""
    global _launch
    V, F = len(vertices), len(faces)
    if V >= 2**31 or 3 * F >= 2**31:
        raise ValueError(f"{V} vertices, {F} faces: past the kernel's int32 rows")
    if _launch is None:
        _launch = _build.load().surfd_mesh_laplacian
    vertices, faces = vertices.contiguous(), faces.contiguous()
    i32 = dict(dtype=torch.int32, device=vertices.device)
    out = torch.empty_like(vertices)
    fi, corners = torch.empty(3 * F, **i32), torch.empty(3 * F, **i32)
    cnt, off = torch.empty(V, **i32), torch.empty(V + 1, **i32)
    tile_sums, bad = torch.empty(-(-V // 4096), **i32), torch.empty(1, **i32)
    bufs = torch.empty((2, V, 3), dtype=torch.float64, device=vertices.device)
    stream = torch._C._cuda_getCurrentRawStream(vertices.get_device())
    _build.check(_launch(vertices.data_ptr(), faces.data_ptr(), V, F, iterations, float(lam),
                         out.data_ptr(), fi.data_ptr(), cnt.data_ptr(), off.data_ptr(),
                         tile_sums.data_ptr(), corners.data_ptr(), bufs[0].data_ptr(),
                         bufs[1].data_ptr(), bad.data_ptr(), stream), "mesh_laplacian")
    with _launches_lock:  # the batch generator extracts from several threads
        laplacian_smooth.launches += 1
    if int(bad.item()):
        raise _ids_outside(V)
    return out


def laplacian_smooth(vertices: torch.Tensor, faces: torch.Tensor, iterations: int = 3,
                     lam: float = 0.5) -> torch.Tensor:
    """(V, 3) float32 vertices of the mesh smoothed `iterations` times, as
    `geometry.mesh_ops.laplacian_smooth` gives them; faces (F, 3) int64 on
    the vertices' device. CUDA tensors launch the kernel on the current
    stream (and wait for it); CPU tensors take the plain version. Other
    devices, dtypes or shapes, and vertex ids outside [0, V), raise."""
    _check(vertices, faces, iterations)
    if not vertices.is_cuda:
        if vertices.device.type != "cpu":
            raise ValueError(f"unsupported device {vertices.device}")
        return laplacian_smooth_ref(vertices, faces, iterations, lam)
    if iterations == 0 or len(vertices) == 0:
        return vertices.clone()
    return _launch_kernel(vertices, faces, iterations, lam)


laplacian_smooth.launches = 0  # kernel launches (one a call, whatever the iterations)
_launches_lock = threading.Lock()
