"""ctypes bindings for the repo's native C++ geometry runtime (`native/*.cpp`).

The port's own copy of the calls its generation and evaluation paths use:
marching passes (`mt_active_cubes`, `mt_active_cubes_blocks`,
`mt_corner_ranks`, `mt_emit`), the fused u16 block scatter, the face-filter
preps (f32 and u16 points) and fused cleanups, the radix-sorted unique and
the closest-point BVH query. The library is built
from `native/` with the g++ line of `native/build.sh` into
`surfd_tpu_torch/_native/` at first use, and rebuilt when a source is newer.
Host-side only; it does not depend on the framework.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import weakref
from pathlib import Path

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent
_SRC_DIR = _PKG_DIR.parent / "native"
_OUT_DIR = _PKG_DIR / "_native"
_LIB_PATH = _OUT_DIR / "libsurfd_native.so"
_SOURCES = ("closest_point.cpp", "marching.cpp", "mesh_post.cpp")

# Must match surfd_abi_version() in native/marching.cpp: ctypes silently
# drops or truncates mismatched arguments, so a stale library is refused.
_ABI_VERSION = 5

_lock = threading.Lock()
_LIB: ctypes.CDLL | None = None

_fp = ctypes.POINTER(ctypes.c_float)
_ip = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i8p = ctypes.POINTER(ctypes.c_int8)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)


def _needs_rebuild() -> bool:
    if not _LIB_PATH.exists():
        return True
    t = _LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > t for pat in ("*.cpp", "*.h") for p in _SRC_DIR.glob(pat))


def _build() -> None:
    _OUT_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
               "-pthread", "-fopenmp", *_SOURCES, "-o", tmp]
        r = subprocess.run(cmd, cwd=_SRC_DIR, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build failed:\n{r.stderr}")
        os.replace(tmp, _LIB_PATH)  # atomic for concurrent loaders
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    c_f, c_i32, c_i64 = ctypes.c_float, ctypes.c_int32, ctypes.c_int64
    sig = {
        "surfd_free": (None, [ctypes.c_void_p]),
        "surfd_closest_points": (ctypes.c_int, [
            _fp, c_i64, _ip, c_i64, _fp, c_i64, _fp, _fp, _ip]),
        "surfd_unique_inverse_i64": (c_i64, [_i64p, c_i64, ctypes.POINTER(_i64p), _i64p]),
        "surfd_face_filter_prep": (c_i64, [
            _fp, c_i64, _i64p, c_i64, ctypes.POINTER(_fp), ctypes.POINTER(_i64p)]),
        "surfd_face_filter_prep_q16": (c_i64, [
            _fp, c_i64, _i64p, c_i64, c_f, c_f, ctypes.POINTER(_u16p),
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p), ctypes.POINTER(_i64p)]),
        "surfd_mt_emit": (c_i64, [
            _fp, c_i32, c_f, c_f, _i64p, c_i64, _i8p,
            ctypes.POINTER(_fp), _i64p, ctypes.POINTER(_i64p), _i64p]),
        "surfd_finalize_mesh": (None, [
            _fp, c_i64, _i64p, c_i64, _u8p, _i64p,
            c_i32, c_i32, c_f, c_i32, ctypes.POINTER(_fp), _i64p, ctypes.POINTER(_i64p), _i64p]),
        "surfd_finalize_mesh_pre": (None, [
            _fp, c_i64, _i64p, c_i64, _u8p, _i64p, _i64p, _i64p, c_i64,
            c_i32, c_i32, c_f, c_i32, ctypes.POINTER(_fp), _i64p, ctypes.POINTER(_i64p), _i64p]),
        "surfd_mt_active_cubes": (c_i64, [
            _fp, c_i32, c_f, c_f, ctypes.POINTER(_i64p), ctypes.POINTER(_i64p), _i64p]),
        "surfd_mt_active_cubes_blocks": (c_i64, [
            _fp, c_i32, c_f, c_f, _ip, c_i64, c_i32,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p), _i64p]),
        "surfd_mt_corner_ranks": (None, [_i64p, c_i64, _i64p, c_i64, c_i32, _ip]),
        "surfd_scatter_u16_blocks": (None, [
            _fp, c_i32, _ip, c_i64, c_i32, _u16p, c_f, _fp, c_f]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def load() -> ctypes.CDLL:
    """The native library, built first if missing or stale."""
    global _LIB
    with _lock:
        if _LIB is None:
            if _needs_rebuild():
                _build()
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.surfd_abi_version.restype = ctypes.c_int64
            abi = int(lib.surfd_abi_version())
            if abi != _ABI_VERSION:
                raise RuntimeError(f"{_LIB_PATH} ABI {abi} != expected {_ABI_VERSION}")
            _declare(lib)
            _LIB = lib
        return _LIB


def _own(ptr, shape, n_rows):
    """Adopt a C++ malloc'd buffer as a numpy array; freed with its last view."""
    arr = np.ctypeslib.as_array(ptr, shape=shape)
    weakref.finalize(arr, load().surfd_free, ctypes.cast(ptr, ctypes.c_void_p))
    return arr[:n_rows]


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def closest_points(vertices, triangles, queries):
    """Distance, closest point and triangle id of each query on a triangle
    mesh (BVH): ((Q,) f32, (Q, 3) f32, (Q,) int32)."""
    lib = load()
    v, q = _f32(vertices), _f32(queries)
    t = np.ascontiguousarray(triangles, dtype=np.int32)
    for name, a in (("vertices", v), ("triangles", t), ("queries", q)):
        if a.ndim != 2 or a.shape[1] != 3:
            raise ValueError(f"{name} must be (n, 3), got {a.shape}")
    if len(t) and (t.min() < 0 or t.max() >= len(v)):
        raise ValueError("triangle indices out of range")
    out_d = np.empty(len(q), np.float32)
    out_c = np.empty((len(q), 3), np.float32)
    out_t = np.empty(len(q), np.int32)
    rc = lib.surfd_closest_points(
        v.ctypes.data_as(_fp), len(v), t.ctypes.data_as(_ip), len(t), q.ctypes.data_as(_fp),
        len(q), out_d.ctypes.data_as(_fp), out_c.ctypes.data_as(_fp), out_t.ctypes.data_as(_ip),
    )
    if rc != 0:
        raise RuntimeError(f"surfd_closest_points failed with code {rc}")
    return out_d, out_c, out_t


def _udf_grid(udf):
    u = _f32(udf)
    if u.ndim != 3 or not u.shape[0] == u.shape[1] == u.shape[2]:
        raise ValueError(f"udf must be (R, R, R), got {u.shape}")
    return u


def mt_active_cubes(udf, near_thr: float, avg_thr: float):
    """(active-cube ids, sorted distinct active-cube corner gids) in one
    sweep of the whole (R, R, R) grid."""
    lib = load()
    u = _udf_grid(udf)
    out, near, n_near = _i64p(), _i64p(), ctypes.c_int64(0)
    n = lib.surfd_mt_active_cubes(
        u.ctypes.data_as(_fp), u.shape[0], near_thr, avg_thr,
        ctypes.byref(out), ctypes.byref(near), ctypes.byref(n_near),
    )
    nn = int(n_near.value)
    return _own(out, (max(int(n), 1),), int(n)), _own(near, (max(nn, 1),), nn)


def mt_active_cubes_blocks(udf, near_thr: float, avg_thr: float, scan_blocks, block: int):
    """(active-cube ids, sorted distinct active-cube corner gids), visiting
    only cube anchors inside `scan_blocks` ((S, 3) block coords)."""
    lib = load()
    u = _f32(udf)
    sb = np.ascontiguousarray(scan_blocks, dtype=np.int32)
    out, near, n_near = _i64p(), _i64p(), ctypes.c_int64(0)
    n = lib.surfd_mt_active_cubes_blocks(
        u.ctypes.data_as(_fp), u.shape[0], near_thr, avg_thr,
        sb.ctypes.data_as(_ip), len(sb), block,
        ctypes.byref(out), ctypes.byref(near), ctypes.byref(n_near),
    )
    nn = int(n_near.value)
    return _own(out, (max(int(n), 1),), int(n)), _own(near, (max(nn, 1),), nn)


def mt_corner_ranks(near_gids, cube_ids, R: int) -> np.ndarray:
    """searchsorted(near_gids, corner gids of cube_ids) → (M, 8) int32."""
    lib = load()
    near, ids = _i64(near_gids), _i64(cube_ids)
    out = np.empty((len(ids), 8), np.int32)
    lib.surfd_mt_corner_ranks(
        near.ctypes.data_as(_i64p), len(near), ids.ctypes.data_as(_i64p), len(ids), R,
        out.ctypes.data_as(_ip),
    )
    return out


def scatter_u16_blocks(grid, ab, vals, block: int, scale: float, bias=None,
                       clamp_min: float = 0.0) -> None:
    """Write (M, B³) u16 blocks into the (R,R,R) f32 grid in place:
    dequantise by `scale`, subtract the per-block `bias` ((M,) or None),
    clamp at `clamp_min`."""
    lib = load()
    if grid.dtype != np.float32 or not grid.flags.c_contiguous:
        raise ValueError("grid must be a C-contiguous float32 array")
    a = np.ascontiguousarray(ab, dtype=np.int32)
    v = np.ascontiguousarray(vals, dtype=np.uint16)
    if v.size != len(a) * block**3:
        raise ValueError(f"vals has {v.size} values for {len(a)} blocks of {block}^3")
    b = None
    if bias is not None:
        b = _f32(bias)
        if len(b) != len(a):
            raise ValueError("bias must have one value per block")
    lib.surfd_scatter_u16_blocks(
        grid.ctypes.data_as(_fp), grid.shape[0], a.ctypes.data_as(_ip), len(a), block,
        v.ctypes.data_as(_u16p), scale,
        b.ctypes.data_as(_fp) if b is not None else ctypes.cast(None, _fp), clamp_min,
    )


def mt_emit(udf, lo: float, spacing: float, cube_ids, g8):
    """Deduped MT mesh of the active cubes; g8 (M, 8, 3) int8 unit gradients.
    Returns (verts (V,3) f32, faces (F,3) i64)."""
    lib = load()
    u = _f32(udf)
    ids = _i64(cube_ids)
    g = np.ascontiguousarray(g8, dtype=np.int8)
    if g.shape != (len(ids), 8, 3):
        raise ValueError(f"g8 must be ({len(ids)}, 8, 3), got {g.shape}")
    ov, of, nv, nf = _fp(), _i64p(), ctypes.c_int64(), ctypes.c_int64()
    lib.surfd_mt_emit(
        u.ctypes.data_as(_fp), u.shape[0], lo, spacing, ids.ctypes.data_as(_i64p), len(ids),
        g.ctypes.data_as(_i8p), ctypes.byref(ov), ctypes.byref(nv), ctypes.byref(of),
        ctypes.byref(nf),
    )
    V, F = int(nv.value), int(nf.value)
    return _own(ov, (max(V, 1), 3), V), _own(of, (max(F, 1), 3), F)


def _mesh_arrays(vertices, faces):
    v, f = _f32(vertices), _i64(faces)
    if v.ndim != 2 or v.shape[1] != 3:
        raise ValueError(f"vertices must be (V, 3), got {v.shape}")
    if f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"faces must be (F, 3), got {f.shape}")
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("face indices out of range")
    return v, f


def face_filter_prep(vertices, faces):
    """The face filter's f32 query points, vertices then unique-edge
    midpoints, and per-face edge ids: (pts (V+E, 3) f32, einv (F, 3))."""
    lib = load()
    v, f = _mesh_arrays(vertices, faces)
    opts, oeinv = _fp(), _i64p()
    E = int(lib.surfd_face_filter_prep(
        v.ctypes.data_as(_fp), len(v), f.ctypes.data_as(_i64p), len(f),
        ctypes.byref(opts), ctypes.byref(oeinv),
    ))
    n = len(v) + E
    return _own(opts, (max(n, 1), 3), n), _own(oeinv, (max(len(f), 1), 3), len(f))


def face_filter_prep_q16(vertices, faces, qlo: float, qinv: float):
    """Unique-edge midpoints quantised to the 2^16 coords grid, per-face edge
    ids and the edge endpoints: (qmids (E,3) u16, einv (F,3), ea (E,), eb (E,))."""
    lib = load()
    v, f = _f32(vertices), _i64(faces)
    oq, oeinv, oea, oeb = _u16p(), _i64p(), _i64p(), _i64p()
    E = int(lib.surfd_face_filter_prep_q16(
        v.ctypes.data_as(_fp), len(v), f.ctypes.data_as(_i64p), len(f), qlo, qinv,
        ctypes.byref(oq), ctypes.byref(oeinv), ctypes.byref(oea), ctypes.byref(oeb),
    ))
    return (
        _own(oq, (max(E, 1), 3), E),
        _own(oeinv, (max(len(f), 1), 3), len(f)),
        _own(oea, (max(E, 1),), E),
        _own(oeb, (max(E, 1),), E),
    )


def finalize_mesh(vertices, faces, ok, einv, fill_holes: bool = True,
                  smooth_iters: int = 20, lam: float = 0.3, merge_decimals: int = 6):
    """Keep faces whose vertices and edge midpoints pass `ok` (over
    face_filter_prep's points), then fill 3-edge holes, smooth open borders
    and merge duplicate vertices: the numpy chain filter → stabilize →
    smooth_borders → merge_duplicate_vertices of geometry.mesh_ops."""
    lib = load()
    v, f = _mesh_arrays(vertices, faces)
    okc = np.ascontiguousarray(ok, dtype=np.uint8)
    ei = _i64(einv)
    if ei.shape != f.shape:
        raise ValueError(f"einv must be {f.shape}, got {ei.shape}")
    n_pts = len(v) + int(ei.max(initial=-1)) + 1
    if len(f) and len(okc) != n_pts:
        raise ValueError(f"ok has {len(okc)} entries, want {n_pts}")
    ov, of, nv, nf = _fp(), _i64p(), ctypes.c_int64(), ctypes.c_int64()
    lib.surfd_finalize_mesh(
        v.ctypes.data_as(_fp), len(v), f.ctypes.data_as(_i64p), len(f),
        okc.ctypes.data_as(_u8p), ei.ctypes.data_as(_i64p),
        1 if fill_holes else 0, smooth_iters, lam, merge_decimals,
        ctypes.byref(ov), ctypes.byref(nv), ctypes.byref(of), ctypes.byref(nf),
    )
    V, F = int(nv.value), int(nf.value)
    return _own(ov, (max(V, 1), 3), V), _own(of, (max(F, 1), 3), F)


def finalize_mesh_pre(vertices, faces, ok, einv, ea, eb, fill_holes: bool = True,
                      smooth_iters: int = 20, lam: float = 0.3, merge_decimals: int = 6):
    """Keep faces whose vertices and edge midpoints pass `ok`, then fill
    3-edge holes, smooth open borders and merge duplicate vertices, reusing
    the edge structure of face_filter_prep_q16."""
    lib = load()
    v, f = _f32(vertices), _i64(faces)
    okc = np.ascontiguousarray(ok, dtype=np.uint8)
    ei, eac, ebc = _i64(einv), _i64(ea), _i64(eb)
    if len(okc) != len(v) + len(eac):
        raise ValueError(f"ok has {len(okc)} entries, want {len(v) + len(eac)}")
    ov, of, nv, nf = _fp(), _i64p(), ctypes.c_int64(), ctypes.c_int64()
    lib.surfd_finalize_mesh_pre(
        v.ctypes.data_as(_fp), len(v), f.ctypes.data_as(_i64p), len(f),
        okc.ctypes.data_as(_u8p), ei.ctypes.data_as(_i64p),
        eac.ctypes.data_as(_i64p), ebc.ctypes.data_as(_i64p), len(eac),
        1 if fill_holes else 0, smooth_iters, lam, merge_decimals,
        ctypes.byref(ov), ctypes.byref(nv), ctypes.byref(of), ctypes.byref(nf),
    )
    V, F = int(nv.value), int(nf.value)
    return _own(ov, (max(V, 1), 3), V), _own(of, (max(F, 1), 3), F)


def unique_inverse_i64(keys):
    """Sorted unique + inverse of int64 keys (multithreaded radix sort)."""
    lib = load()
    k = _i64(keys)
    inv = np.empty(len(k), np.int64)
    out = _i64p()
    n = int(lib.surfd_unique_inverse_i64(
        k.ctypes.data_as(_i64p), len(k), ctypes.byref(out), inv.ctypes.data_as(_i64p)
    ))
    try:
        uniq = np.ctypeslib.as_array(out, shape=(max(n, 1),))[:n].copy()
    finally:
        lib.surfd_free(out)
    return uniq, inv
