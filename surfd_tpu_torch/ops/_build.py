"""Build and load the port's hand-written CUDA kernels.

Every `ops/csrc/*.cu` is compiled by its own `nvcc` for `sm_90a` (all started
together), then the objects are linked into one shared library with a plain C
interface under `surfd_tpu_torch/_kernels/`, loaded with ctypes. The build
runs at first use and again whenever a source is newer than the library.

No `--use_fast_math`: the decoder's positional encoding evaluates sin/cos at
arguments up to 512 rad, where the fast intrinsics lose the result.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
OUT_DIR = _PKG / "_kernels"
LIB_PATH = OUT_DIR / "libsurfd_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    t = LIB_PATH.stat().st_mtime
    deps = _sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > t for p in deps)


def build(verbose: bool = False) -> str:
    """Compile every source in parallel and link the library; returns the
    compilers' combined output (register and shared-memory use with verbose)."""
    nvcc = _nvcc()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        log = []
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_PATH.name
        link = [nvcc, *ARCH, "-shared", "-Xcompiler", "-fPIC",
                *(str(o) for _, o, _ in procs), "-o", str(tmp_lib)]
        r = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + r.stdout)
        os.replace(tmp_lib, LIB_PATH)  # atomic: concurrent loaders see old or new
    return "\n".join(log)


def load() -> ctypes.CDLL:
    """The kernels' library, built first if missing or stale. Once loaded it
    is returned without taking the lock: this sits on every launch's path."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
            for name in ("surfd_folded_mlp_f32", "surfd_folded_mlp_bf16"):
                fn = getattr(lib, name)
                fn.restype = i32
                # pts, P, H, L, 13 weight pointers, b_out, max_dist, out, stream
                fn.argtypes = [vp, i64, i32, i32] + [vp] * 13 + [f32, f32, vp, vp]
            lib.surfd_qkv_attention.restype = i32
            # qkv, out, B, T, H, C, scale, qkv's and out's (batch, token, channel) strides, stream
            lib.surfd_qkv_attention.argtypes = [vp, vp, i32, i32, i32, i32, f32] + [i64] * 6 + [vp]
            lib.surfd_qkv_attention_bwd.restype = i32
            # qkv, dO, dqkv, B, T, H, C, scale, the three tensors' strides, stream
            lib.surfd_qkv_attention_bwd.argtypes = ([vp, vp, vp, i32, i32, i32, i32, f32]
                                                    + [i64] * 9 + [vp])
            lib.surfd_conv1d_stream.restype = i32
            # x, weight, bias, residual, out, B, Cin, Lin, Cout, Lout, K, stride,
            # padding, the plan (tm, lm, wr, splits, kc), vec, stream
            lib.surfd_conv1d_stream.argtypes = [vp] * 5 + [i32] * 14 + [vp]
            lib.surfd_mesh_laplacian.restype = i32
            # vertices, faces, V, F, iterations, lam, out, fi, cnt, off, tile_sums,
            # corners, buf0, buf1, bad, stream
            lib.surfd_mesh_laplacian.argtypes = ([vp, vp, i64, i64, i32, ctypes.c_double]
                                                 + [vp] * 10)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {rc}")
