"""Minimal OBJ mesh input and output, and binary PLY output."""

from __future__ import annotations

import numpy as np

from .marching import Mesh

ROWS = 1 << 20  # lines formatted by one `%` operation


def write_obj(path: str, mesh: Mesh) -> None:
    """The mesh as OBJ text: `v %.8g %.8g %.8g` and 1-based `f %d %d %d`
    lines, the bytes `np.savetxt` writes with those formats, formatted
    ROWS lines at a time instead of savetxt's loop over lines (a 512^3
    mesh has ~19 M lines)."""
    v = np.asarray(mesh.vertices, dtype=np.float64)
    f = np.asarray(mesh.faces, dtype=np.int64) + 1  # OBJ is 1-indexed
    with open(path, "w") as fh:
        fh.write("# surfd_tpu_torch mesh\n")
        for arr, line in ((v, "v %.8g %.8g %.8g\n"), (f, "f %d %d %d\n")):
            for i in range(0, len(arr), ROWS):
                block = arr[i:i + ROWS]
                fh.write((line * len(block)) % tuple(block.ravel().tolist()))


def read_obj(path: str) -> Mesh:
    """The `v` and `f` lines of an OBJ file: vertices f32, faces int64,
    0-based; polygons are split into fans, `f a/b/c` takes the vertex index,
    negative indices count from the end."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, dtype=np.float32)
    f = np.asarray(faces, dtype=np.int64)
    return Mesh(v, np.where(f > 0, f - 1, len(v) + f))


def write_ply(path: str, mesh: Mesh) -> None:
    """The mesh as binary little-endian PLY: float32 x, y, z per vertex and
    a uchar-counted int32 index list per face."""
    v = np.asarray(mesh.vertices, dtype=np.float32)
    f = np.asarray(mesh.faces, dtype=np.int32)
    with open(path, "wb") as fh:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(f)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        fh.write(header.encode())
        fh.write(v.astype("<f4").tobytes())
        counts = np.full((len(f), 1), 3, dtype=np.uint8)
        rows = np.concatenate(
            [counts, f.astype("<i4").view(np.uint8).reshape(len(f), -1)], axis=1
        )
        fh.write(rows.tobytes())
