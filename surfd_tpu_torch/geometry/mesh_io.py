"""Minimal OBJ mesh output."""

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
