"""The AutoEncoder's npz-per-item dataset (counterpart of
surfd_tpu/data/datasets.py; so far what the reconstruction eval reads).

An item is one npz file holding `pcd`, `coords`, `labels`, `gradients` and,
when preprocessing kept it, the ground-truth mesh as `vertices` and
`triangles`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def random_point_sampling(points: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """n points along axis -2, drawn without replacement unless n exceeds
    the count."""
    total = points.shape[-2]
    return points[..., rng.choice(total, size=n, replace=n > total), :]


class UdfDataset:
    """Every `*.npz` under `root/split` (or `root` when that is not a
    directory), sorted. Item i is a dict of index, id (the file stem), pcd,
    coords, labels and gradients."""

    def __init__(self, root: str, split: str = "train"):
        self.root = Path(root)
        self.split = split
        base = self.root / split if (self.root / split).is_dir() else self.root
        self.files = sorted(base.glob("*.npz"))
        if not self.files:
            raise FileNotFoundError(f"no npz items under {base}")

    def __len__(self) -> int:
        return len(self.files)

    def item_id(self, i: int) -> str:
        return self.files[i].stem

    def mesh(self, i: int):
        """The item's ground-truth mesh, or None when its npz has none."""
        from ..geometry.marching import Mesh

        with np.load(self.files[i], mmap_mode="r") as z:
            if "vertices" not in z or "triangles" not in z:
                return None
            return Mesh(np.asarray(z["vertices"], np.float32),
                        np.asarray(z["triangles"], np.int32))

    def __getitem__(self, i: int) -> dict:
        with np.load(self.files[i], mmap_mode="r") as z:
            return {
                "index": i,
                "id": self.item_id(i),
                "pcd": np.asarray(z["pcd"], np.float32),
                "coords": np.asarray(z["coords"], np.float32),
                "labels": np.asarray(z["labels"], np.float32),
                "gradients": np.asarray(z["gradients"], np.float32),
            }
