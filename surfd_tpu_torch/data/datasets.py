"""UDF datasets and the AE and diffusion batch iterators (counterpart of
surfd_tpu/data/datasets.py; numpy, drawing what the JAX package's draw from
the same `default_rng`).

An item is one npz file holding `pcd`, `coords`, `labels`, `gradients` and,
when preprocessing kept it, the ground-truth mesh as `vertices` and
`triangles`. Diffusion items add a conditioning payload: a caption (text),
a class id (category) or a 512-d context from `<id>.context.npy` (sketch,
img). Batches are numpy; the trainer moves them to the device.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def random_rotation_matrix(rng: np.random.Generator) -> np.ndarray:
    """A uniform random rotation of SO(3), (3, 3) f32, from a normalised
    normal quaternion (Shoemake)."""
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def random_point_sampling(points: np.ndarray, n: int, rng: np.random.Generator,
                          inds: Optional[np.ndarray] = None) -> np.ndarray:
    """n points along axis -2, drawn without replacement unless n exceeds
    the count; `inds` replays given indices instead (no draw)."""
    if inds is None:
        total = points.shape[-2]
        inds = rng.choice(total, size=n, replace=n > total)
    return points[..., inds, :]


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


class DiffusionDataset(UdfDataset):
    """UdfDataset plus each item's conditioning payload:
      text     — its caption (`captions_csv`, text2shape's or id,caption);
      category — its class id from `category_map` (the id, else the prefix
                 before '-', else 0);
      sketch / img — its 512-d `<id>.context.npy` beside the npz (zeros when
                 missing), precomputed by `encode_contexts`.
    """

    def __init__(self, root: str, split: str = "train", cond_mode: str = "no_cond",
                 captions_csv: Optional[str] = None,
                 category_map: Optional[Dict[str, int]] = None):
        super().__init__(root, split)
        self.cond_mode = cond_mode
        self.captions: Dict[str, str] = {}
        if captions_csv:
            from .manifests import load_text2shape_captions

            self.captions = load_text2shape_captions(captions_csv)
        self.category_map = category_map or {}

    def __getitem__(self, i: int) -> dict:
        return self._attach_cond(super().__getitem__(i), i)

    def cond_item(self, i: int) -> dict:
        """Index, id and the conditioning payload, without reading the arrays."""
        return self._attach_cond({"index": i, "id": self.item_id(i)}, i)

    def _attach_cond(self, item: dict, i: int) -> dict:
        fid = item["id"]
        if self.cond_mode == "text":
            item["text"] = self.captions.get(fid, "")
        elif self.cond_mode == "category":
            cat = self.category_map.get(fid)
            if cat is None:
                cat = self.category_map.get(fid.split("-")[0], 0)
            item["action"] = np.int32(cat)
        elif self.cond_mode in ("sketch", "img"):
            ctx_path = self.files[i].with_suffix(".context.npy")
            item["context"] = (np.asarray(np.load(ctx_path), np.float32) if ctx_path.exists()
                               else np.zeros(512, np.float32))
        return item


def _conditioning_payload(dataset: DiffusionDataset, items, encode_text) -> dict:
    """The batch's conditioning: 'context' (B, 512) from `encode_text` of the
    captions (else the captions as 'texts'), 'action' (B,), or the items'
    contexts."""
    out: dict = {}
    if dataset.cond_mode == "text":
        texts = [it["text"] for it in items]
        if encode_text is not None:
            out["context"] = encode_text(texts)
        else:
            out["texts"] = texts
    elif dataset.cond_mode == "category":
        out["action"] = np.asarray([it["action"] for it in items], np.int32)
    elif dataset.cond_mode in ("sketch", "img"):
        out["context"] = np.stack([it["context"] for it in items])
    return out


def ae_batch_iterator(dataset: UdfDataset, indices_iter_factory: Callable[[], Sequence[int]],
                      batch_size: int, num_points_pcd: int, num_points_forward: int,
                      rng: np.random.Generator, augment_rotations: bool = False):
    """Endless AE batches over passes of `indices_iter_factory()` (the
    curriculum's sampler, read anew at each pass), the tail short of a batch
    dropped: per item, `num_points_pcd` of its cloud and `num_points_forward`
    of its queries with their UDF labels and gradients. Each batch holds
    'pcd', 'coords', 'udf', 'gradients' and 'indices'.

    `augment_rotations` turns each item's cloud, queries and gradients by one
    fresh uniform rotation (the labels are invariant). A pass of fewer
    indices than `batch_size` raises ValueError: it would yield nothing, and
    the JAX package's iterator loops on it for ever. The JAX signature's
    unused `max_dist` is left out.
    """
    from .curriculum import batched

    while True:
        indices = list(indices_iter_factory())
        if len(indices) < batch_size:
            raise ValueError(f"{len(indices)} items to draw from, fewer than the batch of "
                             f"{batch_size}: no batch can be made (raise the curriculum's "
                             "initial size or lower the batch)")
        for idx_batch in batched(iter(indices), batch_size, drop_last=True):
            pcds, coords, udfs, grads = [], [], [], []
            for i in idx_batch:
                item = dataset[i]
                pcd = random_point_sampling(item["pcd"], num_points_pcd, rng)
                cug = np.concatenate(
                    [item["coords"], item["labels"][:, None], item["gradients"]], axis=-1)
                sel = random_point_sampling(cug, num_points_forward, rng)
                c, g = sel[:, :3], sel[:, 4:]
                if augment_rotations:
                    rt = random_rotation_matrix(rng).T
                    pcd, c, g = pcd @ rt, c @ rt, g @ rt
                pcds.append(pcd)
                coords.append(c)
                udfs.append(sel[:, 3])
                grads.append(g)
            yield {
                "pcd": np.stack(pcds),
                "coords": np.stack(coords),
                "udf": np.stack(udfs),
                "gradients": np.stack(grads),
                "indices": np.asarray(idx_batch, np.int32),
            }


def diffusion_batch_iterator(dataset: DiffusionDataset, batch_size: int, num_points_pcd: int,
                             rng: np.random.Generator,
                             encode_text: Optional[Callable[[List[str]], np.ndarray]] = None,
                             shuffle: bool = True):
    """Endless batches: per epoch a permutation of the items (the tail short
    of a batch dropped), each item's pcd subsampled to `num_points_pcd`,
    plus the conditioning payload."""
    n = len(dataset)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - batch_size + 1, batch_size):
            items = [dataset[int(i)] for i in order[s: s + batch_size]]
            batch = {"pcd": np.stack([random_point_sampling(it["pcd"], num_points_pcd, rng)
                                      for it in items])}
            batch.update(_conditioning_payload(dataset, items, encode_text))
            yield batch


def precompute_latents(dataset: UdfDataset, encode: Callable[[np.ndarray], np.ndarray],
                       num_points_pcd: int, rng: np.random.Generator, encode_batch: int = 8,
                       cache_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """{item id: (L,) f32 latent}: each item's cloud subsampled once and
    encoded once by the frozen encoder, in chunks of `encode_batch` (the last
    padded with copies of its last cloud). `cache_path` (.npz) keeps them
    across runs, keyed by the item ids and num_points_pcd."""
    ids = [dataset.item_id(i) for i in range(len(dataset))]
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path, allow_pickle=False) as z:
            if int(z["num_points_pcd"]) == num_points_pcd and [str(s) for s in z["ids"]] == ids:
                return dict(zip(ids, np.asarray(z["latents"], np.float32)))
    n = len(dataset)
    chunks = []
    for s in range(0, n, encode_batch):
        idx = range(s, min(s + encode_batch, n))
        pcds = np.stack([random_point_sampling(dataset[i]["pcd"], num_points_pcd, rng)
                         for i in idx])
        pad = encode_batch - len(pcds)
        if pad:
            pcds = np.concatenate([pcds, np.repeat(pcds[-1:], pad, axis=0)])
        chunks.append(np.asarray(encode(pcds))[: len(idx)])
    latents = np.concatenate(chunks).astype(np.float32)
    if cache_path:
        np.savez(cache_path, ids=np.asarray(ids), latents=latents, num_points_pcd=num_points_pcd)
    return dict(zip(ids, latents))


def latent_diffusion_batch_iterator(dataset: DiffusionDataset, latents: Dict[str, np.ndarray],
                                    batch_size: int, rng: np.random.Generator,
                                    encode_text: Optional[Callable[[List[str]], np.ndarray]] = None,
                                    shuffle: bool = True):
    """Endless batches of precomputed latents, 'latents' (B, L), plus the
    conditioning payload; the same epoch permutations as
    diffusion_batch_iterator, and no item arrays read."""
    n = len(dataset)
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(0, n - batch_size + 1, batch_size):
            items = [dataset.cond_item(int(i)) for i in order[s: s + batch_size]]
            batch = {"latents": np.stack([latents[it["id"]] for it in items])}
            batch.update(_conditioning_payload(dataset, items, encode_text))
            yield batch
