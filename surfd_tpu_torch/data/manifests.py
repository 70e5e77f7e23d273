"""Dataset file discovery and metadata (counterpart of
surfd_tpu/data/manifests.py): the manifests `preprocess_udfs` reads, the
garment class map of the category CLIs and the text2shape captions of text
training.

A manifest is a list of (mesh path, output path relative to the split,
without extension):
  shapenet       — ids from `<synset>_<split>.lst`, meshes
                   `<root>/<synset>/<id>/model.obj`;
  deepfashion3d  — ids from `deepfashion3d_<split>.txt`, meshes `<root>/<id>.obj`;
  pix3d          — `<root>/<split>/<cat>/<id>/model.obj`, kept as `<cat>/<id>`;
  generic        — every `*.obj` under the root, by stem.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path

Manifest = list[tuple[str, str]]

# Public ShapeNet synset ids
SHAPENET_CAT2ID = {
    "chair": "03001627",
    "bench": "02828884",
    "cabinet": "02933112",
    "car": "02958343",
    "airplane": "02691156",
    "display": "03211117",
    "lamp": "03636649",
    "speaker": "03691459",
    "rifle": "04090263",
    "sofa": "04256520",
    "table": "04379243",
    "phone": "04401088",
    "watercraft": "04530566",
}


def shapenet_manifest(data_root: str, category: str, filelists_dir: str, split: str) -> Manifest:
    """A ShapeNet category (name or synset id) from its published .lst file."""
    synset = SHAPENET_CAT2ID.get(category, category)
    with open(Path(filelists_dir) / f"{synset}_{split}.lst") as f:
        sub_ids = [line.strip() for line in f if line.strip()]
    return [(os.path.join(data_root, synset, sid, "model.obj"), f"{synset}/{sid}")
            for sid in sub_ids]


def deepfashion3d_manifest(data_root: str, lists_dir: str, split: str) -> Manifest:
    """DeepFashion3D from its deepfashion3d_{train,test}.txt id lists."""
    with open(Path(lists_dir) / f"deepfashion3d_{split}.txt") as f:
        ids = [line.rstrip("\n") for line in f if line.strip()]
    return [(os.path.join(data_root, f"{i}.obj"), i) for i in ids]


def pix3d_manifest(data_root: str, split: str) -> Manifest:
    """Pix3D by directory walk, sorted; empty when the split is missing."""
    out: Manifest = []
    split_dir = Path(data_root) / split
    if not split_dir.is_dir():
        return out
    for cat in sorted(p for p in split_dir.iterdir() if p.is_dir()):
        for item in sorted(p for p in cat.iterdir() if p.is_dir()):
            model = item / "model.obj"
            if model.exists():
                out.append((str(model), f"{cat.name}/{item.name}"))
    return out


def generic_manifest(mesh_root: str, pattern: str = "*.obj") -> Manifest:
    """Every mesh matching `pattern` under the root, recursively, sorted."""
    return [(str(p), p.stem) for p in sorted(Path(mesh_root).rglob(pattern))]


def build_manifest(dataset: str, data_root: str, split: str, category: str = "",
                   filelists_dir: str = "") -> Manifest:
    """The manifest of `dataset` (shapenet, deepfashion3d, pix3d; anything
    else is generic)."""
    if dataset == "shapenet":
        if not category:
            raise ValueError("shapenet manifests need --category")
        return shapenet_manifest(data_root, category, filelists_dir, split)
    if dataset == "deepfashion3d":
        return deepfashion3d_manifest(data_root, filelists_dir, split)
    if dataset == "pix3d":
        return pix3d_manifest(data_root, split)
    return generic_manifest(data_root)


def load_garment_categories(path: str) -> tuple[dict[str, int], dict[int, str]]:
    """garment_type_list.txt → (item-id prefix → class index, index → name).

    Line i is `name item item ...`; blank lines keep their index but name no
    class.
    """
    id2cat: dict[str, int] = {}
    cat2name: dict[int, str] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            parts = line.strip().split(" ")
            if not parts or not parts[0]:
                continue
            cat2name[i] = parts[0]
            for item in parts[1:]:
                id2cat[item] = i
    return id2cat, cat2name


def category_for_id(item_id: str, id2cat: dict[str, int]) -> int:
    """A DeepFashion3D item's garment class: its id's prefix before '-', else 0."""
    return id2cat.get(item_id.split("-")[0], 0)


def load_text2shape_captions(csv_path: str) -> dict[str, str]:
    """Captions CSV → {model id: caption}: text2shape's 6-column format
    (header `id,modelId,description,...`; the model id is column 2, the
    caption column 3) or plain `id,caption` rows."""
    out: dict[str, str] = {}
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return out
    start = 1 if rows[0] and rows[0][0].lower() in ("id", '"id"') else 0
    for row in rows[start:]:
        if len(row) >= 3:
            out[row[1]] = row[2]
        elif len(row) == 2:
            out[row[0]] = row[1]
    return out
