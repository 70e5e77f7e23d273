"""Dataset metadata (counterpart of surfd_tpu/data/manifests.py): the garment
class map of the category CLIs and the text2shape captions of text training."""

from __future__ import annotations

import csv


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
