"""Dataset manifests (counterpart of surfd_tpu/data/manifests.py): so far
only the garment class map that the category CLI reads."""

from __future__ import annotations


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
