"""Precompute the CLIP conditioning embeddings (`<id>.context.npy`) of a
sketch or image dataset, next to its npz items. CLIP is frozen, so each
item's embedding is computed once, from

  sketch:  <image_root>/<id>/sketch_<view>.png
  img:     <image_root>/<cat>/<id>/<view-th file>, with the mask
           <mask_root>/<cat>/<view file's stem>.png if it exists
           (composited on white and cropped square around the mask)

Items that already have a `.context.npy` are skipped. On CUDA by default:

  python -m surfd_tpu_torch.cli.encode_contexts --data_root DATA --split train \\
      --image_root IMAGES --mode sketch --clip_npz clip.npz

`--random-init` (a smoke run) draws CLIP's weights from a seeded torch
generator (`Clip.random_init_`), so its embeddings differ from those of the
JAX package's `init_clip()`.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", required=True, help="npz dataset root")
    ap.add_argument("--split", default="train")
    ap.add_argument("--image_root", required=True)
    ap.add_argument("--mask_root", default="", help="img mode: binary masks dir")
    ap.add_argument("--mode", choices=["sketch", "img"], required=True)
    ap.add_argument("--view", type=int, default=0, help="sketch view index / image view")
    ap.add_argument("--clip_npz", default="", help="CLIP weights in the JAX package's npz layout")
    ap.add_argument("--random-init", action="store_true", help="seeded random CLIP (smoke)")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    return ap


def _item_image(args, npz_path: Path):
    """(uint8 image, bool mask or None) of one item, or None when its files
    are missing."""
    from ._common import read_mask, read_rgb

    fid = npz_path.stem
    if args.mode == "sketch":
        path = os.path.join(args.image_root, fid, f"sketch_{args.view}.png")
        if not os.path.exists(path):
            print(f"missing sketch for {fid}: {path}", file=sys.stderr)
            return None
        return read_rgb(path), None
    cat = npz_path.parent.name  # img mode keeps the <cat>/<id> nesting
    views_dir = os.path.join(args.image_root, cat, fid)
    views = sorted(os.listdir(views_dir)) if os.path.isdir(views_dir) else []
    if not views:
        print(f"missing views for {fid}", file=sys.stderr)
        return None
    view = views[min(args.view, len(views) - 1)]
    img = read_rgb(os.path.join(views_dir, view))
    mask_path = os.path.join(args.mask_root, cat, os.path.splitext(view)[0] + ".png")
    if args.mask_root and os.path.exists(mask_path):
        return img, read_mask(mask_path)
    return img, None


def main(argv=None):
    from ..models.clip import Clip
    from ..utils.convert import load_clip_params
    from ..utils.device import resolve_device
    from ._common import print_kernel_calls
    from .generate_image import clip_input

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.clip_npz:
        clip = load_clip_params(args.clip_npz)
    else:
        if not args.random_init:
            print("WARNING: no --clip_npz; using random CLIP weights", file=sys.stderr)
        clip = Clip().random_init_(torch.Generator().manual_seed(0))
    clip = clip.to(device)

    base = Path(args.data_root) / args.split
    items = sorted(base.rglob("*.npz"))
    if not items:
        print(f"no npz items under {base}", file=sys.stderr)
        return []
    written, todo, imgs = [], [], []

    def flush():
        if not todo:
            return
        with torch.no_grad():
            emb = clip.encode_image(torch.from_numpy(np.stack(imgs)).to(device)).cpu().numpy()
        for out_path, e in zip(todo, emb):
            np.save(out_path, e.astype(np.float32))
            print(f"{out_path}", file=sys.stderr)
        written.extend(todo)
        todo.clear()
        imgs.clear()

    for npz_path in items:
        out_path = npz_path.with_suffix(".context.npy")
        if out_path.exists():
            continue
        read = _item_image(args, npz_path)
        if read is None:
            continue
        imgs.append(clip_input(*read))
        todo.append(out_path)
        if len(todo) >= args.batch_size:
            flush()
    flush()
    print_kernel_calls()
    return written


if __name__ == "__main__":
    main()
