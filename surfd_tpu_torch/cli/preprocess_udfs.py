"""UDF preprocessing: meshes → npz training items (counterpart of
surfd_tpu/cli/preprocess_udfs.py). Host work: numpy and the native BVH,
no device. Each mesh is read (OBJ), normalised (`--normalize`, `unit` by
default), sampled and written as `<out_root>/<split>/<id>.npz`; items
already written are skipped. The last stderr line is the process's kernel
launches (`kernel calls: {...}`, none here), as every CLI of the port prints.

  generic        python -m surfd_tpu_torch.cli.preprocess_udfs --mesh_root MESHES \\
                     --out_root DATA --split train
  shapenet       ... --dataset shapenet --category chair --filelists LSTS
  deepfashion3d  ... --dataset deepfashion3d --filelists LSTS
  pix3d          ... --dataset pix3d
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh_root", required=True)
    ap.add_argument("--out_root", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--dataset", default="generic",
                    choices=["generic", "shapenet", "deepfashion3d", "pix3d"])
    ap.add_argument("--category", default="", help="shapenet category name or synset id")
    ap.add_argument("--filelists", default="", help="dir with the published id lists")
    ap.add_argument("--num_points_pcd", type=int, default=100_000)
    ap.add_argument("--counts", default="",
                    help="comma-separated per-std query counts (default 250000,200000,25000)")
    ap.add_argument("--num_uniform", type=int, default=0, help="0 = default 25000")
    ap.add_argument("--max_dist", type=float, default=0.1)
    ap.add_argument("--normalize", default="unit", choices=["none", "center", "box_center", "unit"])
    ap.add_argument("--limit", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data.manifests import build_manifest
    from ..data.preprocess import PreprocessConfig, normalize_mesh, prepare_udf_sample
    from ..geometry import read_obj
    from ._common import print_kernel_calls

    kw = {}
    if args.counts:
        kw["counts"] = tuple(int(c) for c in args.counts.split(","))
    if args.num_uniform:
        kw["num_uniform"] = args.num_uniform
    cfg = PreprocessConfig(num_points_pcd=args.num_points_pcd, max_dist=args.max_dist, **kw)
    out_base = Path(args.out_root) / args.split
    manifest = build_manifest(args.dataset, args.mesh_root, args.split,
                              category=args.category, filelists_dir=args.filelists)
    if args.limit:
        manifest = manifest[: args.limit]
    if not manifest:
        print("empty manifest: nothing to do", file=sys.stderr)
    for i, (mesh_path, rel) in enumerate(manifest):
        out = out_base / f"{rel}.npz"
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        mesh = read_obj(mesh_path)
        if args.normalize != "none":
            mesh = normalize_mesh(mesh, args.normalize)
        np.savez(out, **prepare_udf_sample(mesh, cfg))
        print(f"[{i + 1}/{len(manifest)}] {mesh_path} -> {out}", file=sys.stderr)
    print_kernel_calls()


if __name__ == "__main__":
    main()
