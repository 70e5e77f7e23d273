"""AE reconstruction eval: encode each item's point cloud with the DGCNN
encoder, decode the latent through the UDF pipeline, extract the mesh (open,
or watertight with --watertight), write it as OBJ and score it against the
item's ground truth: exact surface-to-surface metrics (native BVH) when the
item's npz holds `vertices`/`triangles`, else Chamfer, Hausdorff and F-score
between samples of the mesh and of the item's cloud. Writes
recon_items.jsonl (one row per item, appended as each finishes) and
recon_metrics.json (the means, per class and per item). On CUDA by default:

  python -m surfd_tpu_torch.cli.export_meshes --config deepfashion3d \\
      --data_root data --ae_dir runs/ae --output_dir recon/

Weights: `ae_encoder.npz` and `ae_decoder.npz` of the AE run directory, in
the JAX package's flat-key layout. The decoder is 512 wide with 5 blocks,
and the evaluator and the extraction clip the UDF at 0.1, as the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ._common import print_kernel_calls


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="", help="shipped dataset preset "
                    "(deepfashion3d|pix3d|text2shape) or a JSON path")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--split", default="test")
    ap.add_argument("--ae_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--latent_size", type=int, default=32)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--num_points_pcd", type=int, default=10_000)
    ap.add_argument("--watertight", action="store_true")
    ap.add_argument("--chamfer_points", type=int, default=4096)
    ap.add_argument("--limit", type=int, default=0)
    # drop components below this many faces (off by default, as the
    # reference's export harness; its sample scripts use 2500)
    ap.add_argument("--min_component_faces", type=int, default=0)
    # face-filter threshold = mult / resolution
    ap.add_argument("--face_filter_mult", type=float, default=1.0)
    ap.add_argument("--surface_bias", default="auto",
                    help="decoder surface-bias calibration: auto, none, or a float")
    ap.add_argument("--resume", action="store_true",
                    help="skip items whose row is already in output_dir/recon_items.jsonl")
    ap.add_argument("--stall_exit_s", type=float, default=600.0,
                    help="exit 42 if no item completes for this long (a wedged device; "
                    "rerun with --resume). 0 disables")
    ap.add_argument("--device", default="cuda", help="torch device (cuda by default)")
    return ap


def load_models(args, device):
    """(encoder, decoder) from the AE run directory, in eval mode on device."""
    from ..models import CbnDecoder, Dgcnn
    from ..utils.convert import (
        decoder_state_from_flax,
        dgcnn_state_from_flax,
        load_flax_npz,
        strip_prefix,
    )

    encoder = Dgcnn(size_latent=args.latent_size)
    encoder.load_state_dict(dgcnn_state_from_flax(
        load_flax_npz(os.path.join(args.ae_dir, "ae_encoder.npz"))), strict=True)
    decoder = CbnDecoder(args.latent_size, hidden_dim=512, num_hidden_layers=5)
    sd = decoder_state_from_flax(load_flax_npz(os.path.join(args.ae_dir, "ae_decoder.npz")))
    decoder.load_state_dict(strip_prefix(sd, "decoder."), strict=True)
    return encoder.to(device).eval(), decoder.to(device).eval()


def summarize(rows: list) -> dict:
    """recon_metrics.json: means over the items with a mesh, per class (the
    id's prefix before the first '_' and '-') and the rows themselves."""
    full = [r for r in rows if r["faces"]]
    by_class: dict = {}
    for r in full:
        by_class.setdefault(r["id"].split("_")[0].split("-")[0], []).append(r)

    def mean(key, rs):
        return float(np.mean([r[key] for r in rs])) if rs else None

    return {
        "n": len(rows),
        "n_empty": len(rows) - len(full),
        "mean_chamfer": mean("chamfer", full),
        "mean_hausdorff": mean("hausdorff", full),
        "mean_f_score@0.01": mean("f_score@0.01", full),
        "per_class": {
            k: {"n": len(v), "chamfer": mean("chamfer", v), "f_score@0.01": mean("f_score@0.01", v)}
            for k, v in by_class.items()
        },
        "per_item": rows,
    }


def main(argv=None):
    from ..utils.config import apply_preset_defaults

    ap = build_parser()
    apply_preset_defaults(ap, argv)
    args = ap.parse_args(argv)

    from ..data import UdfDataset, random_point_sampling, sample_points_on_mesh
    from ..geometry import write_obj
    from ..geometry.metrics import (
        chamfer_distance,
        f_score,
        hausdorff_distance,
        mesh_surface_metrics,
    )
    from ..pipelines import (
        MeshExtractionConfig,
        get_mesh_from_udf,
        get_watertight_mesh_from_udf,
        make_udf_fn,
    )
    from ..training import StallWatchdog
    from ..utils.device import resolve_device
    from ._common import parse_surface_bias

    device = resolve_device(args.device)  # on CUDA: TF32 off
    rng = np.random.default_rng(0)  # one stream for every draw, in item order
    dataset = UdfDataset(args.data_root, args.split)
    encoder, decoder = load_models(args, device)
    os.makedirs(args.output_dir, exist_ok=True)
    cfg = MeshExtractionConfig(
        resolution=args.resolution,
        min_component_faces=args.min_component_faces,
        face_filter_mult=args.face_filter_mult,
        surface_bias=parse_surface_bias(args.surface_bias),
    )

    # One row per finished item, appended at once, so that a wedged device
    # loses at most one item; --resume skips the ids already recorded (and
    # so draws nothing for them: later items see another rng stream).
    items_path = os.path.join(args.output_dir, "recon_items.jsonl")
    done: dict = {}
    if args.resume and os.path.exists(items_path):
        with open(items_path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    done[r["id"]] = r
        print(f"resume: {len(done)} items already done", file=sys.stderr)
    elif os.path.exists(items_path):
        os.unlink(items_path)

    rows = []
    n_items = min(args.limit, len(dataset)) if args.limit else len(dataset)
    with StallWatchdog(args.stall_exit_s) as wd:
        for i in range(n_items):
            item = dataset[i]
            if item["id"] in done:
                rows.append(done[item["id"]])
                continue
            t = [time.perf_counter()]
            pcd = random_point_sampling(item["pcd"], args.num_points_pcd, rng)
            with torch.no_grad():
                latent = encoder(torch.from_numpy(np.ascontiguousarray(pcd))[None].to(device))[0]
            udf_fn = make_udf_fn(decoder, None, latent, device=device)
            t.append(time.perf_counter())
            if args.watertight:
                mesh = get_watertight_mesh_from_udf(udf_fn, cfg)
            else:
                mesh = get_mesh_from_udf(udf_fn, cfg=cfg)
            t.append(time.perf_counter())
            write_obj(os.path.join(args.output_dir, f"{item['id']}.obj"), mesh)
            t.append(time.perf_counter())
            row = {"id": item["id"], "faces": int(len(mesh.faces))}
            if len(mesh.faces):
                gt_mesh = dataset.mesh(i)
                if gt_mesh is not None:
                    row.update(mesh_surface_metrics(mesh, gt_mesh, n=args.chamfer_points, rng=rng))
                else:
                    recon = sample_points_on_mesh(mesh, args.chamfer_points, rng)
                    gt = random_point_sampling(item["pcd"], args.chamfer_points, rng)
                    row.update({
                        "chamfer": chamfer_distance(recon, gt),
                        "hausdorff": hausdorff_distance(recon, gt),
                        "f_score@0.01": f_score(recon, gt, threshold=0.01),
                    })
                t.append(time.perf_counter())
                print(f"[{i}] {item['id']}: {row['faces']} faces, chamfer {row['chamfer']:.6f}, "
                      f"f@0.01 {row['f_score@0.01']:.3f}; seconds: encode {t[1] - t[0]:.2f}, "
                      f"extract {t[2] - t[1]:.2f}, OBJ {t[3] - t[2]:.2f}, "
                      f"metrics {t[4] - t[3]:.2f}", file=sys.stderr)
            else:
                print(f"[{i}] {item['id']}: EMPTY mesh", file=sys.stderr)
            row = {k: (float(v) if isinstance(v, (np.floating, np.integer)) else v)
                   for k, v in row.items()}
            rows.append(row)
            with open(items_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            wd.tick()

    summary = summarize(rows)
    with open(os.path.join(args.output_dir, "recon_metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    if summary["mean_chamfer"] is not None:
        print(f"mean chamfer: {summary['mean_chamfer']:.6f}  "
              f"mean f@0.01: {summary['mean_f_score@0.01']:.3f}", file=sys.stderr)
    print_kernel_calls()  # the last stderr line
    return summary


if __name__ == "__main__":
    main()
