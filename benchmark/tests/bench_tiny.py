"""The benchmark's cells shrunk to sizes a CPU test run can hold: narrow
widths, a few diffusion steps, a 32³ grid, and limits for those sizes. The
kernels run their plain versions on the CPU."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

GEN_CAT = "df3d-gen-ddpm1000-r256"
GEN_TEXT = "t2s-gen-ddim50cfg-r256"
TRAIN_MDM = "df3d-train-mdm-b2"
TRAIN_AE = "df3d-train-ae-b8"
SEED = 2**33 + 17  # more than 32 bits, as the driver's seeds are


def _step_metrics(cell: str, step: str, tag: str) -> tuple:
    """The end-to-end and per-layer metrics of a training cell whose window
    reports `<step>_ms`, with per-layer names ending in `.<tag>`."""
    e2e = [{"name": f"{step}{s}", "unit": "ms", "workloads": [cell]} for s in ("_ms", "_p90_ms")]
    layer = [{"name": f"{n}.{tag}", "unit": u, "moves": f"{step}_ms", "workloads": [cell]}
             for n, u in (("host_launches_per_step", "launches/step"), ("mfu", "%"),
                          ("idle_share", "%"))]
    return e2e, layer


def listed(root: str = ROOT) -> dict:
    """BENCHMARK.json with the cells that PERF.md keeps under Open questions
    listed as the others are (the text-generation cell as the category cell,
    the denoiser's train step with its own metrics), so that their files and
    the drivers' paths they take stay under test."""
    bench = harness.load_json(root, "BENCHMARK.json")
    names = {w["name"] for w in bench["workloads"]}
    if GEN_TEXT not in names:
        bench["configs"].append({"name": "t2s-l64", "file": "benchmark/configs/t2s-l64.json"})
        bench["workloads"].append({"name": GEN_TEXT, "config": "t2s-l64", "chips": 1,
                                   "traffic": "gen-text-ddim50cfg-r256"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if GEN_CAT in m.get("workloads", ()):
                m["workloads"].append(GEN_TEXT)
    if TRAIN_MDM not in names:
        bench["workloads"].append({"name": TRAIN_MDM, "config": "df3d-l32", "chips": 1,
                                   "traffic": "train-mdm-b2"})
        e2e, layer = _step_metrics(TRAIN_MDM, "train_step", "train")
        bench["end_to_end"] += e2e
        bench["per_layer"] += layer
    return bench


def tiny(name: str, root: str = ROOT) -> dict:
    cell = harness.load_cell(name, root, listed(root))
    c, t = cell["config"], cell["traffic"]
    c["denoiser"]["model_channels"] = 32
    c["diffusion"]["diffusion_steps"] = 6
    if "clip" in c:
        c["clip"].update(text_layers=2, text_width=64, embed_dim=64)
        c["denoiser"]["context_dim"] = 64
    if t.get("respacing"):
        t["respacing"] = "ddim3"
    if t["kind"] == "generate":
        # a fixed tier-1 band: the calibration's 131,072-point probe through the
        # plain K1 versions takes tens of seconds on a CPU
        t["extraction"].update(resolution=32, overrides={"two_tier_band": 1.0})
        t["check"].update(mesh_points=2000)
        lim = t["check"]["limits"]
        lim.update({k: v for k, v in (("latent_gap", 1e-4), ("step_gap", 1e-4), ("clip_gap", 1e-4))
                    if k in lim}, field_gap=1e-6, chamfer=0.01, faces_min=5000)
    else:
        t["traced_steps"] = 2
        t["check"]["limits"] = {"loss_gap_first": 1e-5, "grad_gap": 1e-4,
                                "update_gap_median": 0.05}
    if t["kind"] == "train_ae":
        c["ae"].update(hidden_dim=64, num_hidden_layers=1, k=8, num_points_pcd=256,
                       num_points_forward=512)
        t["batch_size"] = 4
        t["corpus"].update(items=8, cloud_points=512, queries=1024)
        # 256-point clouds: near-tied neighbours make the kNN sets differ more
        # often than at 10,000 points
        t["check"]["limits"] = {"loss_gap_first": 1e-4, "grad_gap": 1e-3,
                                "update_gap_median": 0.02}
    return cell
