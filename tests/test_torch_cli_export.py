"""The AE reconstruction eval CLI against the JAX package's, on a two-item
corpus made from the shipped sheet fixture: its decoder as `ae_decoder.npz`,
a Flax Dgcnn whose head is planted (head BatchNorm scale 1e-3, shift the
fixture latent, so that the encoder outputs the fixture latent plus a small
input-dependent term) as `ae_encoder.npz`, and the fixture's 20,000 surface
samples as both items' cloud; one item also carries a ground-truth mesh, so
that both metric paths run. 1000 encoder points, 48³, auto surface bias
(above the resolutions where the two tier-1 filters differ).

Also: --resume reproduces the summary, --config presets set defaults that
explicit flags override, the dataset reads items as JAX's does, and the
stall watchdog exits 42 when silent and 0 when ticking."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import Delaunay

from surfd_tpu.cli import export_meshes as jax_cli
from surfd_tpu.data.datasets import UdfDataset as JaxUdfDataset
from surfd_tpu.geometry.mesh_io import write_obj as jax_write_obj
from surfd_tpu.models.dgcnn import Dgcnn as JaxDgcnn
from surfd_tpu.utils.checkpoint import save_params_npz
from surfd_tpu.utils.config import load_preset as jax_load_preset
from surfd_tpu_torch.cli import _common, export_meshes
from surfd_tpu_torch.data import UdfDataset
from surfd_tpu_torch.geometry import Mesh, mesh_io, write_obj
from surfd_tpu_torch.utils.config import apply_preset_defaults, load_preset

torch.set_num_threads(4)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "surfd_tpu" / "assets" / "bench_sheet_decoder.npz"
FLAGS = ["--num_points_pcd", "1000", "--resolution", "48", "--surface_bias", "auto"]
FACES_TOL = 0.01
# Relative gap allowed in each metric. The rng streams stay in step (numpy
# draws the same count whatever the face count), so the gap comes from the
# meshes alone. Read on this corpus: faces 0 and 1 apart, Chamfer 8e-5,
# Hausdorff 0, F-score 4.3e-3 (one of 4096 samples moves it ~2.4e-4
# absolute), precision 1.1e-3, recall 0.
METRIC_RTOL = {"chamfer": 1e-3, "hausdorff": 1e-3, "f_score@0.01": 2e-2,
               "precision": 2e-2, "recall": 2e-2}


def _gt_mesh(samples: np.ndarray):
    """A mesh through 4000 of the sheet's samples: Delaunay in the sheet's
    principal plane, without the long edges that bridge its outline."""
    pts = samples[np.random.default_rng(0).choice(len(samples), 4000, replace=False)]
    c = pts - pts.mean(0)
    plane = c @ np.linalg.svd(c, full_matrices=False)[2][:2].T
    tri = Delaunay(plane).simplices
    e = np.stack([np.linalg.norm(pts[tri[:, a]] - pts[tri[:, b]], axis=1)
                  for a, b in ((0, 1), (1, 2), (2, 0))], 1)
    return pts.astype(np.float32), tri[e.max(1) < 0.08].astype(np.int32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("recon")
    with np.load(FIXTURE) as z:
        dec = {k[4:]: np.asarray(z[k], np.float32) for k in z.files if k.startswith("dec/")}
        latent = np.asarray(z["latent"], np.float32)
        samples = np.asarray(z["surface_samples"], np.float32)
    ae = base / "ae"
    ae.mkdir()
    np.savez(ae / "ae_decoder.npz", **dec)
    enc = JaxDgcnn(size_latent=len(latent))
    variables = jax.device_get(enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 1000, 3))))
    variables["params"]["head_bn"]["scale"] = np.full(len(latent), 1e-3, np.float32)
    variables["params"]["head_bn"]["bias"] = latent
    save_params_npz(str(ae / "ae_encoder.npz"), variables)
    data = base / "data" / "test"
    data.mkdir(parents=True)
    small = {"coords": np.zeros((8, 3), np.float32), "labels": np.zeros(8, np.float32),
             "gradients": np.zeros((8, 3), np.float32)}
    np.savez(data / "dress_000.npz", pcd=samples, **small)
    v, f = _gt_mesh(samples)
    np.savez(data / "skirt_001.npz", pcd=samples, vertices=v, triangles=f, **small)
    return base


def _argv(corpus, out):
    return ["--data_root", str(corpus / "data"), "--ae_dir", str(corpus / "ae"),
            "--output_dir", str(out), *FLAGS]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """recon_metrics.json of the JAX CLI and of the port's (CPU), and the
    port's output directory."""
    out_j, out_t = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    mp = pytest.MonkeyPatch()
    mp.setattr(sys, "argv", ["export_meshes", *_argv(corpus, out_j)])
    try:
        jax_cli.main()
    finally:
        mp.undo()
    # a stale row from an earlier run: without --resume it is dropped
    (out_t / "recon_items.jsonl").write_text(json.dumps({"id": "stale", "faces": 0}) + "\n")
    export_meshes.main([*_argv(corpus, out_t), "--device", "cpu"])
    load = lambda d: json.loads((d / "recon_metrics.json").read_text())
    return load(out_j), load(out_t), out_t


def test_cli_rows_match_jax(runs):
    want, got, out = runs
    assert list(got) == list(want)
    assert (got["n"], got["n_empty"]) == (want["n"], want["n_empty"]) == (2, 0)
    assert set(got["per_class"]) == set(want["per_class"]) == {"dress", "skirt"}
    for g, w in zip(got["per_item"], want["per_item"]):
        assert list(g) == list(w) and g["id"] == w["id"]
        assert abs(g["faces"] - w["faces"]) <= FACES_TOL * w["faces"], (g, w)
        for k, rtol in METRIC_RTOL.items():
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=rtol), (k, g, w)
        assert (out / f"{g['id']}.obj").read_text().startswith("# surfd_tpu_torch mesh")
    gt_row, sample_row = got["per_item"][1], got["per_item"][0]
    assert "precision" in gt_row and "precision" not in sample_row  # both metric paths ran
    assert sample_row["chamfer"] < 0.008  # the JAX package's fixture bar


def test_cli_resume_reproduces_summary(runs, corpus, capsys):
    _, got, out = runs
    rows = (out / "recon_items.jsonl").read_text().splitlines()
    assert [json.loads(r)["id"] for r in rows] == ["dress_000", "skirt_001"]
    capsys.readouterr()
    again = export_meshes.main([*_argv(corpus, out), "--device", "cpu", "--resume"])
    assert again == got
    # the last stderr line reports the decoder kernel's launches: none on the CPU
    last = capsys.readouterr().err.strip().splitlines()[-1]
    assert last.startswith(_common.KERNEL_CALLS)
    assert json.loads(last.removeprefix(_common.KERNEL_CALLS))["launches"] == {
        "folded_mlp_f32": 0, "folded_mlp_bf16": 0}
    assert json.loads((out / "recon_metrics.json").read_text()) == got
    # --resume with --limit 1 keeps the first row only
    assert export_meshes.main([*_argv(corpus, out), "--device", "cpu", "--resume",
                               "--limit", "1"])["per_item"] == got["per_item"][:1]


def test_cli_raises_without_cuda(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        export_meshes.main(_argv(corpus, tmp_path))  # CUDA unless --device says otherwise
    assert not (tmp_path / "recon_items.jsonl").exists()


def test_config_presets(corpus):
    for name in ("deepfashion3d", "pix3d", "text2shape"):
        assert load_preset(name) == jax_load_preset(name)
    req = ["--data_root", "d", "--ae_dir", "a", "--output_dir", "o"]
    for argv, want in (
        ([*req], (256, 10_000, 32, False)),
        (["--config", "deepfashion3d", *req], (512, 10_000, 32, False)),
        (["--config", "text2shape", *req, "--resolution", "48"], (48, 10_000, 64, True)),
    ):
        ap = export_meshes.build_parser()
        apply_preset_defaults(ap, argv)
        a = ap.parse_args(argv)
        assert (a.resolution, a.num_points_pcd, a.latent_size, a.watertight) == want
    with pytest.raises(FileNotFoundError, match="no preset"):
        load_preset("nope")


def test_dataset_matches_jax(corpus):
    ds, js = UdfDataset(str(corpus / "data"), "test"), JaxUdfDataset(str(corpus / "data"), "test")
    assert len(ds) == len(js) == 2
    for i in range(2):
        a, b = ds[i], js[i]
        assert list(a) == list(b) and a["id"] == b["id"]
        for k in ("pcd", "coords", "labels", "gradients"):
            np.testing.assert_array_equal(a[k], b[k])
    assert ds.mesh(0) is None and js.mesh(0) is None
    for x, y in zip(ds.mesh(1), js.mesh(1)):
        np.testing.assert_array_equal(x, y)


def test_write_obj_matches_jax(tmp_path, monkeypatch):
    """The chunked OBJ writer writes JAX's (np.savetxt's) lines byte for byte."""
    monkeypatch.setattr(mesh_io, "ROWS", 256)  # several chunks and a partial one
    rng = np.random.default_rng(12)
    mesh = Mesh(rng.normal(size=(1001, 3)).astype(np.float32) * np.float32(1e3) ** rng.uniform(
        -2, 1, (1001, 1)).astype(np.float32), rng.integers(0, 1001, (2003, 3)))
    write_obj(str(tmp_path / "port.obj"), mesh)
    jax_write_obj(str(tmp_path / "jax.obj"), mesh)
    got = (tmp_path / "port.obj").read_text().splitlines()
    want = (tmp_path / "jax.obj").read_text().splitlines()
    assert got[0] == "# surfd_tpu_torch mesh" and got[1:] == want[1:] and len(got) == 1 + 1001 + 2003
    write_obj(str(tmp_path / "empty.obj"), Mesh(np.zeros((0, 3), np.float32),
                                                np.zeros((0, 3), np.int64)))
    assert (tmp_path / "empty.obj").read_text() == "# surfd_tpu_torch mesh\n"


_WATCHDOG = """
import sys, time
from surfd_tpu_torch.training import StallWatchdog
with StallWatchdog(timeout_s=1.0, first_grace_s=0.5) as wd:
    if sys.argv[1] == "ticking":
        for _ in range(8):
            time.sleep(0.2)
            wd.tick()
        sys.exit(0)
    wd.tick()       # one step completes...
    time.sleep(30)  # ...then the device wedges
    sys.exit(0)     # never reached
"""


@pytest.mark.parametrize("mode,code", [("ticking", 0), ("wedged", 42)])
def test_stall_watchdog_exit_code(mode, code):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", _WATCHDOG, mode], env=env, timeout=120,
                       capture_output=True, text=True)
    assert r.returncode == code, r.stderr
