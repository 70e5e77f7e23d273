"""The AE CLIs on the CPU: `preprocess_udfs` writes the items JAX's CLI
writes; `train_ae --device cpu` (curriculum, the save_dir guard,
`--resume`) writes a run whose npz pair JAX's `load_params_npz` reads
against its `init_ae` template and the port's `export_meshes` and
`train_diffusion --ae_dir` read; without `--device cpu` and no card,
`train_ae` raises.

The decoder is 512 wide with 5 blocks, as `export_meshes` reads it; the
rest is tiny (latent 8, B 2, 128 cloud points, 256 queries)."""

import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.cli import preprocess_udfs as jax_preprocess_cli
from surfd_tpu.training import AETrainConfig as JaxAECfg
from surfd_tpu.training import init_ae as jax_init_ae
from surfd_tpu.utils.checkpoint import load_params_npz
from surfd_tpu_torch.cli import export_meshes, preprocess_udfs, train_ae, train_diffusion
from surfd_tpu_torch.geometry import Mesh, marching_tetrahedra, write_obj
from surfd_tpu_torch.utils import Checkpointer
from surfd_tpu_torch.utils.convert import (
    decoder_state_from_flax,
    dgcnn_state_from_flax,
    strip_prefix,
)

PRE = ["--num_points_pcd", "800", "--counts", "300,300,100", "--num_uniform", "100"]
TRAIN = ["--device", "cpu", "--latent_size", "8", "--batch_size", "2", "--num_points_pcd",
         "128", "--num_points_forward", "256", "--curriculum", "--curriculum_init", "2",
         "--curriculum_add", "1", "--val_every", "1", "--log_interval", "1",
         "--stall_exit_s", "0"]


def _field_mesh(sdf) -> Mesh:
    xs = np.linspace(-1, 1, 24)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    return marching_tetrahedra(sdf(g), iso=0.0)


def _torus(g, R, r):
    return np.hypot(np.hypot(g[..., 0], g[..., 1]) - R, g[..., 2]) - r


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """train/: three spheres and two tori; test/: a sphere and a torus."""
    root = tmp_path_factory.mktemp("ae_meshes")
    shapes = {
        "train": [lambda g, r=r: np.linalg.norm(g, axis=-1) - r for r in (0.4, 0.55, 0.7)]
        + [lambda g, R=R: _torus(g, R, 0.2) for R in (0.5, 0.6)],
        "test": [lambda g: np.linalg.norm(g, axis=-1) - 0.5, lambda g: _torus(g, 0.55, 0.25)],
    }
    for split, fns in shapes.items():
        (root / split).mkdir()
        for i, fn in enumerate(fns):
            write_obj(str(root / split / f"{split}_{i}.obj"), _field_mesh(fn))
    return root


@pytest.fixture(scope="module")
def data(meshes, tmp_path_factory):
    out = tmp_path_factory.mktemp("ae_data")
    for split in ("train", "test"):
        preprocess_udfs.main(["--mesh_root", str(meshes / split), "--out_root", str(out),
                              "--split", split] + PRE)
    return out


def test_preprocess_cli_writes_what_jax_writes(meshes, data, tmp_path, monkeypatch, capsys):
    """Every item of the test split bit-equal to the JAX CLI's; a second run
    skips what is written; the last stderr line is the kernel launches."""
    monkeypatch.setattr(sys, "argv", ["preprocess_udfs", "--mesh_root", str(meshes / "test"),
                                      "--out_root", str(tmp_path), "--split", "test"] + PRE)
    jax_preprocess_cli.main()
    names = sorted(os.listdir(data / "test"))
    assert names == sorted(os.listdir(tmp_path / "test")) == ["test_0.npz", "test_1.npz"]
    for name in names:
        with np.load(data / "test" / name) as a, np.load(tmp_path / "test" / name) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (name, k)
    capsys.readouterr()
    preprocess_udfs.main(["--mesh_root", str(meshes / "test"), "--out_root", str(data),
                          "--split", "test"] + PRE)
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("kernel calls: ")


@pytest.fixture(scope="module")
def run(data, tmp_path_factory):
    """train_ae for 2 epochs, then --resume to 4: the save_dir, each run's
    curriculum and stderr, and the modules after each."""
    save = tmp_path_factory.mktemp("ae_run") / "run"
    argv = TRAIN + ["--data_root", str(data), "--save_dir", str(save)]
    out = {"save": save, "argv": argv}
    state = train_ae.main(argv + ["--num_epochs", "2"])
    out["first"] = {"idx": (save / "training_idxes.txt").read_text().split(),
                    "step": state.step, "model": state.model}
    state = train_ae.main(argv + ["--num_epochs", "4", "--resume"])
    out["second"] = {"idx": (save / "training_idxes.txt").read_text().split(),
                     "step": state.step, "model": state.model}
    return out


def test_train_ae_writes_a_resumable_run(run):
    """args.json, metrics, a checkpoint per run; the curriculum grows by one
    item per epoch (2 → 4, then → 5 and the complement is empty); the
    resumed run continues the step count from its checkpoint."""
    save = run["save"]
    assert {"args.json", "metrics.jsonl", "metrics.csv", "ckpt", "training_idxes.txt",
            "ae_encoder.npz", "ae_decoder.npz"} <= set(os.listdir(save))
    assert json.loads((save / "args.json").read_text())["hidden_dim"] == 512
    assert len(run["first"]["idx"]) == 4 and len(run["second"]["idx"]) == 5
    assert set(run["first"]["idx"]) < set(run["second"]["idx"])
    ck = Checkpointer(str(save / "ckpt"))
    assert ck.all_steps() == [run["first"]["step"], run["second"]["step"]]
    last = ck.read()
    assert last["extra"] == {"epoch": 4} and last["step"] > run["first"]["step"]
    rows = [json.loads(x) for x in (save / "metrics.jsonl").read_text().splitlines()]
    losses = [r for r in rows if "loss" in r]
    assert [r["step"] for r in losses] == list(range(1, last["step"] + 1))
    assert all(np.isfinite(r["loss"]) and r["nonfinite_skipped"] == 0 for r in losses)
    assert [r["curriculum_size"] for r in rows if "curriculum_size" in r] == [3, 4, 5]


def test_train_ae_guards_a_save_dir_with_checkpoints(run):
    with pytest.raises(SystemExit, match="--resume"):
        train_ae.main(run["argv"] + ["--num_epochs", "1"])


def test_npz_pair_loads_in_jax_and_in_the_port(run, data, tmp_path, capsys):
    """JAX's load_params_npz reads both files against init_ae's template,
    equal to the trained modules; train_diffusion's encoder loader reads
    ae_encoder.npz; export_meshes --device cpu reconstructs the test split."""
    save, ae = run["save"], run["second"]["model"]
    _, _, params, stats = jax_init_ae(
        jax.random.PRNGKey(0), JaxAECfg(latent_size=8, hidden_dim=512, num_hidden_layers=5),
        jnp.zeros((1, 128, 3)), jnp.zeros((1, 256, 3)))
    for mod, fname in (("encoder", "ae_encoder.npz"), ("decoder", "ae_decoder.npz")):
        got = load_params_npz(str(save / fname),
                              {"params": params[mod], "batch_stats": stats[mod]})
        if mod == "encoder":
            sd = dgcnn_state_from_flax(jax.tree.map(np.asarray, got))
            want = ae.encoder.state_dict()
        else:
            sd = strip_prefix(decoder_state_from_flax(jax.tree.map(np.asarray, got)), "decoder.")
            want = ae.decoder.state_dict()
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(sd[k], v.float()), (mod, k)
    enc = train_diffusion.load_encoder(SimpleNamespace(latent_size=8, ae_dir=str(save)),
                                       torch.device("cpu"))
    for k, v in ae.encoder.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(enc.state_dict()[k], v), k
    summary = export_meshes.main(["--device", "cpu", "--data_root", str(data), "--ae_dir",
                                  str(save), "--output_dir", str(tmp_path / "recon"),
                                  "--latent_size", "8", "--num_points_pcd", "128",
                                  "--resolution", "32", "--stall_exit_s", "0"])
    assert summary["n"] == 2
    assert capsys.readouterr().err.strip().splitlines()[-1].startswith("kernel calls: ")


def test_train_ae_raises_without_cuda(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ae.main(["--data_root", str(data), "--save_dir", str(tmp_path / "r"),
                       "--num_epochs", "1"])
