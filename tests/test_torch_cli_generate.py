"""The generation CLIs: merging the run directories' args.json (overlay,
explicit flags first, the max_dist rule against the JAX package's, a
missing file), --num_actions auto, the garment class map against the JAX
package's reader, and both CLIs run in-process on the CPU at tiny widths
(DDIM and PLMS, watertight, two extractions at a time, a category by name,
by id and from a class-map file), each writing its OBJs."""

import argparse
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.cli import _common as jcommon
from surfd_tpu.data.manifests import load_garment_categories as jax_load_categories
from surfd_tpu.pipelines import make_udf_fn as jax_make_udf_fn
from surfd_tpu.utils.checkpoint import save_params_npz
from surfd_tpu_torch.cli import _common, generate_cat, generate_uncond
from surfd_tpu_torch.data import load_garment_categories
from surfd_tpu_torch.pipelines import make_udf_fn
from test_torch_pipeline import HIDDEN, LATENT, LAYERS, decoders  # noqa: F401

TINY = ["--device", "cpu", "--random-init", "--resolution", "32", "--timestep_respacing", "4",
        "--latent_size", "8", "--model_channels", "16", "--decoder_hidden", "64",
        "--decoder_layers", "1"]
CLASSES = "shirt a1 a2\nskirt b1\n\ncoat c1 c2 c3\n"  # a blank line keeps its index


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _args(argv):
    return _common.base_parser("test").parse_args(argv)


def test_merge_overlays_saved_args(tmp_path):
    run = tmp_path / "diff"
    run.mkdir()
    _write(run / "args.json", json.dumps({"latent_size": 16, "model_channels": 64,
                                          "num_actions": 5, "noise_schedule": "linear",
                                          "diffusion_steps": 500, "lr": 1e-4}))
    ae = tmp_path / "ae"
    ae.mkdir()
    _write(ae / "args.json", json.dumps({"hidden_dim": 128, "num_hidden_layers": 3,
                                         "max_dist": 0.2}))
    pt = _write(run / "model.pt", "")
    for mp in (str(run), pt):  # the run dir, or a .pt file inside it
        argv = ["--model_path", mp, "--ae_dir", str(ae)]
        a = _common.merge_saved_args(_args(argv), argv)
        assert (a.latent_size, a.model_channels, a.num_actions, a.noise_schedule,
                a.diffusion_steps) == (16, 64, 5, "linear", 500)
        assert (a.decoder_hidden, a.decoder_layers, a.max_dist) == (128, 3, 0.2)
        assert not hasattr(a, "lr")


@pytest.mark.parametrize("form", ["--x=v", "--x v"])
def test_merge_explicit_flags_win(tmp_path, form):
    _write(tmp_path / "args.json", json.dumps({"latent_size": 16, "hidden_dim": 128,
                                               "max_dist": 0.2}))
    flags = {"latent_size": "24", "decoder_hidden": "256", "max_dist": "0.3"}
    argv = ["--ae_dir", str(tmp_path)]
    for k, v in flags.items():
        argv += [f"--{k}={v}"] if form == "--x=v" else [f"--{k}", v]
    a = _common.merge_saved_args(_args(argv), argv)
    assert (a.latent_size, a.decoder_hidden, a.max_dist) == (24, 256, 0.3)
    assert _common._explicit_cli_keys(["--random-init", "--seed=3", "5"]) == {"random_init", "seed"}


def test_merge_without_args_json(tmp_path):
    argv = ["--ae_dir", str(tmp_path), "--model_path", str(tmp_path / "missing.pt")]
    a = _common.merge_saved_args(_args(argv), argv)
    assert vars(a) == vars(_args(argv))


def _ae_dir(tmp_path, fvars, max_dist):
    ae = tmp_path / f"ae_{max_dist}"
    ae.mkdir()
    save_params_npz(str(ae / "ae_decoder.npz"), fvars)
    _write(ae / "args.json", json.dumps({"latent_size": LATENT, "hidden_dim": HIDDEN,
                                         "num_hidden_layers": LAYERS, "max_dist": max_dist}))
    return str(ae)


@pytest.mark.parametrize("saved", [0.1, 0.2])
def test_max_dist_rule(tmp_path, decoders, saved):
    """Both packages read the AE's max_dist for the extraction. The JAX
    package's evaluator keeps make_udf_fn's 0.1; the port's takes the same
    value as its extraction. So at 0.1, the only value on record, the two
    evaluators agree; at 0.2 the port's is JAX's make_udf_fn at 0.2."""
    torch.set_num_threads(1)
    _, _, fvars = decoders
    ae = _ae_dir(tmp_path, fvars, saved)
    jargs = argparse.Namespace(model_path="", ae_dir=ae, latent_size=32, decoder_hidden=512,
                               decoder_layers=5, random_init=False)
    jcommon.merge_saved_args(jargs, [])
    jdec, jvars = jcommon.load_decoder(jargs)
    argv = ["--ae_dir", ae, "--device", "cpu"]
    args = _common.merge_saved_args(_args(argv), argv)
    assert args.max_dist == jargs.ae_max_dist == saved  # the extraction's value
    dec = _common.load_decoder(args, "cpu")
    lat = (np.random.default_rng(3).normal(size=(LATENT,)) * 0.5).astype(np.float32)
    pts = np.random.default_rng(4).uniform(-1, 1, (4096, 3)).astype(np.float32)
    got = make_udf_fn(dec, None, lat, args.max_dist, device="cpu")(torch.from_numpy(pts)).numpy()
    want = np.asarray(jax_make_udf_fn(jdec, jvars, jnp.asarray(lat), max_dist=saved)(pts))
    np.testing.assert_allclose(got, want, atol=1e-5 * saved)
    jax_cli = np.asarray(jax_make_udf_fn(jdec, jvars, jnp.asarray(lat))(pts))  # as its CLI binds it
    if saved == 0.1:
        np.testing.assert_allclose(got, jax_cli, atol=1e-6)
    else:
        assert np.abs(got - jax_cli).max() > 1e-3


def test_num_actions_auto():
    assert _common.load_denoiser(_args(TINY), "category", "cpu").num_actions == 9
    assert _common.load_denoiser(_args(TINY + ["--num_actions", "4"]), "category",
                                 "cpu").num_actions == 4


def test_garment_categories_match_jax(tmp_path):
    path = _write(tmp_path / "garment_type_list.txt", CLASSES)
    assert load_garment_categories(path) == jax_load_categories(path)
    id2cat, cat2name = load_garment_categories(path)
    assert cat2name == {0: "shirt", 1: "skirt", 3: "coat"} and id2cat["c2"] == 3


def _objs(out):
    files = sorted(os.listdir(out))
    assert files and all(f.endswith(".obj") and os.path.getsize(out / f) > 0 for f in files)
    return files


@pytest.mark.parametrize("extra,files", [
    (["--sampler", "ddim", "--guidance_param", "2.5", "--category", "long-skirt",
      "--num_samples", "2", "--pipeline_depth", "2"], ["cat4_0.obj", "cat4_1.obj"]),
    (["--sampler", "plms", "--category", "7", "--watertight", "--num_samples", "1"],
     ["cat7_0.obj"]),
    (["--category", "skirt", "--category_list", "LIST", "--num_samples", "1"], ["cat1_0.obj"]),
])
def test_generate_cat_in_process(tmp_path, extra, files):
    torch.set_num_threads(1)
    extra = [_write(tmp_path / "list.txt", CLASSES) if a == "LIST" else a for a in extra]
    out = tmp_path / "out"
    paths = generate_cat.main(TINY + extra + ["--output_dir", str(out)])
    assert _objs(out) == files and len(paths) == len(files)


def test_generate_cat_rejects_unknown_category(tmp_path):
    with pytest.raises(SystemExit):
        generate_cat.main(TINY + ["--category", "hat", "--output_dir", str(tmp_path)])
    with pytest.raises(ValueError, match=r"category ids must be in \[0, 9\)"):
        generate_cat.main(TINY + ["--category", "9", "--output_dir", str(tmp_path)])
    # --num_actions 0 with a class map: its three classes
    lst = _write(tmp_path / "list.txt", CLASSES)
    with pytest.raises(ValueError, match=r"category ids must be in \[0, 3\)"):
        generate_cat.main(TINY + ["--category", "3", "--category_list", lst,
                                  "--output_dir", str(tmp_path)])


@pytest.mark.parametrize("extra", [
    ["--sampler", "plms", "--watertight", "--num_samples", "1"],
    ["--sampler", "ddim", "--num_samples", "2", "--pipeline_depth", "2"],
])
def test_generate_uncond_in_process(tmp_path, extra):
    torch.set_num_threads(1)
    out = tmp_path / "out"
    paths = generate_uncond.main(TINY + extra + ["--output_dir", str(out)])
    n = int(extra[extra.index("--num_samples") + 1])
    assert _objs(out) == [f"uncond_{k}.obj" for k in range(n)] and len(paths) == n


def test_generate_cat_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_cat.main(["--random-init", "--output_dir", str(tmp_path)])
