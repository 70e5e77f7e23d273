"""The context CLIs (generate_text, generate_sketch, generate_image,
encode_contexts) in process on the CPU at tiny widths, against the JAX
package's CLIs on one tiny CLIP npz (224² images, patch 32, widths 64, one
layer each; written by the port's `save_clip_params`, read by both).

Each generation CLI writes its OBJs under the JAX CLI's tag, and the context
it hands `run_generation` is within 1e-5 abs of what the JAX CLI's own
encoding code computes from the same files; `--context_npy` and the
zero-context fallback behave as in JAX; `encode_contexts` writes the JAX
CLI's `.context.npy` files (1e-5 abs) in both modes and skips items that
have one."""

import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from surfd_tpu.cli import encode_contexts as jax_encode_contexts
from surfd_tpu.cli.generate_sketch import encode_image_clip as jax_encode_image
from surfd_tpu.cli.generate_text import encode_text_clip as jax_encode_text
from surfd_tpu.data import conditioning as jcond
from surfd_tpu.models.clip import load_clip_params as jax_load_clip
from surfd_tpu_torch.cli import _common, encode_contexts, generate_image, generate_sketch, generate_text
from surfd_tpu_torch.models.clip import Clip
from surfd_tpu_torch.utils.convert import save_clip_params

TINY = ["--device", "cpu", "--random-init", "--resolution", "32", "--timestep_respacing", "4",
        "--latent_size", "8", "--model_channels", "16", "--decoder_hidden", "64",
        "--decoder_layers", "1"]
CLIP_CFG = dict(image_size=224, patch_size=32, vision_width=64, vision_layers=1, embed_dim=512,
                text_width=64, text_layers=1)
TOL = 1e-5
PROMPT = "a long-sleeved dress, knee length"
CLIS = {"text": generate_text, "sketch": generate_sketch, "img": generate_image}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _png(path, arr):
    Image.fromarray(arr).save(path)
    return str(path)


def _sketch(seed, h=96, w=80):
    """Black strokes on white, uint8 RGB."""
    img = np.full((h, w, 3), 255, np.uint8)
    rng = np.random.default_rng(seed)
    for _ in range(6):
        y, x = rng.integers(5, h - 5), rng.integers(5, w - 20)
        img[y:y + 2, x:x + 15] = 0
    return img


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cond")
    clip = Clip(**CLIP_CFG).random_init_(torch.Generator().manual_seed(2))
    save_clip_params(str(d / "clip.npz"), clip)
    rng = np.random.default_rng(0)
    mask = np.zeros((90, 120), np.uint8)
    mask[20:70, 50:115] = 255  # reaches the right border after padding
    return {"clip": str(d / "clip.npz"), "sketch": _png(d / "sketch.png", _sketch(1)),
            "image": _png(d / "image.png", rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)),
            "mask": _png(d / "mask.png", mask)}


def _cli_args(mode, files):
    return {"text": ["--text_prompt", PROMPT], "sketch": ["--sketch_path", files["sketch"]],
            "img": ["--image_path", files["image"], "--mask_path", files["mask"]]}[mode]


def _jax_context(mode, files):
    """What the JAX CLI's own code encodes (surfd_tpu/cli/generate_*.py)."""
    if mode == "text":
        return jax_encode_text([PROMPT], files["clip"])
    if mode == "sketch":
        return jax_encode_image([files["sketch"]], files["clip"])
    img = np.asarray(Image.open(files["image"]).convert("RGB"))  # generate_image.py's chain
    mask = np.asarray(Image.open(files["mask"]).convert("L")) > 127
    img = jcond.crop_square(jcond.composite_on_white(img, mask), jcond.mask2bbox(mask))
    model, params = jax_load_clip(files["clip"])
    return np.asarray(model.encode_image(params, jnp.asarray(jcond.clip_preprocess(img)[None])))


def _capture(monkeypatch, module, run=True):
    """Record the context the CLI hands run_generation (and run it, or not)."""
    seen = {}
    real = module.run_generation

    def spy(args, cond_mode, context=None, **kw):
        seen.update(context=context.clone(), cond_mode=cond_mode)
        return real(args, cond_mode, context=context, **kw) if run else []

    monkeypatch.setattr(module, "run_generation", spy)
    return seen


@pytest.mark.parametrize("mode", ["text", "sketch", "img"])
def test_cli_writes_objs_from_the_jax_context(mode, files, tmp_path, monkeypatch, capsys):
    seen = _capture(monkeypatch, CLIS[mode])
    out = tmp_path / "out"
    paths = CLIS[mode].main(TINY + _cli_args(mode, files) + [
        "--clip_npz", files["clip"], "--sampler", "ddim", "--guidance_param", "2.5",
        "--num_samples", "1", "--output_dir", str(out)])
    assert sorted(os.listdir(out)) == [f"{mode}_0.obj"] and len(paths) == 1
    assert seen["cond_mode"] == mode and seen["context"].shape == (1, 512)
    want = _jax_context(mode, files)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(seen["context"].numpy(), want, atol=TOL, rtol=0)
    last = capsys.readouterr().err.strip().splitlines()[-1]
    assert last.startswith(_common.KERNEL_CALLS)  # no kernel on the CPU, plain versions only


@pytest.mark.parametrize("mode", ["text", "sketch", "img"])
def test_context_npy_and_zero_fallback(mode, files, tmp_path, monkeypatch, capsys):
    ctx = np.random.default_rng(7).normal(size=512).astype(np.float32)
    np.save(tmp_path / "ctx.npy", ctx)
    seen = _capture(monkeypatch, CLIS[mode], run=False)
    base = TINY + _cli_args(mode, files) + ["--num_samples", "3", "--output_dir", str(tmp_path)]
    CLIS[mode].main(base + ["--context_npy", str(tmp_path / "ctx.npy"), "--clip_npz", files["clip"]])
    np.testing.assert_array_equal(seen["context"].numpy(), np.repeat(ctx[None], 3, axis=0))
    capsys.readouterr()
    CLIS[mode].main(base)
    assert "WARNING: no CLIP weights/context; zero context" in capsys.readouterr().err
    assert seen["context"].shape == (3, 512) and not seen["context"].any()


def test_context_npy_of_another_width_raises(tmp_path):
    np.save(tmp_path / "ctx.npy", np.zeros(256, np.float32))
    with pytest.raises(ValueError, match=r"context must be \(1, 512\)"):
        generate_text.main(TINY + ["--text_prompt", "x", "--num_samples", "1", "--context_npy",
                                   str(tmp_path / "ctx.npy"), "--output_dir", str(tmp_path)])


def _corpus(root, mode):
    """Two items under data/train/chair/ with their images (and, in img
    mode, a mask for view 0 only: masks are keyed by category and view, so
    the views share one size)."""
    rng = np.random.default_rng(3)
    for k, fid in enumerate(("a01", "b02")):
        os.makedirs(root / "data" / "train" / "chair", exist_ok=True)
        np.savez(root / "data" / "train" / "chair" / f"{fid}.npz", x=np.zeros(1))
        if mode == "sketch":
            os.makedirs(root / "images" / fid)
            _png(root / "images" / fid / "sketch_0.png", _sketch(10 + k, 70 + 20 * k, 90))
        else:
            os.makedirs(root / "images" / "chair" / fid)
            for v in range(2):
                _png(root / "images" / "chair" / fid / f"view_{v:02d}.png",
                     rng.integers(0, 256, (60, 80, 3), dtype=np.uint8))
    if mode == "img":
        mask = np.zeros((60, 80), np.uint8)
        mask[5:40, 30:80] = 255
        os.makedirs(root / "masks" / "chair")
        _png(root / "masks" / "chair" / "view_00.png", mask)


@pytest.mark.parametrize("mode", ["sketch", "img"])
def test_encode_contexts_matches_jax(mode, files, tmp_path, monkeypatch):
    _corpus(tmp_path / "jax", mode)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    argv = ["--split", "train", "--mode", mode, "--clip_npz", files["clip"], "--batch_size", "1"]

    def args(root):
        extra = ["--mask_root", str(root / "masks")] if mode == "img" else []
        return argv + ["--data_root", str(root / "data"), "--image_root", str(root / "images")] + extra

    monkeypatch.setattr(sys, "argv", ["encode_contexts"] + args(tmp_path / "jax"))
    jax_encode_contexts.main()
    written = encode_contexts.main(args(tmp_path / "port") + ["--device", "cpu"])
    assert [p.name for p in written] == ["a01.context.npy", "b02.context.npy"]
    for p in written:
        got = np.load(p)
        want = np.load(tmp_path / "jax" / "data" / "train" / "chair" / p.name)
        assert got.shape == want.shape == (512,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # a second run skips both items
    assert encode_contexts.main(args(tmp_path / "port") + ["--device", "cpu"]) == []


def test_generate_text_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_text.main(["--random-init", "--text_prompt", "x", "--output_dir", str(tmp_path)])
