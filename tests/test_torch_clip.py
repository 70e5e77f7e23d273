"""CLIP parity: the port's BPE tokenizer, towers and weight bridge against
surfd_tpu.models.clip, and the text-conditioned slice as a whole.

Token matrices are bit-equal to JAX's in both merge-file formats. The towers
run at a tiny size (vision 32², patch 8, width 128 with two heads, 2 layers;
text width 64, one head, 2 layers, the full 49,408-id vocabulary, embedding
512) and are held to Flax's at 1e-5 abs on the same weights, through both
routes: `clip_state_from_flax` of randomised `init_clip` variables, and the
port's own state dict through JAX's `convert_torch_clip_state_dict`, which
pins the port's names to OpenAI's layout. Readings on this CPU: at most
1.9e-6 on embeddings up to 3.6 (f32 sums in another order; Flax's LayerNorm
variance is E[x²] - E[x]²)."""

import gzip
import hashlib
import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from surfd_tpu.models import MDM as FlaxMDM
from surfd_tpu.models import clip as jclip
from surfd_tpu.models.mdm import make_cfg_model_fn as jax_cfg
from surfd_tpu_torch.diffusion import ddim_sample_loop
from surfd_tpu_torch.models import MDM, make_cfg_model_fn
from surfd_tpu_torch.models import clip
from surfd_tpu_torch.utils import convert
from test_torch_diffusion import _randomize
from test_torch_samplers import ATOL, L, _run_both, _scheds

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
JAX_BPE = os.path.join(ROOT, "surfd_tpu", "assets", "clip_bpe_merges.txt.gz")
PORT_BPE = os.path.join(ROOT, "surfd_tpu_torch", "assets", "clip_bpe_merges.txt.gz")
CFG = dict(image_size=32, patch_size=8, vision_width=128, vision_layers=2, embed_dim=512,
           vocab_size=49408, context_length=77, text_width=64, text_layers=2)
TOL = 1e-5
PROMPTS = [
    "a photo of a dress",
    "Short-sleeve shirt, blue!! (vintage) -- 100% cotton; size: XL?",
    "a &amp; b &lt;b&gt;bold&lt;/b&gt; &quot;quoted&quot; it's we'll",
    "   lots\tof \n  white    space   ",
    "robe à manches courtes élégante — 一件蓝色的连衣裙, платье №5 ½",
    "",
    "a very long caption about an intricate garment " * 12,  # past 77 tokens
]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _flat(variables):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
            for kp, leaf in jtu.tree_flatten_with_path(variables)[0]}


@pytest.fixture(scope="module")
def pair():
    """(Flax model, randomised variables, port Clip) on equal weights:
    every leaf of init_clip's variables redrawn from a numpy seed."""
    model, variables = jclip.init_clip(jax.random.PRNGKey(1), **CFG)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.2).astype(np.float32),
                             jax.tree.map(np.asarray, variables))
    tm = clip.Clip(**CFG)
    tm.load_state_dict(convert.clip_state_from_flax(variables), strict=True)
    return model, variables, tm


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    tokens = clip.tokenize(PROMPTS)
    # a row whose end-of-text id sits first: the causal mask's first row alone
    eot_first = np.zeros((1, 77), np.int32)
    eot_first[0, :3] = (49407, 320, 1125)
    return images, np.concatenate([tokens, eot_first])


def _encode_jax(model, variables, images, tokens):
    return (np.asarray(model.encode_image(variables, jnp.asarray(images))),
            np.asarray(model.encode_text(variables, jnp.asarray(tokens))))


def _encode_port(tm, images, tokens):
    with torch.no_grad():
        return (tm.encode_image(torch.from_numpy(images)).numpy(),
                tm.encode_text(torch.from_numpy(tokens)).numpy())


def test_bpe_asset_is_the_jax_one():
    digest = [hashlib.sha256(open(p, "rb").read()).hexdigest() for p in (PORT_BPE, JAX_BPE)]
    assert digest[0] == digest[1]
    assert os.path.getsize(PORT_BPE) == 208_514


def _published_format(path):
    """The packaged merges in the published file's format: a version header,
    the merges, then merges past the consumed slice that must be ignored."""
    with gzip.open(JAX_BPE) as f:
        merges = [m for m in f.read().decode("utf-8").split("\n") if m]
    with gzip.open(path, "wb") as f:
        f.write("\n".join(['"bpe_simple_vocab_16e6.txt#version: 0.2'] + merges
                          + ["a b", "ab c", "q z"]).encode("utf-8"))
    return str(path)


@pytest.mark.parametrize("fmt", ["packaged", "published"])
def test_tokenize_bit_equal_jax(fmt, tmp_path, monkeypatch):
    path = PORT_BPE if fmt == "packaged" else _published_format(tmp_path / "bpe.txt.gz")
    jpath = JAX_BPE if fmt == "packaged" else path
    monkeypatch.setattr(jclip, "_TOKENIZER", jclip.SimpleTokenizer(jpath))
    want = jclip.tokenize(PROMPTS)
    got = clip.tokenize(PROMPTS, bpe_path=path)
    assert got.dtype == want.dtype == np.int32 and got.shape == (len(PROMPTS), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == 49407 and got[-2, 1] == 49407  # cut row; the empty prompt
    assert clip.get_tokenizer(path).unicode_ok
    with pytest.raises(ValueError, match="too long"):
        clip.tokenize(PROMPTS[-1], truncate=False, bpe_path=path)


def test_default_tokenizer_is_the_packaged_one():
    if os.environ.get("SURFD_CLIP_BPE"):
        pytest.skip("SURFD_CLIP_BPE points elsewhere")
    np.testing.assert_array_equal(clip.tokenize(PROMPTS), clip.tokenize(PROMPTS, bpe_path=PORT_BPE))
    assert len(clip.get_tokenizer().encoder) == 49408


def test_config_from_state_matches_jax(pair):
    model, variables, tm = pair
    want = jclip.clip_config_from_variables(variables)
    assert clip.clip_config_from_state(tm.state_dict()) == want == {**CFG}
    with torch.device("meta"):  # ViT-B/32's shapes, no weights
        full = clip.Clip().state_dict()
    assert clip.clip_config_from_state(full) == dict(
        image_size=224, patch_size=32, vision_width=768, vision_layers=12, embed_dim=512,
        vocab_size=49408, context_length=77, text_width=512, text_layers=12)


def test_towers_match_flax_on_flax_weights(pair):
    """Route 1: clip_state_from_flax of the Flax variables."""
    model, variables, tm = pair
    images, tokens = _inputs()
    (wi, wt), (gi, gt) = _encode_jax(model, variables, images, tokens), _encode_port(tm, images, tokens)
    assert gi.shape == (3, 512) and gt.shape == (len(tokens), 512)
    assert np.abs(wi).max() > 0.1 and np.abs(wt).max() > 0.1
    np.testing.assert_allclose(gi, wi, atol=TOL, rtol=0)
    np.testing.assert_allclose(gt, wt, atol=TOL, rtol=0)


def test_towers_match_flax_through_jax_converter():
    """Route 2: the port's own seeded weights, through JAX's converter of
    OpenAI state dicts, give Flax the same embeddings."""
    tm = clip.Clip(**CFG).random_init_(torch.Generator().manual_seed(5))
    model = jclip.Clip(**CFG)
    variables = jclip.convert_torch_clip_state_dict(tm.state_dict())
    images, tokens = _inputs(4)
    (wi, wt), (gi, gt) = _encode_jax(model, variables, images, tokens), _encode_port(tm, images, tokens)
    np.testing.assert_allclose(gi, wi, atol=TOL, rtol=0)
    np.testing.assert_allclose(gt, wt, atol=TOL, rtol=0)


def test_flat_keys_and_npz_round_trip(pair, tmp_path):
    model, variables, tm = pair
    flat, want = convert.clip_flat_from_state(tm.state_dict()), _flat(variables)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    # the port's npz → JAX's loader → the same embeddings as the port
    path = str(tmp_path / "port.npz")
    convert.save_clip_params(path, tm)
    jm, jv = jclip.load_clip_params(path)
    images, tokens = _inputs(5)
    (wi, wt), (gi, gt) = _encode_jax(jm, jv, images, tokens), _encode_port(tm, images, tokens)
    np.testing.assert_allclose(gi, wi, atol=TOL, rtol=0)
    np.testing.assert_allclose(gt, wt, atol=TOL, rtol=0)
    # JAX's npz → the port's loader: the same weights
    jpath = str(tmp_path / "jax.npz")
    jclip.save_clip_params(jpath, variables)
    back = convert.load_clip_params(jpath)
    for k, v in tm.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_load_clip_pt_and_zoo(pair, tmp_path):
    _, _, tm = pair
    sd = {k: v.half() for k, v in tm.state_dict().items()}  # an fp16 checkpoint
    sd.update(input_resolution=torch.tensor(32), context_length=torch.tensor(77),
              vocab_size=torch.tensor(49408))
    torch.save(sd, tmp_path / "plain.pt")
    scripted = clip.Clip(**CFG)
    scripted.load_state_dict({k: v.float() for k, v in sd.items() if k in tm.state_dict()})
    scripted.register_buffer("input_resolution", torch.tensor(32))
    torch.jit.save(torch.jit.script(scripted), str(tmp_path / "jit.pt"))
    for name in ("plain.pt", "jit.pt"):
        got = convert.load_clip(str(tmp_path / name)).state_dict()
        assert set(got) == set(tm.state_dict())
        for k, v in tm.state_dict().items():
            assert got[k].dtype == torch.float32
            assert torch.equal(got[k], v.half().float()), (name, k)
    npz = str(tmp_path / "w.npz")
    convert.save_clip_params(npz, tm)
    assert torch.equal(convert.load_clip(npz).visual.proj, tm.visual.proj)
    # zoo names read only the cache, checked against the published SHA-256
    with pytest.raises(KeyError):
        convert.load_clip("ViT-Z/99", cache_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="does not download"):
        convert.load_clip("ViT-B/32", cache_dir=str(tmp_path))
    (tmp_path / "ViT-B-32.pt").write_bytes(b"not the checkpoint")
    with pytest.raises(RuntimeError, match="SHA-256"):
        convert.load_clip("ViT-B/32", cache_dir=str(tmp_path))


def test_text_tower_reads_the_end_of_text_token(pair):
    """Ids after the end-of-text token change nothing (causal mask)."""
    _, _, tm = pair
    tok = clip.tokenize(["a long dress"])
    later = tok.copy()
    later[0, 20] = 777
    _, a = _encode_port(tm, np.zeros((1, 32, 32, 3), np.float32), tok)
    _, b = _encode_port(tm, np.zeros((1, 32, 32, 3), np.float32), later)
    np.testing.assert_array_equal(a, b)


def test_text_conditioned_cfg_ddim_matches_jax(pair):
    """The slice: the tiny text tower's context → a small text MDM with CFG
    2.5 (the context paired with zeros in one batched pass), DDIM over 5
    steps on replayed noise; latents within the samplers' 1e-4.

    64 channels, so that each GroupNorm32 group holds 2 or 4 channels. At 16
    channels every group is one channel, whose mean the norm subtracts, so
    the timestep and context embeddings (a constant per channel) cancel:
    JAX's own sample then moved by 7.5e-4 when the context moved by one
    ulp, and by 2.8e-4 when it was set to zeros (readings on this CPU)."""
    model, variables, tm = pair
    tokens = clip.tokenize(["a long dress", "a sleeveless shirt"])
    jctx = model.encode_text(variables, jnp.asarray(tokens))
    with torch.no_grad():
        tctx = tm.encode_text(torch.from_numpy(tokens))
    fm = FlaxMDM(cond_mode="text", model_channels=64, channel_mult=(1, 2), num_res_blocks=1)
    init = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, L, 1)), jnp.zeros((1,), jnp.int32),
                   context=jnp.zeros((1, 512)))
    params = _randomize(jax.tree.map(np.asarray, dict(init["params"])), np.random.default_rng(6))
    mdm = MDM(cond_mode="text", clip_dim=512, model_channels=64, channel_mult=(1, 2),
              num_res_blocks=1)
    mdm.load_state_dict(convert.mdm_state_from_flax({"params": params}, (1, 2), 1), strict=True)
    jfn = jax_cfg(fm, {"params": jax.tree.map(jnp.asarray, params)}, 2.5, context=jctx)
    tfn = make_cfg_model_fn(mdm, 2.5, context=tctx)
    want, got = _run_both("ddim", jfn, tfn, spacing="5", clip_denoised=False)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the context matters: zeros in its place move the latents far past the bar
    zeros = make_cfg_model_fn(mdm, 2.5, context=torch.zeros_like(tctx))
    noise = np.random.default_rng(3).normal(size=got.shape).astype(np.float32)  # _run_both's
    with torch.no_grad():
        other = ddim_sample_loop(_scheds("5")[1], zeros, got.shape, noise=torch.from_numpy(noise),
                                 step_noise=torch.zeros((5, *got.shape)), clip_denoised=False)
    assert np.abs(other.numpy() - got).max() > 100 * ATOL
