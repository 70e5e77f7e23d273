"""The diffusion training CLI and what it reads and writes, on the CPU: the
diffusion datasets and batch iterators against surfd_tpu's on the same
rng, the captions reader, prefetch, the checkpointer, the logger; then
`train_diffusion` for 3 steps at latent 8 on a corpus made by
surfd_tpu.data.preprocess.prepare_udf_sample, the save_dir guard, --resume,
--steps_per_call, and `generate_cat --model_path <save_dir>` reading the run."""

import json
import os

import numpy as np
import pytest
import torch

from surfd_tpu.data import datasets as jdata
from surfd_tpu.data.manifests import load_text2shape_captions as jax_captions
from surfd_tpu.data.preprocess import PreprocessConfig, prepare_udf_sample
from surfd_tpu.geometry.marching import Mesh
from surfd_tpu_torch.cli import _common, generate_cat, train_diffusion
from surfd_tpu_torch.data import datasets as tdata
from surfd_tpu_torch.data import load_text2shape_captions, prefetch_iterator
from surfd_tpu_torch.models import MDM
from surfd_tpu_torch.training import create_train_state, make_optimizer
from surfd_tpu_torch.utils import Checkpointer, Logger, fixseed

ITEMS = ("dress-001", "skirt-002", "dress-003", "coat-004", "skirt-005")
CLASSES = "dress dress\nskirt skirt\ncoat coat\n"
TINY = ["--device", "cpu", "--latent_size", "8", "--model_channels", "16",
        "--num_points_pcd", "64", "--log_interval", "1", "--stall_exit_s", "0"]


def _cube(scale: float) -> Mesh:
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1], [2, 3, 7],
                  [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return Mesh(0.5 * scale * v, f)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """data/train/<id>.npz from prepare_udf_sample (cubes of five sizes),
    a .context.npy beside two of them, a class map and a captions csv."""
    root = tmp_path_factory.mktemp("corpus")
    train = root / "data" / "train"
    train.mkdir(parents=True)
    cfg = PreprocessConfig(num_points_pcd=400, counts=(60, 60, 30), num_uniform=30)
    for i, fid in enumerate(ITEMS):
        np.savez(train / f"{fid}.npz", **prepare_udf_sample(_cube(0.6 + 0.1 * i), cfg))
    for fid in ITEMS[:2]:
        np.save(train / f"{fid}.context.npy",
                np.random.default_rng(len(fid)).normal(size=512).astype(np.float32))
    (root / "classes.txt").write_text(CLASSES)
    (root / "captions.csv").write_text(
        "id,modelId,description,category,synsetId,subSynsetId\n"
        + "".join(f"{i},{fid},a garment number {i},c,s,t\n" for i, fid in enumerate(ITEMS)))
    return root


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


@pytest.mark.parametrize("cond_mode", ["no_cond", "category", "text", "sketch"])
def test_batch_iterators_match_jax(corpus, cond_mode):
    """Items, pcd batches, latent batches and precomputed latents equal to
    surfd_tpu's, drawing from the same default_rng."""
    kw = dict(cond_mode=cond_mode, captions_csv=str(corpus / "captions.csv"),
              category_map={"dress": 0, "skirt": 1, "coat": 2})
    ours = tdata.DiffusionDataset(str(corpus / "data"), "train", **kw)
    ref = jdata.DiffusionDataset(str(corpus / "data"), "train", **kw)
    assert len(ours) == len(ref) == 5
    for i in range(5):
        a, b = ours.cond_item(i), ref.cond_item(i)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    encode_text = (lambda texts: np.asarray([[len(t), 1.0] for t in texts], np.float32)
                   if cond_mode == "text" else None)
    it_a = tdata.diffusion_batch_iterator(ours, 2, 50, np.random.default_rng(3), encode_text)
    it_b = jdata.diffusion_batch_iterator(ref, 2, 50, np.random.default_rng(3), encode_text)
    for _ in range(5):  # past two epochs
        a, b = next(it_a), next(it_b)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    encode = lambda p: p.mean(axis=1)[:, :2].repeat(4, axis=1)  # noqa: E731 — (B, 8)
    cache = corpus / f"cache_{cond_mode}.npz"
    la = tdata.precompute_latents(ours, encode, 50, np.random.default_rng(4), encode_batch=3,
                                  cache_path=str(cache))
    lb = jdata.precompute_latents(ref, encode, 50, np.random.default_rng(4), encode_batch=3)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k])
    again = tdata.precompute_latents(ours, None, 50, np.random.default_rng(9), cache_path=str(cache))
    assert all(np.array_equal(again[k], la[k]) for k in la)  # read from the cache
    it_a = tdata.latent_diffusion_batch_iterator(ours, la, 2, np.random.default_rng(5), encode_text)
    it_b = jdata.latent_diffusion_batch_iterator(ref, lb, 2, np.random.default_rng(5), encode_text)
    for _ in range(5):
        a, b = next(it_a), next(it_b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_captions_match_jax(tmp_path, corpus):
    plain = tmp_path / "plain.csv"
    plain.write_text('a,"a dress, long"\nb,skirt\n')
    for path in (corpus / "captions.csv", plain):
        assert load_text2shape_captions(str(path)) == jax_captions(str(path))


def test_prefetch_keeps_order_and_hands_over_errors():
    def gen():
        yield from range(5)
        raise KeyError("producer failed")

    it = prefetch_iterator(gen(), depth=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    with pytest.raises(KeyError, match="producer failed"):
        next(it)
    assert list(prefetch_iterator(iter(range(3)), depth=1)) == [0, 1, 2]
    with pytest.raises(ValueError):
        prefetch_iterator(iter(()), depth=0)


def test_checkpointer_keeps_three_and_restores(tmp_path):
    """max_to_keep 3, a step is not rewritten unless forced, the newest
    restores model, optimizer, EMA and counters, no temporary file stays."""
    mdm = MDM(model_channels=16, channel_mult=(1, 2), num_res_blocks=1)
    state = create_train_state(mdm, make_optimizer(mdm.parameters(), 1e-3), ema_rate=0.9)
    ck = Checkpointer(str(tmp_path / "ckpt"))
    for step in (1, 2, 3, 4):
        state.step, state.count = step, step - 1
        with torch.no_grad():
            mdm.Unet.out[-1].bias.fill_(step)
        assert ck.save(step, state)
    assert ck.all_steps() == [2, 3, 4] and ck.latest_step() == 4
    assert not ck.save(4, state) and ck.save(4, state, force=True)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [f"step_00000000{s}.pt" for s in (2, 3, 4)]
    fresh = MDM(model_channels=16, channel_mult=(1, 2), num_res_blocks=1)
    st2 = create_train_state(fresh, make_optimizer(fresh.parameters(), 1e-3), ema_rate=0.9)
    ck.restore(st2, step=3)
    assert (st2.step, st2.count) == (3, 2) and float(fresh.Unet.out[-1].bias[0].detach()) == 3.0
    assert st2.optimizer.param_groups[0]["base_lr"] == 1e-3
    saved = ck.read()
    assert saved["step"] == 4 and set(saved["model"]) == set(MDM(
        model_channels=16, channel_mult=(1, 2), num_res_blocks=1).state_dict())


def test_logger_sinks_and_means(tmp_path, capsys):
    log = Logger(str(tmp_path), formats=("stdout", "jsonl", "csv"))
    log.logkv_mean("a", 1.0)
    log.logkv_mean("a", 3.0)
    with log.profile_kv("block"):
        pass
    log.dumpkvs(5)
    log.log_metrics({"b": 2.0}, step=6)
    log.close()
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["step"] == 5 and rows[0]["a"] == 2.0 and "time/block" in rows[0]
    assert rows[1] == {"step": 6, "b": 2.0}
    assert (tmp_path / "metrics.csv").read_text().splitlines()[0].startswith("step,a,")
    assert "| step 6" in capsys.readouterr().out
    g = fixseed(3)
    assert torch.equal(torch.rand(2, generator=g), torch.rand(2, generator=fixseed(3)))


def _train(argv):
    train_diffusion.main(argv)


def test_train_resume_and_generate(corpus, tmp_path, capsys):
    """3 steps (category, class map, cached latents, conditioning dropout),
    the guard, --resume to 5 in chunks of 2, then generate_cat reading the run."""
    save = tmp_path / "run"
    base = TINY + ["--data_root", str(corpus / "data"), "--save_dir", str(save),
                   "--cond_mode", "category", "--category_list", str(corpus / "classes.txt"),
                   "--cond_mask_prob", "0.2", "--save_interval", "2", "--precompute_latents"]
    _train(base + ["--num_steps", "3"])
    assert {"args.json", "metrics.jsonl", "metrics.csv", "ckpt", "latents_cache.npz"} <= set(
        os.listdir(save))
    saved_args = json.loads((save / "args.json").read_text())
    assert saved_args["num_actions"] == 3 and saved_args["latent_size"] == 8
    assert Checkpointer(str(save / "ckpt")).all_steps() == [2, 3]
    rows = [json.loads(x) for x in (save / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert {"loss", "latent_l1", "grad_norm", "param_norm", "nonfinite_skipped"} <= set(rows[0])
    assert all(np.isfinite(r["loss"]) for r in rows)

    with pytest.raises(SystemExit, match="exists"):
        _train(base + ["--num_steps", "3"])
    first = Checkpointer(str(save / "ckpt")).read(3)
    _train(base + ["--num_steps", "5", "--resume", "--steps_per_call", "2"])
    assert "resumed at step 3" in capsys.readouterr().err
    ck = Checkpointer(str(save / "ckpt"))
    assert ck.all_steps() == [3, 4, 5]
    last = ck.read()
    assert (last["step"], last["count"]) == (5, 5)
    assert not torch.equal(last["model"]["Unet.out.2.bias"], first["model"]["Unet.out.2.bias"])
    steps = [json.loads(x)["step"] for x in (save / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3, 4, 5]  # the resumed run appends

    out = tmp_path / "gen"
    paths = generate_cat.main(["--device", "cpu", "--model_path", str(save), "--category",
                               "skirt", "--category_list", str(corpus / "classes.txt"),
                               "--num_samples", "1", "--resolution", "32",
                               "--timestep_respacing", "4", "--decoder_hidden", "64",
                               "--decoder_layers", "1", "--output_dir", str(out)])
    err = capsys.readouterr().err
    assert f"denoiser: step 5 of {save / 'ckpt'} (params)" in err
    assert "[diffusion args.json] latent_size: 32 -> 8" in err
    assert [os.path.basename(p) for p in paths] == ["cat1_0.obj"]
    # the ckpt/ directory names the same run, and its args.json is found
    args = _common.base_parser("t").parse_args(["--model_path", str(save / "ckpt")])
    assert _common.merge_saved_args(args, []).model_channels == 16
    mdm = _common.load_denoiser(args, "category", torch.device("cpu"))
    assert torch.equal(mdm.state_dict()["Unet.out.2.bias"], last["model"]["Unet.out.2.bias"])
