"""Data parallelism of the port on the CPU: gloo process groups of 1 and 2
ranks, each rank a subprocess of tests/torch_parallel_worker.py on a
FileStore in tmp_path, one thread a rank. Every world has its own limits (the
subprocess's `timeout` and the group's 60 s), so a hang fails one test.

The JAX reference, its sharded `eval_in_chunks`, is computed here on the
8-device CPU mesh of tests/conftest.py. Bars: the sharded query stream
equals the unsharded one exactly (JAX's test asserts atol 0); the extracted
mesh has equal faces and vertices within 1e-6 (JAX's test). The CLIs run
in the group too; the trainer's cases are in tests/test_torch_parallel_train.py.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.geometry import eval_in_chunks as jax_eval_in_chunks
from surfd_tpu.models import CbnDecoder as FlaxCbnDecoder
from surfd_tpu.models import CoordsEncoder
from surfd_tpu.parallel import make_mesh as jax_make_mesh
from surfd_tpu_torch.cli import train_diffusion
from surfd_tpu_torch.data.preprocess import PreprocessConfig, prepare_udf_sample
from surfd_tpu_torch.utils.convert import decoder_state_from_flax
from test_torch_cli_train import CLASSES, ITEMS, TINY, _cube

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(case: str, world: int, d, inputs: dict, timeout: float = 120.0,
              env_extra=None) -> list:
    """`world` ranks of the worker on `case`; each rank's result."""
    d = str(d)
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1", **(env_extra or {})}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r), str(world), d], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{case}: world {world} did not finish in {timeout} s")
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{case} rank {r} exited {p.returncode}:\n{o[-4000:]}"
    return [torch.load(os.path.join(d, f"{case}_r{r}.pt"), weights_only=False)
            for r in range(world)]


def test_sharded_query_stream_equals_unsharded(tmp_path):
    """The world-2 stream equals the unsharded one at atol 0 (checked in each
    rank, for four slice counts and three output kinds); its norm values
    equal JAX's sharded eval_in_chunks to an f32 ulp."""
    pts = np.random.default_rng(0).uniform(-1, 1, (5000, 3)).astype(np.float32)
    res = run_world("chunks", 2, tmp_path, {"pts": pts})
    np.testing.assert_array_equal(res[0]["norm"], res[1]["norm"])
    want = jax_eval_in_chunks(jax.jit(lambda p: jnp.linalg.norm(p, axis=-1)), pts, 256,
                              mesh=jax_make_mesh(data=8, model=1, devices=jax.devices()[:8]))
    np.testing.assert_allclose(res[0]["norm"], want, rtol=2e-7, atol=0)


def _jax_test_decoder():
    """The JAX package's sharded-extraction decoder (latent 8, hidden 32, two
    blocks, weights perturbed so that it draws a surface), bridged."""
    decoder = FlaxCbnDecoder(latent_dim=8, hidden_dim=32, num_hidden_layers=2)
    latent = jnp.ones((1, 8)) * 0.1
    dv = decoder.init(jax.random.PRNGKey(0), CoordsEncoder().encode(jnp.zeros((1, 8, 3))), latent)
    dv = jax.tree.map(lambda a: a + 0.3 * jax.random.normal(jax.random.PRNGKey(3), a.shape,
                                                            a.dtype)
                      if a.dtype == jnp.float32 else a, dv)
    lats = np.stack([np.asarray(latent[0]), 0.5 * np.asarray(latent[0]),
                     -np.asarray(latent[0])]).astype(np.float32)
    return decoder_state_from_flax(jax.tree.map(np.asarray, dv)), lats


def test_sharded_extraction_equals_unsharded(tmp_path):
    """48³ (the JAX package's test): the default two-tier u16 filter, exact
    f32 filter points and the auto surface bias, each world-2 against the
    unsharded run; the watertight shell; the batch generator at depth 2
    (each slot on its own fork of the mesh) against depth 1 unsharded.
    The ranks agree with each other."""
    sd, lats = _jax_test_decoder()
    res = run_world("extract", 2, tmp_path, {"decoder": sd, "latents": lats}, timeout=180)
    for key in ("default_faces", "exact_points_faces", "auto_bias_faces"):
        np.testing.assert_array_equal(res[0][key], res[1][key])
    assert res[0]["default_two_tier"]  # the two-tier filter ran sharded
    for a, b in zip(res[0]["pipelined_faces"], res[1]["pipelined_faces"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [1, 2])
def test_multihost_helpers(tmp_path, world):
    """JAX's single-host helper test at world 1 (initialize() without an
    address a no-op first) and its two-process test at world 2; make_mesh
    refuses a shape that is not the world, shard_batch an uneven batch."""
    env = {"SURFD_NO_GROUP_FIRST": "1"} if world == 1 else None
    res = run_world("multihost", world, tmp_path, {}, env_extra=env)
    for r in res:
        assert r["gathered"].tolist() == [[k, 10 * k] for k in range(world)]


def test_generate_cli_data_parallel_rank0_writes(tmp_path):
    """generate_uncond --data_parallel at world 2 on the CPU: the stream is
    sharded, rank 0 alone writes its OBJ, and that OBJ is the single
    process's."""
    from surfd_tpu_torch.cli.generate_uncond import main

    argv = ["--device", "cpu", "--random-init", "--num_samples", "1", "--resolution", "32",
            "--timestep_respacing", "4", "--latent_size", "8", "--model_channels", "16",
            "--decoder_hidden", "64", "--decoder_layers", "1", "--max_batch", "4096"]
    torch.set_num_threads(1)
    main(argv + ["--output_dir", str(tmp_path / "one")])
    r0, r1 = run_world("cli", 2, tmp_path, {"cli_argv": argv})
    assert r0["wrote"] == ["uncond_0.obj"] and r1["wrote"] == []
    assert ((tmp_path / "cli_r0" / "uncond_0.obj").read_text()
            == (tmp_path / "one" / "uncond_0.obj").read_text())


def test_train_cli_ddp_at_world2(tmp_path):
    """train_diffusion at world 2 (category, cached latents, cond dropout, B
    2): DDP over the ranks, rank 0's latent cache and numpy stream on both,
    one run directory written by rank 0; the logged losses within 1e-5 rel
    of the single process's, and both ranks end on the same weights."""
    data = tmp_path / "data" / "train"
    data.mkdir(parents=True)
    cfg = PreprocessConfig(num_points_pcd=400, counts=(60, 60, 30), num_uniform=30)
    for i, fid in enumerate(ITEMS):
        np.savez(data / f"{fid}.npz", **prepare_udf_sample(_cube(0.6 + 0.1 * i), cfg))
    (tmp_path / "classes.txt").write_text(CLASSES)
    base = TINY + ["--data_root", str(tmp_path / "data"), "--cond_mode", "category",
                   "--category_list", str(tmp_path / "classes.txt"), "--cond_mask_prob", "0.2",
                   "--precompute_latents", "--num_steps", "3", "--save_interval", "3"]
    torch.set_num_threads(1)
    train_diffusion.main(base + ["--save_dir", str(tmp_path / "one")])
    r0, r1 = run_world("cli_train", 2, tmp_path, {"argv": base + ["--save_dir",
                                                                 str(tmp_path / "dp")]})
    assert r0["step"] == r1["step"] == 3
    for n, v in r0["model"].items():
        assert torch.equal(v, r1["model"][n]), n
    assert sorted(os.listdir(tmp_path / "dp" / "ckpt")) == ["step_000000003.pt"]

    def losses(run):
        return [json.loads(x)["loss"] for x in (tmp_path / run / "metrics.jsonl").read_text()
                .splitlines()]

    assert len(losses("dp")) == 3
    np.testing.assert_allclose(losses("dp"), losses("one"), rtol=1e-5)
