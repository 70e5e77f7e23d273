"""The route from a JAX training run to the port: the port cannot read an
Orbax checkpoint itself (no module of it may import JAX, and the card's
machine has no JAX, orbax or tensorstore), so the JAX side restores its
train state and writes the upstream `model.pt` (`Unet.*` keys) with
`export_reference_checkpoints`; the port's `load_denoiser --model_path`
reads that file. Held: DDIM latents on the same initial noise within 1e-4
of JAX's own sampler on the restored weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from surfd_tpu.diffusion import gaussian as jg
from surfd_tpu.diffusion import schedule as js
from surfd_tpu.models import MDM as FlaxMDM
from surfd_tpu.training import create_train_state, make_optimizer
from surfd_tpu.utils.checkpoint import Checkpointer
from surfd_tpu.utils.torch_convert import export_reference_checkpoints
from surfd_tpu_torch.cli import _common
from surfd_tpu_torch.diffusion import (
    ddim_sample_loop,
    named_beta_schedule,
    space_timesteps,
    spaced_schedule,
)
from test_torch_diffusion import _randomize

L, CH, B = 8, 16, 2


def test_orbax_state_to_port_ddim(tmp_path):
    torch.set_num_threads(2)
    fm = FlaxMDM(cond_mode="no_cond", model_channels=CH)
    init = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, L, 1)), jnp.zeros((1,), jnp.int32))
    params = jax.tree.map(jnp.asarray, _randomize(jax.tree.map(np.asarray, dict(init["params"])),
                                                  np.random.default_rng(4)))
    state = create_train_state(params, make_optimizer(), ema=True)
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(7, state)
    ck.wait()
    restored = ck.restore(jax.tree.map(np.zeros_like, state))
    ck.close()
    assert int(restored.step) == 0
    jax.tree.map(np.testing.assert_array_equal, restored.params, params)

    paths = export_reference_checkpoints(mdm_vars={"params": restored.ema_params},
                                         out_dir=str(tmp_path / "export"), model_channels=CH)
    args = _common.base_parser("test").parse_args(
        ["--device", "cpu", "--model_path", paths["model"], "--model_channels", str(CH),
         "--latent_size", str(L)])
    mdm = _common.load_denoiser(args, "no_cond", torch.device("cpu"))

    sj = js.spaced_schedule(js.named_beta_schedule("cosine", 1000),
                            js.space_timesteps(1000, "ddim10"))
    st = spaced_schedule(named_beta_schedule("cosine", 1000), space_timesteps(1000, "ddim10"))
    noise = np.random.default_rng(5).normal(size=(B, L, 1)).astype(np.float32)
    want = np.asarray(jg.ddim_sample_loop(
        sj, lambda x, t: fm.apply({"params": restored.ema_params}, x, t), (B, L, 1),
        jax.random.PRNGKey(5), noise=jnp.asarray(noise), clip_denoised=False))
    with torch.no_grad():
        got = ddim_sample_loop(st, mdm, (B, L, 1), torch.Generator().manual_seed(5),
                               noise=torch.from_numpy(noise), clip_denoised=False).numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4)
