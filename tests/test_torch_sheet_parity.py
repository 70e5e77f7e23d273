"""The shipped trained sheet decoder (`surfd_tpu/assets/bench_sheet_decoder.npz`)
extracted by the port and by the JAX package on the CPU at 128³ with
surface_bias="auto": the round's mesh bars (faces within 1 %, symmetric mean
NN distance ≤ 0.1 voxel) plus the same active blocks, and the watertight
shell within 1 % of the JAX package's 297,708 faces.

Marked slow: each package takes about 36 s per extraction at 128³ on 8
threads. Run with

    SURFD_RUN_SLOW=1 python -m pytest tests/test_torch_sheet_parity.py -q
"""

import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from surfd_tpu.models import CbnDecoder as FlaxCbnDecoder
from surfd_tpu.models import CoordsEncoder
from surfd_tpu.pipelines import MeshExtractionConfig as JaxConfig
from surfd_tpu.pipelines import get_mesh_from_udf as jax_get_mesh
from surfd_tpu.pipelines import make_udf_fn as jax_make_udf_fn
from surfd_tpu_torch.geometry.mesh_ops import face_components
from surfd_tpu_torch.models import CbnDecoder
from surfd_tpu_torch.pipelines import (
    MeshExtractionConfig,
    get_mesh_from_udf,
    get_watertight_mesh_from_udf,
    make_udf_fn,
)
from surfd_tpu_torch.utils.convert import load_sheet_fixture, strip_prefix

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "surfd_tpu", "assets", "bench_sheet_decoder.npz")
R = 128
VOXEL = 2.0 / (R - 1)
KW = dict(resolution=R, surface_bias="auto", max_batch=2**16)
# The JAX package's watertight face count for the fixture at 128³, auto bias
# (get_watertight_mesh_from_udf on the CPU).
JAX_WATERTIGHT_FACES_128 = 297_708


def _jax_udf_fn():
    z = np.load(FIXTURE)
    dec = FlaxCbnDecoder(latent_dim=len(z["latent"]), hidden_dim=int(z["hidden_dim"]),
                         num_hidden_layers=int(z["num_hidden_layers"]))
    tmpl = dec.init(jax.random.PRNGKey(0), CoordsEncoder().encode(jnp.zeros((1, 8, 3))),
                    jnp.zeros((1, len(z["latent"]))))
    flat, treedef = jtu.tree_flatten_with_path(tmpl)
    leaves = [jnp.asarray(z["dec/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                              for k in kp)].astype(np.asarray(leaf).dtype))
              for kp, leaf in flat]
    return jax_make_udf_fn(dec, jtu.tree_unflatten(treedef, leaves), jnp.asarray(z["latent"]),
                           max_dist=float(z["max_dist"]))


def _port_udf_fn():
    fx = load_sheet_fixture(FIXTURE)
    dec = CbnDecoder(len(fx["latent"]), fx["hidden_dim"], fx["num_hidden_layers"])
    dec.load_state_dict(strip_prefix(fx["state_dict"], "decoder."), strict=True)
    return make_udf_fn(dec, None, fx["latent"], fx["max_dist"], device="cpu", chunk=2**16)


def _mean_nn(a, b):
    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


@pytest.mark.slow
def test_sheet_fixture_matches_jax_at_128():
    torch.set_num_threads(8)
    jm, js_ = jax_get_mesh(_jax_udf_fn(), cfg=JaxConfig(**KW), return_stats=True)
    tfn = _port_udf_fn()
    tm, ts = get_mesh_from_udf(tfn, cfg=MeshExtractionConfig(**KW), return_stats=True)
    gap = abs(len(tm.faces) - len(jm.faces)) / len(jm.faces)
    nn = _mean_nn(tm.vertices, jm.vertices)
    print(f"faces port {len(tm.faces)} JAX {len(jm.faces)} ({100 * gap:.4f} %), mean NN "
          f"{nn:.3g} ({nn / VOXEL:.3g} voxel), active blocks {len(ts['ab'])}, bias "
          f"{ts['surface_bias']:.6f} / {js_['surface_bias']:.6f}")
    assert len(jm.faces) > 10_000
    assert gap <= 0.01
    assert nn <= 0.1 * VOXEL
    np.testing.assert_array_equal(ts["ab"], js_["ab"])
    wm = get_watertight_mesh_from_udf(tfn, MeshExtractionConfig(**KW))
    wgap = abs(len(wm.faces) - JAX_WATERTIGHT_FACES_128) / JAX_WATERTIGHT_FACES_128
    print(f"watertight faces {len(wm.faces)} ({100 * wgap:.4f} % off JAX's "
          f"{JAX_WATERTIGHT_FACES_128})")
    assert wgap <= 0.01
    assert face_components(wm.faces, len(wm.vertices)).max() == 0
    assert float(np.abs(wm.vertices).max()) == 1.0
