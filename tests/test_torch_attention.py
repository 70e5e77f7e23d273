"""QKV attention parity: the plain version of kernel K2 against
surfd_tpu.models.layers.qkv_attention at every MDM shape (224 channels, 8
heads), B = 1 and 4, in both layouts the wrapper takes: token-major, and the
channel-first view the attention block's convolution hands it. The
kernel-vs-plain check is in test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.models.layers import qkv_attention as jax_qkv_attention
from surfd_tpu_torch.ops import attention_kernel as ak

HEADS = 8
SHAPES = [(32, 28), (16, 56), (8, 112), (4, 112)]  # (T, c) at ds 1, 2, 4, 8
SHAPES_64 = [(64, 28), (32, 56), (16, 112), (8, 112)]  # the same at latent 64


def _qkv(B, T, c, seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, 3 * HEADS * c)).astype(np.float32)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("T,c", SHAPES)
def test_plain_matches_jax(T, c, B):
    torch.set_num_threads(1)
    x = _qkv(B, T, c)
    want = np.asarray(jax_qkv_attention(jnp.asarray(x), HEADS))
    got = ak.qkv_attention(torch.from_numpy(x), HEADS).numpy()
    assert got.shape == (B, T, HEADS * c)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_rejects_bad_shapes():
    with pytest.raises(ValueError):
        ak.qkv_attention(torch.zeros(1, 4, 3 * HEADS * 2 + 1), HEADS)
    with pytest.raises(ValueError):
        ak.qkv_attention(torch.zeros(4, 3 * HEADS), HEADS)
    with pytest.raises(ValueError):
        ak.qkv_attention(torch.zeros(1, 4, 3 * HEADS, device="meta"), HEADS)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("T,c", SHAPES + SHAPES_64)
def test_plain_channel_first_matches_jax(T, c, B):
    """The (B, T, W) view of a contiguous (B, W, T) tensor in, the same
    layout out: a (B, H·c, T) tensor once transposed back."""
    torch.set_num_threads(1)
    x = _qkv(B, T, c, seed=T + c)
    want = np.asarray(jax_qkv_attention(jnp.asarray(x), HEADS))
    view = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(1, 2)
    got = ak.qkv_attention(view, HEADS)
    assert got.shape == (B, T, HEADS * c)
    assert got.transpose(1, 2).is_contiguous() and not got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("make", [
    lambda x: x[:, ::2],                          # every other token
    lambda x: x.transpose(0, 1),                  # tokens and batch swapped
    lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)[:, :, :x.shape[2] // 2],  # channel slice
    lambda x: torch.cat([x, x], 2).transpose(1, 2).contiguous().transpose(1, 2)[:, :, ::2],
], ids=["token-step", "batch-token-swap", "channel-slice", "channel-step"])
def test_rejects_other_strides(make):
    x = torch.zeros(2, 8, 3 * HEADS * 4)
    bad = make(x)
    assert bad.shape[2] % (3 * HEADS) == 0
    with pytest.raises(ValueError, match="strides"):
        ak.qkv_attention(bad, HEADS)
