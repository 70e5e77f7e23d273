"""K2's gradient on the CPU: `qkv_attention_bwd_ref` (the plain version of
K2-bwd) against `jax.vjp` of surfd_tpu.models.layers.qkv_attention at the
training shapes in both layouts, `torch.autograd.gradcheck` in f64, and the
autograd.Function that carries K2 against autograd through
`qkv_attention_ref`. The kernel-vs-plain check is in
test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfd_tpu.models.layers import qkv_attention as jax_qkv_attention
from surfd_tpu_torch import ops
from surfd_tpu_torch.ops import attention_kernel as ak

HEADS = 8
# (T, c) of the MDM's attention blocks at latent 32 and latent 64
SHAPES = [(32, 28), (16, 56), (8, 112), (4, 112), (64, 28), (32, 56), (16, 112)]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(1)


def _inputs(B, T, c, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, 3 * HEADS * c)).astype(dtype),
            rng.normal(size=(B, T, HEADS * c)).astype(dtype))


def _as(x: np.ndarray, layout: str, requires_grad: bool = False) -> torch.Tensor:
    """Token-major, or the (B, T, W) view of a contiguous (B, W, T) tensor."""
    t = torch.from_numpy(x)
    if layout == "channel":
        t = t.transpose(1, 2).contiguous()
        t.requires_grad_(requires_grad)
        return t.transpose(1, 2)
    return t.requires_grad_(requires_grad)


@pytest.mark.parametrize("layout", ["token", "channel"])
@pytest.mark.parametrize("T,c", SHAPES)
def test_bwd_ref_matches_jax_vjp(T, c, layout):
    """Bar 1e-5 abs on gradients up to ~5: f32 sums in two orders."""
    x, g = _inputs(2, T, c, seed=T * c)
    _, vjp = jax.vjp(lambda a: jax_qkv_attention(a, HEADS), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    qkv = _as(x, layout)
    got = ak.qkv_attention_bwd_ref(qkv, _as(g, layout), HEADS)
    assert got.stride() == qkv.stride()  # qkv's layout
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("layout", ["token", "channel"])
def test_gradcheck_f64(layout):
    """The autograd.Function (plain forward, plain backward on the CPU)
    against finite differences of the forward, in f64."""
    x, _ = _inputs(2, 6, 4, seed=1, dtype=np.float64)
    t = torch.from_numpy(x)
    if layout == "channel":
        t = t.transpose(1, 2).contiguous()
        fn = lambda a: ak.qkv_attention(a.transpose(1, 2), HEADS)  # noqa: E731
    else:
        fn = lambda a: ak.qkv_attention(a, HEADS)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (t.requires_grad_(True),), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("grad_layout", ["token", "channel"])
@pytest.mark.parametrize("layout", ["token", "channel"])
@pytest.mark.parametrize("T,c", [(32, 28), (8, 112)])
def test_function_matches_autograd_of_plain(T, c, layout, grad_layout):
    """qkv_attention under autograd (QKVAttention, the plain backward on the
    CPU) against torch.autograd through qkv_attention_ref, in f32."""
    x, g = _inputs(2, T, c, seed=7)
    a = _as(x, layout, requires_grad=True)
    ak.qkv_attention(a, HEADS).backward(_as(g, grad_layout))
    b = _as(x, layout, requires_grad=True)
    ak.qkv_attention_ref(b, HEADS).backward(_as(g, grad_layout))
    leaf_a, leaf_b = (a, b) if layout == "token" else (a._base, b._base)
    np.testing.assert_allclose(leaf_a.grad.numpy(), leaf_b.grad.numpy(), atol=2e-6)


def test_backward_goes_through_bwd_ref_on_cpu():
    """One plain forward and one plain backward per call; both counted as
    plain-version calls, no launch rows."""
    x, g = _inputs(1, 4, 112, seed=2)
    before = (ak.qkv_attention_ref.calls, ak.qkv_attention_bwd_ref.calls,
              ops.kernel_calls()["plain_calls"])
    a = _as(x, "channel", requires_grad=True)
    ak.qkv_attention(a, HEADS).backward(_as(g, "channel"))
    assert ak.qkv_attention_ref.calls == before[0] + 1
    assert ak.qkv_attention_bwd_ref.calls == before[1] + 1
    calls = ops.kernel_calls()
    assert calls["plain_calls"] == before[2] + 2
    assert not any(k.startswith("qkv_attention") for k in calls["launches"])
    with torch.no_grad():  # no autograd: the forward alone
        ak.qkv_attention(a, HEADS)
    assert ak.qkv_attention_bwd_ref.calls == before[1] + 1


def test_bwd_rejects_bad_input():
    x, g = _inputs(1, 4, 4, seed=3)
    with pytest.raises(ValueError, match="grad_out"):
        ak.qkv_attention_bwd(torch.from_numpy(x), torch.from_numpy(g)[:, :2], HEADS)
    with pytest.raises(ValueError, match="strides"):
        ak.qkv_attention_bwd(torch.from_numpy(x)[:, ::2], torch.from_numpy(g)[:, ::2], HEADS)
    with pytest.raises(ValueError):
        ak.qkv_attention_bwd(torch.zeros(1, 4, 3 * HEADS * 4, device="meta"),
                             torch.zeros(1, 4, HEADS * 4, device="meta"), HEADS)
