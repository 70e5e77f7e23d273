"""K2's gradient on the CPU: `qkv_attention_bwd_ref` (the plain version of
K2-bwd) against `jax.vjp` of surfd_tpu.models.layers.qkv_attention at the
training shapes in both layouts, an emulation of K2-bwd's split of a head
over a cluster of CTAs against the same, `torch.autograd.gradcheck` in f64,
and the autograd.Function that carries K2 against autograd through
`qkv_attention_ref`. The kernel-vs-plain check is in
test_torch_kernels_cuda.py."""

import math

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
# ragged T: blocks of unequal rows (17 = 6 + 6 + 5, 63 = 7 x 8 + 7), one row, one CTA of 3
EDGE_SHAPES = [(1, 28), (3, 112), (17, 56), (33, 28), (63, 28)]


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


def _split_emulation(qkv: torch.Tensor, grad_out: torch.Tensor, heads: int) -> torch.Tensor:
    """K2-bwd's partition (csrc/qkv_attention_bwd.cu) written out in torch, for
    this test only: R = ceil(T / 8) CTAs per (batch, head) (`cluster_of`
    there), CTA r owning block r of query rows and of key rows. Phase 1 takes
    each query block's row statistics (m, l, D) and dq; the exchange joins
    them; phase 2 recomputes P[:, r] and dS[:, r] for each key block from
    those statistics alone, and takes dk and dV. The scale is applied to the
    products, as in the kernel. Returns dqkv in qkv's layout."""
    B, T, W = qkv.shape
    c = W // (3 * heads)
    R = -(-T // 8)
    rows = -(-T // R)
    assert R <= 8 and rows <= 8 and (R - 1) * rows < T  # no empty block
    blocks = [slice(r * rows, min(T, (r + 1) * rows)) for r in range(R)]
    q, k, v = (x.permute(0, 2, 1, 3) for x in qkv.reshape(B, T, heads, 3 * c).split(c, dim=-1))
    do = grad_out.reshape(B, T, heads, c).permute(0, 2, 1, 3)  # (B, H, T, c)
    s2 = 1.0 / math.sqrt(c)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = []
    for blk in blocks:  # phase 1: query block r
        s = s2 * (q[:, :, blk] @ k.transpose(-1, -2))
        dp = do[:, :, blk] @ v.transpose(-1, -2)
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        l_ = e.sum(-1, keepdim=True)
        p = e / l_
        d = (p * dp).sum(-1, keepdim=True)
        dq[:, :, blk] = s2 * ((p * (dp - d)) @ k)
        stats.append((m, l_, d))
    m, l_, d = (torch.cat(x, dim=2) for x in zip(*stats))  # the exchange: (B, H, T, 1) each
    for blk in blocks:  # phase 2: key block r, against every query row
        s = s2 * (q @ k[:, :, blk].transpose(-1, -2))
        dp = do @ v[:, :, blk].transpose(-1, -2)
        p = torch.exp(s - m) / l_
        ds = p * (dp - d)
        dk[:, :, blk] = s2 * (ds.transpose(-1, -2) @ q)
        dv[:, :, blk] = p.transpose(-1, -2) @ do
    grad = torch.cat([dq, dk, dv], dim=-1).permute(0, 2, 1, 3).reshape(B, T, W)
    return ak._in_layout(grad, ak._channel_first(qkv))


@pytest.mark.parametrize("layout", ["token", "channel"])
@pytest.mark.parametrize("T,c", SHAPES + EDGE_SHAPES)
def test_split_emulation_matches_jax_vjp(T, c, layout):
    """K2-bwd's cluster split, emulated on the CPU, against jax.vjp; bar 1e-5
    abs, as the plain version's."""
    x, g = _inputs(2, T, c, seed=T * c + 1)
    _, vjp = jax.vjp(lambda a: jax_qkv_attention(a, HEADS), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    qkv = _as(x, layout)
    got = _split_emulation(qkv, _as(g, layout), HEADS)
    assert got.stride() == qkv.stride()
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
