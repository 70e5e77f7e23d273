"""The denoiser's convolutions on the CPU: UNet1D's routing `Conv1d` against
`nn.Conv1d` (forward and gradient, bit for bit; the state-dict keys), the
plain version `conv1d_ref` and the GEMM view the kernel computes at the
full-width MDM's 39 conv shapes, and a float64 emulation of the kernel's
split (`ops.conv1d_kernel.plan`: row tiles, CTAs of a cluster along k, warps
along rows and k, the im2col staged by index arithmetic) against `F.conv1d`.

The kernel itself (ops/csrc/conv1d_stream.cu) runs only on a card:
tests/test_torch_kernels_cuda.py holds it to `conv1d_ref` there.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from surfd_tpu_torch import ops
from surfd_tpu_torch.models import MDM
from surfd_tpu_torch.models import unet1d
from surfd_tpu_torch.ops import conv1d_kernel as ck

# (Cin, Cout, K, stride, L_out at latent 32) of the full-width MDM's 39
# distinct convolutions (224 channels, mult 1, 2, 4, 4); at B 2, latent 32
# M = 2 L_out is 8 to 64; at B 4, latent 64 (the text path's CFG) four times.
SHAPES = (
    (896, 896, 3, 2, 4), (896, 896, 3, 1, 4), (896, 2688, 1, 1, 4), (896, 896, 1, 1, 4),
    (1792, 896, 3, 1, 4), (1792, 896, 1, 1, 4),
    (448, 448, 3, 2, 8), (448, 896, 3, 1, 8), (448, 896, 1, 1, 8), (896, 896, 3, 1, 8),
    (896, 2688, 1, 1, 8), (896, 896, 1, 1, 8), (1792, 896, 3, 1, 8), (1792, 896, 1, 1, 8),
    (1344, 896, 3, 1, 8), (1344, 896, 1, 1, 8),
    (224, 224, 3, 2, 16), (224, 448, 3, 1, 16), (224, 448, 1, 1, 16), (448, 448, 3, 1, 16),
    (448, 1344, 1, 1, 16), (448, 448, 1, 1, 16), (896, 896, 3, 1, 16), (1344, 448, 3, 1, 16),
    (1344, 448, 1, 1, 16), (896, 448, 3, 1, 16), (896, 448, 1, 1, 16), (672, 448, 3, 1, 16),
    (672, 448, 1, 1, 16),
    (1, 224, 3, 1, 32), (224, 224, 3, 1, 32), (224, 672, 1, 1, 32), (224, 224, 1, 1, 32),
    (448, 448, 3, 1, 32), (672, 224, 3, 1, 32), (672, 224, 1, 1, 32), (448, 224, 3, 1, 32),
    (448, 224, 1, 1, 32), (224, 1, 3, 1, 32),
)
BATCHES = ((2, 1), (4, 2))  # (B, L_out scale): latent 32 at B 2, latent 64 at B 4


def _conv_args(shape, batch):
    """(B, Cin, L_in), (Cout, Cin, K), stride, padding of one table entry."""
    cin, cout, k, stride, lout = shape
    B, scale = batch
    lout *= scale
    return (B, cin, lout * stride), (cout, cin, k), stride, k // 2


def _inputs(shape, batch, seed=0):
    xs, ws, stride, pad = _conv_args(shape, batch)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(xs, generator=g)
    w = torch.randn(ws, generator=g) / math.sqrt(ws[1] * ws[2])
    b = torch.randn(ws[0], generator=g)
    return x, w, b, stride, pad


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_shape_table_is_the_mdms():
    """SHAPES is the set of (Cin, Cout, K, stride, L_out) of the full-width
    category MDM's convolutions at B 2, latent 32, read by forward hooks;
    98 of them, 49 k3 s1, 3 k3 s2 and 46 k1 s1, every one a routing Conv1d."""
    mdm = MDM(cond_mode="category")
    seen = []

    def hook(mod, inp, out):
        seen.append((mod.in_channels, mod.out_channels, mod.kernel_size[0], mod.stride[0],
                     out.shape[2]))

    convs = [m for m in mdm.modules() if isinstance(m, nn.Conv1d)]
    assert all(type(m) is unet1d.Conv1d for m in convs)
    for m in convs:
        m.register_forward_hook(hook)
    with torch.no_grad():
        mdm(torch.zeros(2, 32, 1), torch.zeros(2, dtype=torch.long),
            action=torch.zeros(2, dtype=torch.long))
    assert len(seen) == len(convs) == 98
    assert sorted(set(seen)) == sorted(SHAPES)
    by_ks = {}
    for _, _, k, s, _ in seen:
        by_ks[k, s] = by_ks.get((k, s), 0) + 1
    assert by_ks == {(3, 1): 49, (3, 2): 3, (1, 1): 46}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv1d_ref_matches_f_conv1d_and_the_gemm_view(shape):
    """conv1d_ref is F.conv1d bit for bit, and the kernel's GEMM view,
    out[b, co, t] = bias + sum W[co, ci·K + k] x[b, ci, t·s + k - p] in
    float64, agrees with it (f32 sums of up to 5,376 terms)."""
    x, w, b, stride, pad = _inputs(shape, BATCHES[0])
    calls = ck.conv1d_ref.calls
    got = ck.conv1d_ref(x, w, b, stride, pad)
    assert ck.conv1d_ref.calls == calls + 1
    assert torch.equal(got, F.conv1d(x, w, b, stride, pad))
    want = _gemm_view(x.double(), w.double(), b.double(), stride, pad)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _im2col(x, k, stride, pad, lout, k0=0, k1=None):
    """X[kg, m] for kg in [k0, k1) by the kernel's staging arithmetic: ci =
    kg // K, pos = t·stride - pad + kg % K, zero outside [0, L_in)."""
    B, cin, lin = x.shape
    k1 = cin * k if k1 is None else k1
    kg = torch.arange(k0, k1)
    ci, kk = kg // k, kg % k
    t = torch.arange(lout)
    pos = t[None, :] * stride - pad + kk[:, None]  # (kg, t)
    ok = (pos >= 0) & (pos < lin)
    cols = x[:, ci[:, None], pos.clamp(0, lin - 1)]  # (B, kg, t)
    cols = torch.where(ok[None], cols, torch.zeros((), dtype=x.dtype))
    return cols.permute(1, 0, 2).reshape(k1 - k0, B * lout)  # m = b·L_out + t


def _im2col_scattered(x, k, stride, pad, lout, k0, k1):
    """The same rows [k0, k1) as the kernel stages them: each element x[b, c,
    pos] of the CTA's channels c0 = k0 // K .. (k1 - 1) // K written to the
    slots (k = c·K + kk, m = b·L_out + t) with t·stride = pos + pad - kk,
    every other slot zero."""
    B, cin, lin = x.shape
    c0, c1 = k0 // k, (k1 - 1) // k + 1
    c = torch.arange(c0, c1)[:, None, None]
    pos = torch.arange(lin)[None, :, None]
    kk = torch.arange(k)[None, None, :]
    ts = (pos + pad - kk).expand(c1 - c0, lin, k)
    t = ts // stride
    kg = (c * k + kk).expand(c1 - c0, lin, k)
    ok = (ts >= 0) & (ts % stride == 0) & (t < lout) & (kg >= k0) & (kg < k1)
    X = torch.zeros(k1 - k0, B * lout, dtype=x.dtype)
    for b in range(B):
        vals = x[b, c0:c1, :, None].expand(c1 - c0, lin, k)
        X[kg[ok] - k0, b * lout + t[ok]] = vals[ok]
    return X


def _gemm_view(x, w, b, stride, pad):
    cout, cin, k = w.shape
    B, _, lin = x.shape
    lout = (lin + 2 * pad - k) // stride + 1
    out = w.reshape(cout, cin * k) @ _im2col(x, k, stride, pad, lout) + b[:, None]
    return out.reshape(cout, B, lout).permute(1, 0, 2)


def _emulate(x, w, b, stride, pad, p):
    """The kernel's split in float64: each warp's partial over its steps of
    k of its CTA's im2col, staged by the kernel's scatter of x's slice and
    equal to the gather (a warp of the last CTA may have no step), a
    CTA's warps along k summed in order, then the cluster's CTAs in rank
    order, per output tile (4·wr rows, tm·lm columns); rows past Cout and
    columns past M dropped."""
    cout, cin, k = w.shape
    B, _, lin = x.shape
    lout = (lin + 2 * pad - k) // stride + 1
    kw, m = cin * k, B * lout
    W = w.reshape(cout, kw)
    rows, mt, nwk = p.wr * ck.TR, p.tm * p.lm, ck.WARPS // p.wr
    splits, row_tiles, col_tiles = p.grid(cout, m)
    out = torch.full((cout, m), float("nan"), dtype=x.dtype)
    ctas = []  # each CTA's partial: its warps along k summed in order
    for rank in range(splits):
        k0, k1 = rank * p.kc, min(kw, (rank + 1) * p.kc)
        assert k0 < k1, "an empty CTA"
        X = torch.zeros(p.kc, m, dtype=x.dtype)
        X[:k1 - k0] = _im2col_scattered(x, k, stride, pad, lout, k0, k1)
        assert torch.equal(X[:k1 - k0], _im2col(x, k, stride, pad, lout, k0, k1))
        nsteps = -(-(k1 - k0) // p.kstep)
        cta = W.new_zeros(cout, m)
        for wk in range(nwk):
            s0, s1 = nsteps * wk // nwk, nsteps * (wk + 1) // nwk
            a, z = k0 + s0 * p.kstep, min(k1, k0 + s1 * p.kstep)  # none: a zero partial
            if a < z:
                cta = cta + W[:, a:z] @ X[a - k0:z - k0]
        ctas.append(cta)
    for ty in range(row_tiles):
        for tz in range(col_tiles):
            r0, r1 = ty * rows, min(cout, (ty + 1) * rows)
            c0, c1 = tz * mt, min(m, (tz + 1) * mt)
            if r0 >= r1 or c0 >= c1:
                continue
            acc = torch.zeros(r1 - r0, c1 - c0, dtype=x.dtype)
            for cta in ctas:  # rank order
                acc = acc + cta[r0:r1, c0:c1]
            assert torch.isnan(out[r0:r1, c0:c1]).all(), "a tile written twice"
            out[r0:r1, c0:c1] = acc + b[r0:r1, None]
    return out.reshape(cout, B, lout).permute(1, 0, 2)


@pytest.mark.parametrize("batch", BATCHES, ids=("b2_latent32", "b4_latent64"))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_split_emulated_matches_conv(shape, batch):
    """At every conv shape of the MDM, at B 2 latent 32 and B 4 latent 64:
    the plan keeps to the kernel's limits (cluster of 1 to 8 CTAs, each
    with a k-range, kc a whole number of steps,
    the shared memory within 227 KB) and the split, emulated in float64,
    equals F.conv1d."""
    x, w, b, stride, pad = (t.double() if torch.is_tensor(t) else t
                            for t in _inputs(shape, batch))
    cout, cin, k = w.shape
    lout = x.shape[2] // stride
    p = ck.plan(cout, cin * k, x.shape[0] * lout)
    assert 1 <= p.splits <= ck.MAX_SPLITS and p.kc % p.kstep == 0
    assert (p.splits - 1) * p.kc < cin * k <= p.splits * p.kc
    assert p.smem_bytes() <= ck.SMEM_MAX
    got = _emulate(x, w, b, stride, pad, p)
    want = F.conv1d(x, w, b, stride, pad)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("case", ["ragged rows and columns", "one input channel",
                                  "odd length, stride 2", "M past 64, three column tiles"])
def test_kernel_split_emulated_at_edges(case):
    """Shapes off the MDM's: Cout not a multiple of a tile, Cin 1 (W's rows
    of 3, the scalar loads), an odd input length under stride 2, M 136 in
    column tiles of 64."""
    cin, cout, k, stride, B, lin = {
        "ragged rows and columns": (96, 37, 3, 1, 3, 5),
        "one input channel": (1, 224, 3, 1, 2, 32),
        "odd length, stride 2": (224, 224, 3, 2, 2, 17),
        "M past 64, three column tiles": (224, 40, 1, 1, 4, 34),
    }[case]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, cin, lin, generator=g, dtype=torch.float64)
    w = torch.randn(cout, cin, k, generator=g, dtype=torch.float64)
    b = torch.randn(cout, generator=g, dtype=torch.float64)
    pad = k // 2
    lout = (lin + 2 * pad - k) // stride + 1
    p = ck.plan(cout, cin * k, B * lout)
    want = F.conv1d(x, w, b, stride, pad)
    got = _emulate(x, w, b, stride, pad, p)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_plan_keeps_weight_heavy_shapes_within_the_aimed_ctas():
    """Every conv of the MDM at B 2 with at least 4 MB of weights runs
    between MIN_CTAS and MAX_CTAS CTAs, all 8 warps along its rows where
    that keeps MIN_CTAS."""
    for cin, cout, k, stride, lout in SHAPES:
        if 4 * cin * cout * k >= 4e6:
            p = ck.plan(cout, cin * k, 2 * lout)
            ctas = math.prod(p.grid(cout, 2 * lout))
            assert ck.MIN_CTAS <= ctas <= ck.MAX_CTAS, (cin, cout, k, stride, lout, p)
            assert p.wr == 8 or -(-cout // 32) * ck.MAX_SPLITS < ck.MIN_CTAS


@pytest.mark.parametrize("with_residual", [False, True], ids=("plain", "residual"))
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_routing_conv_equals_nn_conv1d_on_cpu(k, stride, pad, with_residual):
    """On the CPU the routing Conv1d is nn.Conv1d bit for bit (with a
    residual: the block's `skip + nn.Conv1d(x)`), its output and its
    gradients (input, weight, bias, residual), and each call counts one
    plain-version call."""
    torch.manual_seed(0)
    ours = unet1d.Conv1d(24, 40, k, stride=stride, padding=pad)
    ref = nn.Conv1d(24, 40, k, stride=stride, padding=pad)
    ref.load_state_dict(ours.state_dict())
    x = torch.randn(3, 24, 16)
    skip = torch.randn(3, 40, 16 // stride) if with_residual else None
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ra, rb = ((None, None) if skip is None
              else (skip.clone().requires_grad_(True), skip.clone().requires_grad_(True)))
    calls = ops.kernel_calls()["plain_calls"]
    a = ours(xa, residual=ra)
    b = ref(xb) if rb is None else rb + ref(xb)
    assert ops.kernel_calls()["plain_calls"] == calls + 1
    assert torch.equal(a, b)
    g = torch.randn_like(a)
    a.backward(g)
    b.backward(g)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(ours.weight.grad, ref.weight.grad)
    assert torch.equal(ours.bias.grad, ref.bias.grad)
    if skip is not None:
        assert torch.equal(ra.grad, rb.grad)
    with torch.no_grad():
        assert torch.equal(ours(x, residual=skip), ref(x) if skip is None else skip + ref(x))


class _NnConv1d(nn.Conv1d):
    """nn.Conv1d's own forward, the block's skip path added after it."""

    def forward(self, x, residual=None):
        out = super().forward(x)
        return out if residual is None else residual + out


def _with_nn_conv(monkeypatch, **kw):
    """The MDM as it was built with nn.Conv1d at every site."""
    monkeypatch.setattr(unet1d, "Conv1d", _NnConv1d)
    try:
        return MDM(**kw)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("cond_mode", ["category", "text"])
def test_state_dict_keys_unchanged_and_upstream_loads_strict(cond_mode, monkeypatch):
    """The routing Conv1d keeps nn.Conv1d's parameters: the MDM's state-dict
    keys and shapes are those of the MDM built with nn.Conv1d, and that
    model's state dict (the upstream `Unet.*` keys) loads with strict=True
    and gives the same output."""
    kw = dict(cond_mode=cond_mode, model_channels=32, clip_dim=16)
    old = _with_nn_conv(monkeypatch, **kw)
    old.Unet.random_init_(torch.Generator().manual_seed(1))
    new = MDM(**kw)
    assert [(k, v.shape) for k, v in new.state_dict().items()] == \
        [(k, v.shape) for k, v in old.state_dict().items()]
    assert all(k.startswith("Unet.") for k in new.state_dict())
    new.load_state_dict(old.state_dict(), strict=True)
    x = torch.randn(2, 32, 1)
    t = torch.tensor([5, 900])
    cond = ({"action": torch.tensor([1, 2])} if cond_mode == "category"
            else {"context": torch.randn(2, 16)})
    with torch.no_grad():
        assert torch.equal(new(x, t, **cond), old(x, t, **cond))


def test_cpu_forward_counts_98_plain_calls_and_launches_nothing():
    """A CPU forward of the MDM (here 32 channels, the same 98 sites) runs
    every convolution through conv1d_ref, 38 of them with the block's
    residual (22 res blocks, 16 attention blocks): 98 plain-version calls,
    no conv launch rows."""
    mdm = MDM(cond_mode="category", model_channels=32)
    mdm.Unet.random_init_(torch.Generator().manual_seed(2))
    calls, fused = ck.conv1d_ref.calls, []
    ref = ck.conv1d_ref

    def counting(*args):
        fused.append(len(args) == 6 and args[5] is not None)
        return ref(*args)

    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet1d, "conv1d_ref", counting)
        mdm(torch.randn(2, 32, 1), torch.tensor([1, 2]), action=torch.tensor([0, 3]))
    assert ck.conv1d_ref.calls == calls + 98 and sum(fused) == 38
    assert not any(k.startswith("conv1d") for k in ops.kernel_calls()["launches"])


def test_conv1d_rejects_other_devices():
    x = torch.zeros(1, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.conv1d(x, torch.zeros(3, 2, 1, device="meta"))
