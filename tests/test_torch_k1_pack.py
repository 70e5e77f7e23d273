"""K1 bf16's host-side operands: width padding and the wgmma weight layout.

The kernel itself needs the card (tests/test_torch_kernels_cuda.py). Here the
packed weights are read back the way the kernel's wgmma descriptors address
them, and the padded fold is held to the unpadded one on the plain version.
"""

import numpy as np
import pytest
import torch

from surfd_tpu_torch.models import CbnDecoder
from surfd_tpu_torch.ops import decoder_kernel as dk

MAX_DIST = 0.1
LBO, SBO = 128, 1024  # slab descriptor offsets, bytes (folded_mlp_bf16.cu kSlabLbo/kSlabSbo)


def _folded(hidden, layers=2, seed=0):
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(seed)
    dec = CbnDecoder(16, hidden, layers).random_init_(g)
    with torch.no_grad():
        for n, p in dec.named_parameters():
            if "conv_" in n and n.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    lat = torch.from_numpy(np.random.default_rng(seed).normal(size=(16,)).astype(np.float32))
    return dk.fold_decoder(dec, lat, MAX_DIST)


def _read_as_kernel(packed, K, N, npass):
    """Rebuild the (K, N) weight from a packed one by walking the slabs as
    the kernel does: slab (p, s) at (p·K/64 + s)·npass·128 bytes, warpgroup g
    at column g·npass/2, k-step t of 16 at t·2·LBO, and inside an m64nNk16
    B operand element (n, k) at (n/8)·SBO + (n%8)·16 + (k/8)·LBO + (k%8)·2."""
    raw = packed.view(torch.int16).numpy().view(np.uint8)
    slab_bytes = npass * 64 * 2
    nw = npass // 2
    out = np.zeros((K, N), np.uint16)
    n_loc, k_loc = np.meshgrid(np.arange(nw), np.arange(16), indexing="ij")
    inner = (n_loc // 8) * SBO + (n_loc % 8) * 16 + (k_loc // 8) * LBO + (k_loc % 8) * 2
    for p in range(N // npass):
        for s in range(K // 64):
            base = (p * (K // 64) + s) * slab_bytes
            for g in range(2):
                for t in range(4):
                    start = base + g * (nw // 8) * SBO + t * 2 * LBO
                    off = start + inner
                    vals = raw[off].astype(np.uint16) | (raw[off + 1].astype(np.uint16) << 8)
                    out[s * 64 + t * 16: s * 64 + t * 16 + 16,
                        p * npass + g * nw: p * npass + (g + 1) * nw] = vals.T
    assert len(raw) == K * N * 2
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("hidden,width", [(64, 64), (96, 128), (128, 128), (512, 512)])
def test_pack_round_trips(hidden, width):
    f = _folded(hidden)
    pk = f.packed("bf16")
    assert pk.folded.hidden == width and f.packed("bf16") is pk  # made once
    npass = dk.pass_width(width)
    w_in = _read_as_kernel(pk.w_in, 64, width, npass)
    assert torch.equal(w_in[:63, :hidden], f.w_in.to(torch.bfloat16))
    assert not w_in.float()[63:].any() and not w_in.float()[:, hidden:].any()
    size = width * width
    for name in ("w1", "w2"):
        mats = getattr(pk, name)
        assert mats.numel() == f.layers * size
        for i in range(f.layers):
            w = _read_as_kernel(mats[i * size:(i + 1) * size], width, width, npass)
            assert torch.equal(w[:hidden, :hidden], getattr(f, name)[i].to(torch.bfloat16))
            assert not w.float()[hidden:].any() and not w.float()[:, hidden:].any()
    assert torch.equal(pk.w_out[:hidden], f.w_out[:, 0].to(torch.bfloat16))
    assert not pk.w_out[hidden:].float().any()


def _mixed_f64(f, pts):
    """folded_udf_mixed_ref's math with each matmul summed in f64 and rounded
    once to f32: free of summation order, so padding may not move a bit."""
    mm = lambda a, w: (a.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()).float()
    x = mm(dk.posenc_f32(pts), f.w_in) + f.b_in
    for i in range(f.layers):
        h = mm(torch.relu(x * f.a1[i] + f.c1[i]), f.w1[i]) + f.b1[i]
        x = x + mm(torch.relu(h * f.a2[i] + f.c2[i]), f.w2[i]) + f.b2[i]
    logit = mm(torch.relu(x * f.a_out + f.c_out), f.w_out)[..., 0] + f.b_out[0]
    return (1.0 - torch.sigmoid(logit)) * f.max_dist


@pytest.mark.parametrize("hidden,width", [(64, 128), (96, 128), (128, 256)])
def test_padding_is_exact(hidden, width):
    """Zero padding changes nothing: to 0 with order-free sums, and the plain
    version, whose f32 sums may reorder with the width, to f32 rounding."""
    f = _folded(hidden, seed=1)
    pts = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (300, 3)).astype(np.float32))
    assert torch.equal(_mixed_f64(f.padded(width), pts), _mixed_f64(f, pts))
    want = dk.folded_udf_mixed_ref(f, pts)
    torch.testing.assert_close(dk.folded_udf_mixed_ref(f.padded(width), pts), want,
                               rtol=0, atol=1e-6)


def test_pack_rejects_bad_shapes():
    with pytest.raises(ValueError):
        dk.pack_kmajor(torch.zeros(63, 64), 64)
    with pytest.raises(ValueError):
        dk.pack_kmajor(torch.zeros(64, 96), 64)
    with pytest.raises(ValueError):
        _folded(128).padded(64)
