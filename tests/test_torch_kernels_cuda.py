"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
only torch, numpy, the port and the conv shape table of
tests/test_torch_conv1d.py, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from surfd_tpu_torch.models import MDM, CbnDecoder
from surfd_tpu_torch.ops import attention_kernel as ak
from surfd_tpu_torch.ops import decoder_kernel as dk
from surfd_tpu_torch.utils.convert import load_sheet_fixture, strip_prefix
from test_torch_conv1d import SHAPES as CONV_SHAPES
from test_torch_conv1d import _inputs as conv_inputs

MAX_DIST = 0.1
HEADS = 8
FIXTURE = str(Path(__file__).resolve().parent.parent / "surfd_tpu/assets/bench_sheet_decoder.npz")
# K1 f32's bars: max and mean abs against folded_udf_ref, as in
# chip_smoke.py. PERF.md gives the readings they were set from, sound and
# with planted faults.
K1_F32_BARS = {"max": 2e-6, "mean": 3e-8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    from surfd_tpu_torch.utils import use_full_f32

    use_full_f32()
    return torch.device("cuda")


def _decoder(hidden, layers, seed=0):
    """Seeded random CbnDecoder whose latent projections are non-trivial."""
    g = torch.Generator().manual_seed(seed)
    dec = CbnDecoder(16, hidden, layers).random_init_(g)
    with torch.no_grad():
        for n, p in dec.named_parameters():
            if "conv_" in n and n.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return dec


# K1 bf16's bars on these random decoders: max and mean abs against
# folded_udf_mixed_tc (the same math on cuBLAS's tensor cores), max abs
# against folded_udf_mixed_ref. PERF.md gives the readings they were set from.
K1_BF16_BARS = {"tc_max": 5e-4, "tc_mean": 3e-6, "plain_max": 1e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("n_pts", [64, 4096 + 17])  # one tile; a ragged last tile
@pytest.mark.parametrize("hidden,layers", [(64, 1), (64, 2), (96, 2), (128, 2), (256, 3), (512, 5)])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_k1_matches_plain(cuda, hidden, layers, precision, n_pts, record_property):
    dec = _decoder(hidden, layers).to(cuda)
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)).to(cuda)
    lat = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32)).to(cuda)
    folded = dk.fold_decoder(dec, lat, MAX_DIST)
    before = dk.folded_udf.launches[precision]
    got = dk.folded_udf(folded, p, precision)
    if precision == "f32":
        want = dk.folded_udf_ref(folded, p)
        torch.cuda.synchronize()
        assert dk.folded_udf.launches[precision] == before + 1
        _assert_f32_bars(got, want, record_property)
        return
    tc = (got - dk.folded_udf_mixed_tc(folded, p)).abs()
    read = {"tc_max": float(tc.max()), "tc_mean": float(tc.mean()),
            "plain_max": float((got - dk.folded_udf_mixed_ref(folded, p)).abs().max())}
    for k, v in read.items():
        record_property(k, v)
    assert dk.folded_udf.launches[precision] == before + 1
    assert all(v <= K1_BF16_BARS[k] for k, v in read.items()), read


def _assert_f32_bars(got, want, record_property):
    err = (got - want).abs()
    read = {"max": float(err.max()), "mean": float(err.mean())}
    for k, v in read.items():
        record_property(k, v)
    assert all(v <= K1_F32_BARS[k] for k, v in read.items()), read


def _fixture_fold(cuda):
    fx = load_sheet_fixture(FIXTURE)
    dec = CbnDecoder(len(fx["latent"]), fx["hidden_dim"], fx["num_hidden_layers"])
    dec.load_state_dict(strip_prefix(fx["state_dict"], "decoder."), strict=True)
    return dk.fold_decoder(dec.to(cuda), torch.from_numpy(fx["latent"]).to(cuda), fx["max_dist"])


def _points(n, seed, cuda):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)).to(cuda)


@pytest.mark.cuda
def test_k1_f32_matches_plain_on_fixture_at_2p20(cuda, record_property):
    """The trained sheet decoder (H 512, L 5) at 2^20 points, the main path's shape."""
    folded = _fixture_fold(cuda)
    pts = _points(1 << 20, 0, cuda)
    _assert_f32_bars(dk.folded_udf(folded, pts, "f32"), dk.folded_udf_ref(folded, pts),
                     record_property)


@pytest.mark.cuda
def test_k1_f32_planted_dropped_w_lo_fails(cuda, record_property):
    """A random decoder's weights are not tf32 values (the fixture's, stored
    in f16, are), so one layer's W1 rounded to tf32 acts as a kernel that
    dropped that layer's W_lo products: it must leave both bars."""
    dec = _decoder(512, 5).to(cuda)
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.uniform(-1, 1, (4096 + 17, 3)).astype(np.float32)).to(cuda)
    folded = dk.fold_decoder(dec, torch.from_numpy(rng.normal(size=(16,)).astype(np.float32)).to(cuda),
                             MAX_DIST)
    w1 = folded.w1.clone()
    w1[2] = dk.round_tf32(w1[2])
    fault = dataclasses.replace(folded, w1=w1)
    want = dk.folded_udf_ref(folded, p)
    err = (dk.folded_udf(fault, p, "f32") - want).abs()
    read = {"max": float(err.max()), "mean": float(err.mean())}
    for k, v in read.items():
        record_property(k, v)
    assert all(v > K1_F32_BARS[k] for k, v in read.items()), read


@pytest.mark.cuda
@pytest.mark.parametrize("plant", ["fragment registers 1 and 2 swapped", "M tiles 0 and 1 swapped"])
def test_k1_f32_planted_wrong_fragment_order_fails(cuda, plant):
    """W1 packed in another A-fragment order than the kernel reads: the
    result must leave the bar, else the check could not see a wrong layout."""
    folded = _fixture_fold(cuda)
    pts = _points(4096, 1, cuda)
    want = dk.folded_udf_ref(folded, pts)
    pk = dk.pack_k1(folded, "f32")
    if plant.startswith("fragment"):
        w1 = pk.w1.view(-1, 4)[:, [0, 2, 1, 3]]
    else:  # (slab, k8 step, M tile, 512 values) with M tiles 0 and 1 traded
        w1 = pk.w1.view(-1, 2, 8, 512)[:, :, [1, 0, 2, 3, 4, 5, 6, 7]]
    bad = dataclasses.replace(pk, w1=w1.contiguous().view(-1))
    assert float((dk.launch_k1(pk, pts, "f32") - want).abs().max()) <= K1_F32_BARS["max"]
    assert float((dk.launch_k1(bad, pts, "f32") - want).abs().max()) > 10 * K1_F32_BARS["max"]


# the MDM's (T, c) at latent 32 (32/28, 16/56, 8/112, 4/112) and 64 (64/28,
# 32/56, 16/112, 8/112), then the kernel's largest shape and shapes off the
# 16-byte staging path (c or T not a multiple of 4, one token)
K2_SHAPES = [(32, 28), (16, 56), (8, 112), (4, 112), (64, 28), (32, 56), (16, 112),
             (64, 128), (5, 27), (1, 4)]


def _k2_input(B, T, c, layout, cuda, seed=2):
    """Seeded qkv on the card, token-major or as the (B, T, W) view of a
    contiguous (B, W, T) tensor (what the attention block's conv writes)."""
    x = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(B, T, 3 * HEADS * c)).astype(np.float32)
    ).to(cuda)
    return x if layout == "token" else x.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["token", "channel"])
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("T,c", K2_SHAPES)
def test_k2_matches_plain(cuda, T, c, B, layout):
    qkv = _k2_input(B, T, c, layout, cuda)
    before = sum(ak.qkv_attention.launches.values())
    got = ak.qkv_attention(qkv, HEADS)
    want = ak.qkv_attention_ref(qkv, HEADS)
    torch.cuda.synchronize()
    assert sum(ak.qkv_attention.launches.values()) == before + 1
    assert got.stride() == want.stride()  # the input's layout
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_k2_runs_on_the_current_stream(cuda):
    """Launched inside torch.cuda.stream(s) while the default stream is held
    busy, K2 runs on s: its result is right once s alone has finished. Had it
    gone to the default stream, s would read an output not yet written."""
    qkv = _k2_input(2, 32, 28, "channel", cuda, seed=7)
    want = ak.qkv_attention_ref(qkv, HEADS)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    torch.cuda._sleep(50_000_000)  # the default stream spins for tens of ms
    with torch.cuda.stream(s):
        err = (ak.qkv_attention(qkv, HEADS) - want).abs().max()
        s.synchronize()
        assert float(err) <= 2e-5  # read on s, not ordered after the default stream
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_mdm_on_card_matches_cpu(cuda):
    """The full-width MDM (K2 in every attention block) against its CPU run."""
    mdm = MDM(model_channels=224)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32))
    t = torch.tensor([3, 700])
    with torch.no_grad():
        want = mdm(x, t)
        got = mdm.to(cuda)(x.to(cuda), t.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_text_mdm_at_latent_64_on_card_matches_cpu(cuda):
    """The full-width text MDM at latent 64, one CFG pass (B 4, half the
    contexts zero): K2 at the four latent-64 shapes, 5 / 5 / 5 / 1 launches,
    and the output against the MDM's CPU run."""
    mdm = MDM(cond_mode="text", clip_dim=512)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(4, 64, 1)).astype(np.float32))
    ctx = torch.from_numpy((0.4 * rng.normal(size=(4, 512))).astype(np.float32))
    ctx[2:] = 0
    t = torch.tensor([3, 700, 3, 700])
    with torch.no_grad():
        want = mdm(x, t, context=ctx)
        before = dict(ak.qkv_attention.launches)
        got = mdm.to(cuda)(x.to(cuda), t.to(cuda), context=ctx.to(cuda)).cpu()
    launched = {k: n - before.get(k, 0) for k, n in ak.qkv_attention.launches.items()
                if n != before.get(k, 0)}
    assert launched == {(64, 28): 5, (32, 56): 5, (16, 112): 5, (8, 112): 1}
    assert float((got - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


def _allow_tf32(on: bool):
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def _tf32_off() -> bool:
    return not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.cuda
def test_entry_points_turn_tf32_off(cuda):
    """A library caller of the pipeline on the card gets full float32."""
    from surfd_tpu_torch.diffusion import named_schedule
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf, make_udf_fn
    from surfd_tpu_torch.pipelines import sample_latents

    sched = named_schedule("cosine", 4)
    try:
        _allow_tf32(True)
        lat = sample_latents(sched, lambda x, t: torch.zeros_like(x), 1, 16,
                             torch.Generator(device=cuda).manual_seed(0))
        assert _tf32_off() and lat.device.type == "cuda"
        _allow_tf32(True)
        udf_fn = make_udf_fn(_decoder(64, 1), None, lat[0], MAX_DIST)
        assert _tf32_off()
        _allow_tf32(True)
        get_mesh_from_udf(udf_fn, cfg=MeshExtractionConfig(resolution=32, max_dist=MAX_DIST))
        assert _tf32_off()
    finally:
        _allow_tf32(False)


@pytest.mark.cuda
def test_wrappers_reject_bad_input(cuda):
    folded = dk.fold_decoder(_decoder(64, 1).to(cuda), torch.zeros(16, device=cuda), MAX_DIST)
    with pytest.raises(ValueError):
        dk.folded_udf(folded, torch.zeros(8, 3, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        dk.folded_udf(folded, torch.zeros(3, 8, device=cuda).t())
    with pytest.raises(ValueError):
        dk.folded_udf(folded, torch.zeros(8, 3, device=cuda, dtype=torch.float64), "bf16")
    with pytest.raises(ValueError):
        dk.folded_udf(folded, torch.zeros(3, 8, device=cuda).t(), "bf16")
    on_cpu = dk.fold_decoder(_decoder(64, 1), torch.zeros(16), MAX_DIST)
    with pytest.raises(ValueError):  # weights on the CPU, points on the card
        dk.folded_udf(on_cpu, torch.zeros(8, 3, device=cuda), "bf16")
    wide = dk.fold_decoder(_decoder(544, 1).to(cuda), torch.zeros(16, device=cuda), MAX_DIST)
    with pytest.raises(ValueError):  # wider than any width K1 bf16 instantiates
        dk.folded_udf(wide, torch.zeros(8, 3, device=cuda), "bf16")
    with pytest.raises(ValueError):
        ak.qkv_attention(torch.zeros(1, 4, 3 * HEADS * 4, device=cuda).half(), HEADS)
    with pytest.raises(ValueError):  # past the kernel's T and c limits
        ak.qkv_attention(torch.zeros(1, 65, 3 * HEADS * 4, device=cuda), HEADS)
    with pytest.raises(ValueError):
        ak.qkv_attention(torch.zeros(1, 4, 3 * HEADS * 129, device=cuda), HEADS)


@pytest.mark.cuda
def test_k2_rejects_other_strides(cuda):
    """Only the two layouts; anything else raises and launches nothing."""
    x = torch.zeros(2, 8, 3 * HEADS * 4, device=cuda)
    before = sum(ak.qkv_attention.launches.values())
    for bad in (x[:, ::2], x.transpose(0, 1),
                x.transpose(1, 2).contiguous().transpose(1, 2)[:, :, :3 * HEADS * 2]):
        with pytest.raises(ValueError, match="strides"):
            ak.qkv_attention(bad, HEADS)
    assert sum(ak.qkv_attention.launches.values()) == before


# K2-bwd at the training shapes: latent 32 and latent 64, 224 channels, 8 heads;
# then the limits and ragged T, whose cluster blocks are unequal (17 = 6 + 6 + 5,
# 33 = 7 x 4 + 5, 63 = 7 x 8 + 7) or hold one CTA (T <= 8), at c 1 and 128 too.
K2_BWD_SHAPES = [(32, 28), (16, 56), (8, 112), (4, 112), (64, 28), (32, 56), (16, 112),
                 (64, 128), (5, 27), (1, 4), (1, 128), (3, 1), (17, 56), (17, 128),
                 (33, 1), (33, 28), (63, 28), (63, 128), (64, 1)]
# K2-bwd against qkv_attention_bwd_ref, abs, scaled by max(1, max |want|): the
# bar chip_smoke.py's phase kernels holds it to (PERF.md gives its readings).
K2_BWD_BAR = 2e-5


def _k2_grad(B, T, c, layout, cuda, seed=3):
    g = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(B, T, HEADS * c)).astype(np.float32)
    ).to(cuda)
    return g if layout == "token" else g.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_layout", ["token", "channel"])
@pytest.mark.parametrize("layout", ["token", "channel"])
@pytest.mark.parametrize("B", [1, 2, 3, 4])
@pytest.mark.parametrize("T,c", K2_BWD_SHAPES)
def test_k2_bwd_matches_plain(cuda, T, c, B, layout, grad_layout):
    qkv = _k2_input(B, T, c, layout, cuda)
    g = _k2_grad(B, T, c, grad_layout, cuda)
    before = sum(ak.qkv_attention_bwd.launches.values())
    got = ak.qkv_attention_bwd(qkv, g, HEADS)
    want = ak.qkv_attention_bwd_ref(qkv, g, HEADS)
    torch.cuda.synchronize()
    assert sum(ak.qkv_attention_bwd.launches.values()) == before + 1
    assert got.stride() == qkv.stride() == want.stride()  # qkv's layout
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= K2_BWD_BAR * scale


@pytest.mark.cuda
@pytest.mark.parametrize("T,c", K2_BWD_SHAPES)
def test_k2_bwd_is_bit_stable(cuda, T, c):
    """Two calls on the same inputs give the same bits: no atomics, a fixed
    order of every sum (a CUDA graph of the train step relies on it)."""
    qkv = _k2_input(2, T, c, "channel", cuda)
    g = _k2_grad(2, T, c, "channel", cuda)
    first = ak.qkv_attention_bwd(qkv, g, HEADS)
    second = ak.qkv_attention_bwd(qkv, g, HEADS)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_k2_grad_goes_through_k2_bwd(cuda):
    """qkv_attention under autograd: the forward is K2, the backward K2-bwd,
    and a strided grad_out (not one of the two layouts) is copied, not refused."""
    x = _k2_input(2, 16, 56, "channel", cuda).detach().requires_grad_(True)
    g = _k2_grad(2, 16, 56, "token", cuda)
    fwd = sum(ak.qkv_attention.launches.values())
    bwd = sum(ak.qkv_attention_bwd.launches.values())
    out = ak.qkv_attention(x, HEADS)
    out.backward(torch.cat([g, g], 2)[:, :, :g.shape[2]])  # g, as a slice of a wider tensor
    torch.cuda.synchronize()
    assert sum(ak.qkv_attention.launches.values()) == fwd + 1
    assert sum(ak.qkv_attention_bwd.launches.values()) == bwd + 1
    want = ak.qkv_attention_bwd_ref(x.detach(), g, HEADS)
    assert float((x.grad - want).abs().max()) <= K2_BWD_BAR * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_k2_bwd_rejects_bad_input(cuda):
    x = torch.zeros(2, 8, 3 * HEADS * 4, device=cuda)
    g = torch.zeros(2, 8, HEADS * 4, device=cuda)
    before = sum(ak.qkv_attention_bwd.launches.values())
    with pytest.raises(ValueError, match="strides"):
        ak.qkv_attention_bwd(x[:, ::2], g[:, ::2], HEADS)
    with pytest.raises(ValueError):
        ak.qkv_attention_bwd(x, g.half(), HEADS)
    with pytest.raises(ValueError):
        ak.qkv_attention_bwd(x, g[:, :4], HEADS)
    with pytest.raises(ValueError):
        ak.qkv_attention_bwd(x, g.cpu(), HEADS)
    with pytest.raises(ValueError):  # past the kernel's T limit
        ak.qkv_attention_bwd(torch.zeros(1, 65, 3 * HEADS * 4, device=cuda),
                             torch.zeros(1, 65, HEADS * 4, device=cuda), HEADS)
    assert sum(ak.qkv_attention_bwd.launches.values()) == before


def _k2_bwd_calls(kernel=ak.qkv_attention_bwd, plain=ak.qkv_attention_bwd_ref):
    """(K2-bwd launches, plain-version calls) so far; the functions are bound
    at import, so a test that swaps them in `ak` still counts these two."""
    return sum(kernel.launches.values()), plain.calls


def _mdm_grads_cpu_and_card(cuda):
    """Parameter gradients of the full-width category MDM (seeded) for one L1
    loss, on the CPU and then on the card: (cpu, card) dicts by name, and the
    card run's (K2-bwd launches, plain K2-bwd calls)."""
    mdm = MDM(cond_mode="category", num_actions=9)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32))
    target = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32))
    t, y = torch.tensor([3, 700]), torch.tensor([1, 9])

    def grads(model, dev):
        model.zero_grad(set_to_none=True)
        out = model(x.to(dev), t.to(dev), action=y.to(dev))
        (out - target.to(dev)).abs().mean().backward()
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    want = grads(mdm, torch.device("cpu"))
    before = _k2_bwd_calls()
    got = grads(mdm.to(cuda), cuda)
    torch.cuda.synchronize()
    return want, got, tuple(n - m for n, m in zip(_k2_bwd_calls(), before))


@pytest.mark.cuda
def test_mdm_backward_on_card_matches_cpu(cuda):
    """The fault this kernel fixes: a backward through the full-width MDM on
    the card gives every attention block's qkv conv and norm a gradient (K2's
    output once had no grad_fn, so they got none), equal to the CPU's within
    1e-4 of each tensor's max |g|; K2-bwd launches 16 times."""
    want, got, calls = _mdm_grads_cpu_and_card(cuda)
    assert calls == (16, 0)
    attn = [n for n in want if ".qkv." in n or ".norm." in n]
    assert len(attn) == 16 * 4
    for n in attn:
        assert float(got[n].abs().max()) > 0, n
    for n, w in want.items():
        scale = float(w.abs().max())
        assert float((got[n] - w).abs().max()) <= 1e-4 * scale, n


@pytest.mark.cuda
@pytest.mark.parametrize("attention", ["kernels", "plain"])
def test_mdm_backward_gap_by_attention(cuda, attention, monkeypatch):
    """Bisects the card's gradient gap to the CPU: the same backward with K2
    and K2-bwd, or with both swapped for their plain versions (here only),
    so that the rest of the card's work (cuDNN, cuBLAS) is the same in both.
    Prints the tensor with the largest gap over its own max |g|, and the
    largest gap over the global max |g|; run with -s to read them. Both stay
    within the 1e-4 bar of test_mdm_backward_on_card_matches_cpu."""
    if attention == "plain":
        monkeypatch.setattr(ak, "_launch_fwd", ak.qkv_attention_ref)
        monkeypatch.setattr(ak, "qkv_attention_bwd", ak.qkv_attention_bwd_ref)
    want, got, calls = _mdm_grads_cpu_and_card(cuda)
    assert calls == ((16, 0) if attention == "kernels" else (0, 16))
    gaps = {n: float((got[n] - w).abs().max()) for n, w in want.items()}
    rel = {n: g / max(float(want[n].abs().max()), 1e-30) for n, g in gaps.items()}
    worst = max(rel, key=rel.get)
    top = max(float(w.abs().max()) for w in want.values())
    print(f"\n[gap] attention {attention}: worst tensor {worst} {rel[worst]:.3e} of its max |g|; "
          f"global {max(gaps.values()) / top:.3e} of the global max |g| ({max(gaps, key=gaps.get)})")
    assert rel[worst] <= 1e-4, worst


@pytest.mark.cuda
def test_ae_skip_restores_batchnorm_buffers_on_card(cuda):
    """The AE step on the card (a small AutoEncoder, B 2): a NaN cloud is
    skipped, and the params, AdamW's moments and every BatchNorm running
    buffer, which the train-mode forward moved on the card, are as before;
    a good batch then moves them. Of the hand-written kernels only the
    decoder's fused CBN + ReLU unit, the 3xTF32 GEMM and the encoder's edge
    convolution unit launch, the skipped step too: each of the 5 units a
    step once forward, twice backward (the create-graph gradient and
    loss.backward) and once backward2; each of the 4 block projections (128
    wide, so that they take the GEMM) a step twice in each form (forward NT,
    create-graph gradient NN; in loss.backward NN, TN and the gradient
    graph's NT, TN); each of the 4 edge convolutions a step once forward and
    once backward (loss.backward)."""
    from surfd_tpu_torch.ops import kernel_calls
    from surfd_tpu_torch.training import (
        AETrainConfig,
        create_train_state,
        init_ae,
        make_ae_train_step,
        make_optimizer,
    )

    ae = init_ae(AETrainConfig(latent_size=8, hidden_dim=128, num_hidden_layers=2),
                 torch.Generator().manual_seed(0)).to(cuda)
    state = create_train_state(ae, make_optimizer(ae.parameters(), 1e-4))
    step = make_ae_train_step(ae)
    rng = np.random.default_rng(0)

    def batch():
        return {"pcd": rng.uniform(-0.5, 0.5, (2, 256, 3)).astype(np.float32),
                "coords": rng.uniform(-1, 1, (2, 512, 3)).astype(np.float32),
                "udf": rng.uniform(0, 0.1, (2, 512)).astype(np.float32),
                "gradients": rng.normal(size=(2, 512, 3)).astype(np.float32)}

    def split():
        calls = kernel_calls()["launches"]
        ours = ("cbn_train_", "gemm_tf32x3_", "edgeconv_train_")
        return ({k: n for k, n in calls.items() if k.startswith(ours)},
                sum(n for k, n in calls.items() if not k.startswith(ours)))

    cbn, launches = split()
    assert step(state, batch())["nonfinite_skipped"] == 0.0
    bad = batch()
    bad["pcd"][0, 5] = np.nan
    before = {k: v.clone() for k, v in ae.state_dict().items()}
    opt = {i: {k: v.clone() for k, v in s.items()}
           for i, s in state.optimizer.state_dict()["state"].items()}
    assert step(state, bad)["nonfinite_skipped"] == 1.0
    assert (state.step, state.count) == (2, 1)
    for k, v in ae.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt[i][k]), (i, k)
    assert step(state, batch())["nonfinite_skipped"] == 0.0
    assert not torch.equal(ae.state_dict()["decoder.bn.bn.running_var"],
                           before["decoder.bn.bn.running_var"])
    units, projections = 2 * 2 + 1, 2 * 2
    assert split() == ({"cbn_train_forward": cbn.get("cbn_train_forward", 0) + 3 * units,
                        "cbn_train_backward": cbn.get("cbn_train_backward", 0) + 6 * units,
                        "cbn_train_backward2": cbn.get("cbn_train_backward2", 0) + 3 * units,
                        **{f"gemm_tf32x3_{f}": cbn.get(f"gemm_tf32x3_{f}", 0) + 6 * projections
                           for f in ("nt", "nn", "tn")},
                        **{f"edgeconv_train_{s}": cbn.get(f"edgeconv_train_{s}", 0) + 3 * 4
                           for s in ("forward", "backward")}},
                       launches)


def _fixture_evaluator(cuda):
    from surfd_tpu_torch.pipelines import make_udf_fn

    fx = load_sheet_fixture(FIXTURE)
    dec = CbnDecoder(len(fx["latent"]), fx["hidden_dim"], fx["num_hidden_layers"])
    dec.load_state_dict(strip_prefix(fx["state_dict"], "decoder."), strict=True)
    return make_udf_fn(dec, None, torch.from_numpy(fx["latent"]), fx["max_dist"], device=cuda)


@pytest.mark.cuda
def test_two_tier_filter_engaged_on_fixture_is_bit_equal(cuda):
    """The sheet fixture at 32³, where the calibrated band is under a quarter
    of the threshold: tier 1 runs on K1 bf16 and the mesh equals the
    single-tier run's bit for bit."""
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf

    udf_fn = _fixture_evaluator(cuda)
    kw = dict(resolution=32, surface_bias="auto")
    bf16 = dk.folded_udf.launches["bf16"]
    two, stats = get_mesh_from_udf(udf_fn, cfg=MeshExtractionConfig(**kw), return_stats=True)
    assert stats["ff_two_tier"] and stats["ff_unsure"] > 0
    assert dk.folded_udf.launches["bf16"] > bf16
    one = get_mesh_from_udf(udf_fn, cfg=MeshExtractionConfig(**kw, two_tier_filter=False))
    np.testing.assert_array_equal(two.vertices, one.vertices)
    np.testing.assert_array_equal(two.faces, one.faces)


@pytest.mark.cuda
def test_marching_oracles_on_fixture(cuda):
    """The fixture's 96³ grid with dense autograd gradients (fill_gradients
    over make_grad_fn) read as settled int8 units: numpy marching equals the native
    passes, and those equal native marching on the lazy int8 gradients by
    grid id: equal faces, vertex Hausdorff < 1e-5."""
    from surfd_tpu_torch.geometry import (
        GridFiller,
        QueryStream,
        hausdorff_distance,
        make_grad_fn,
        marching_tetrahedra_udf,
    )
    from surfd_tpu_torch.geometry.marching import settled_int8_units

    R = 96
    voxel = 2.0 / (R - 1)
    udf_fn = _fixture_evaluator(cuda)
    gf = GridFiller(R, max_dist=udf_fn.max_dist, surface_bias="auto", queries=QueryStream(cuda))
    grid, stats = gf.fill(udf_fn, return_stats=True)
    dense = gf.fill_gradients(make_grad_fn(udf_fn), grid)
    g8 = settled_int8_units(dense).reshape(-1, 3)
    dense_g8 = lambda gids: (lambda: g8[gids])  # noqa: E731
    m_np = marching_tetrahedra_udf(grid, dense_g8, use_native=False)
    m_cc = marching_tetrahedra_udf(grid, dense_g8)
    lazy = lambda gids: udf_fn.grad_i8_gid_async(gids, R, -1.0, voxel, udf_fn.queries)  # noqa: E731
    m_lazy = marching_tetrahedra_udf(grid, lazy, active_blocks=(stats["ab"], stats["block"]))
    assert len(m_np.faces) == len(m_cc.faces) == len(m_lazy.faces) > 10_000
    assert hausdorff_distance(m_np.vertices, m_cc.vertices) < 1e-5
    assert hausdorff_distance(m_lazy.vertices, m_cc.vertices) < 1e-5


@pytest.mark.cuda
def test_classifier_guidance_gradient_runs_k2_bwd(cuda, monkeypatch):
    """make_classifier_cond_fn on the default EncoderUNet1D (224 channels,
    seven attention blocks), called under no_grad as the samplers call it:
    K2 and K2-bwd launch 7 times each, and the gradient equals the one with
    both swapped for their plain versions (here only) within K2-bwd's bar
    of max(1, max |g|); the rest of the card's work is the same in both."""
    from surfd_tpu_torch.models import EncoderUNet1D, make_classifier_cond_fn

    clf = EncoderUNet1D(out_channels=9).random_init_(torch.Generator().manual_seed(12))
    clf = clf.eval().to(cuda)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 1, generator=g).to(cuda)
    t = torch.tensor([40, 700], device=cuda)
    cond_fn = make_classifier_cond_fn(clf, torch.tensor([2, 7], device=cuda), 1.0)
    ak.qkv_attention.launches.clear()
    ak.qkv_attention_bwd.launches.clear()
    with torch.no_grad():
        got = cond_fn(x, t)
    assert sum(ak.qkv_attention.launches.values()) == 7
    assert sum(ak.qkv_attention_bwd.launches.values()) == 7
    monkeypatch.setattr(ak, "_launch_fwd", ak.qkv_attention_ref)
    monkeypatch.setattr(ak, "qkv_attention_bwd", ak.qkv_attention_bwd_ref)
    with torch.no_grad():
        want = cond_fn(x, t)
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= K2_BWD_BAR * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
def test_remat_step_on_card_matches_plain(cuda):
    """One loss and backward of the full-width category MDM with res-block
    dropout 0.1 from a seeded CUDA generator, use_remat on and off, with
    cuDNN's deterministic algorithms (its default backward sums vary run to
    run): the same output and every gradient bit for bit, K2 and K2-bwd
    launched 16 times each either way (the attention blocks are not
    recomputed), and the generator in the same state after."""
    runs = {}
    for remat in (False, True):
        mdm = MDM(cond_mode="category", num_actions=9, dropout=0.1, use_remat=remat)
        mdm.Unet.random_init_(torch.Generator().manual_seed(0))
        mdm = mdm.to(cuda).train()
        g = torch.Generator(device=cuda).manual_seed(12)
        for m in mdm.modules():
            if hasattr(m, "generator"):
                m.generator = g
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.normal(size=(2, 32, 1)).astype(np.float32)).to(cuda)
        t, y = torch.tensor([3, 700], device=cuda), torch.tensor([1, 9], device=cuda)
        ak.qkv_attention.launches.clear()
        ak.qkv_attention_bwd.launches.clear()
        was, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
        try:
            out = mdm(x, t, action=y)
            out.abs().mean().backward()
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = was
        runs[remat] = (out.detach(), {n: p.grad.detach().cpu() for n, p in mdm.named_parameters()},
                       sum(ak.qkv_attention.launches.values()),
                       sum(ak.qkv_attention_bwd.launches.values()), g.get_state())
    (o0, g0, k0, b0, s0), (o1, g1, k1, b1, s1) = runs[False], runs[True]
    assert torch.equal(o0, o1)
    assert (k0, b0) == (k1, b1) == (16, 16)
    assert torch.equal(s0, s1)
    for n, w in g0.items():
        assert torch.equal(g1[n], w), n


# The cleanup's Laplacian (ops/csrc/mesh_laplacian.cu) against numpy's pass.
# The kernel sums in numpy's order and is expected to read 0; the bar allows
# float64 sums taken in another order, ~1e-16 relative, which is at most one
# float32 ulp (6e-8 at |v| <= 1) after the cast.
LAPLACIAN_ATOL = 1e-6


@pytest.fixture(scope="module")
def sheet_256():
    """The sheet fixture at 256³ on the card, finalized and not smoothed:
    (evaluator, mesh)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf
    from surfd_tpu_torch.utils import use_full_f32

    use_full_f32()
    udf_fn = _fixture_evaluator(torch.device("cuda"))
    mesh = get_mesh_from_udf(udf_fn, cfg=MeshExtractionConfig(resolution=256, surface_bias="auto"))
    return udf_fn, mesh


def _laplacian_on_card(mesh, iterations=3):
    from surfd_tpu_torch.ops import mesh_laplacian as ml

    v = torch.from_numpy(mesh.vertices).cuda()
    f = torch.from_numpy(mesh.faces).cuda()
    out = ml.laplacian_smooth(v, f, iterations, 0.5)
    torch.cuda.synchronize()
    return out.cpu().numpy()


@pytest.mark.cuda
def test_laplacian_matches_numpy_at_256(sheet_256, record_property):
    from surfd_tpu_torch.geometry import mesh_ops

    _, mesh = sheet_256
    assert len(mesh.faces) > 1_000_000
    want = mesh_ops.laplacian_smooth(mesh, 3, 0.5).vertices
    got = _laplacian_on_card(mesh)
    err = float(np.abs(got.astype(np.float64) - want).max())
    record_property("max_abs_err", err)
    record_property("coordinates_differing", int((got != want).sum()))
    assert err <= LAPLACIAN_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_laplacian_is_bit_stable(sheet_256, iterations):
    """Two calls give the same bits: the rows are sorted after the atomic
    fill."""
    _, mesh = sheet_256
    np.testing.assert_array_equal(_laplacian_on_card(mesh, iterations),
                                  _laplacian_on_card(mesh, iterations))


@pytest.mark.cuda
def test_laplacian_edge_meshes_match_numpy(cuda):
    """A degenerate face, a repeated face, vertices in no face, no faces."""
    from surfd_tpu_torch.geometry import mesh_ops
    from surfd_tpu_torch.geometry.marching import Mesh

    rng = np.random.default_rng(4)
    v = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    f = rng.integers(0, 380, (1200, 3))
    f[:60, 1] = f[:60, 0]
    f = np.concatenate([f, f[:120]]).astype(np.int64)
    for mesh in (Mesh(v, f), Mesh(v, f[:1]), Mesh(v, np.zeros((0, 3), np.int64))):
        for iterations in (1, 3):
            want = mesh_ops.laplacian_smooth(mesh, iterations, 0.5).vertices
            got = _laplacian_on_card(mesh, iterations)
            assert np.abs(got.astype(np.float64) - want).max() <= LAPLACIAN_ATOL


@pytest.mark.cuda
def test_laplacian_rejects_ids_outside(cuda):
    from surfd_tpu_torch.ops import mesh_laplacian as ml

    v = torch.zeros((4, 3), device=cuda)
    for bad in (4, -1):
        f = torch.tensor([[0, 1, 2], [1, bad, 2]], device=cuda)
        with pytest.raises(ValueError, match="outside"):
            ml.laplacian_smooth(v, f, 3, 0.5)


@pytest.mark.cuda
def test_extraction_on_card_runs_the_laplacian_kernel(sheet_256):
    """One 256³ extraction with the CLIs' cleanup (3 iterations, components
    of 2,500 faces) launches the kernel once and gives the numpy path's
    mesh: the finalized mesh through numpy's smoothing and the filter."""
    from surfd_tpu_torch.geometry import filter_small_components, mesh_ops
    from surfd_tpu_torch.ops import mesh_laplacian as ml
    from surfd_tpu_torch.pipelines import MeshExtractionConfig, get_mesh_from_udf

    udf_fn, finalized = sheet_256
    before = ml.laplacian_smooth.launches
    got, stats = get_mesh_from_udf(
        udf_fn, cfg=MeshExtractionConfig(resolution=256, surface_bias="auto",
                                          final_laplacian_iters=3, min_component_faces=2500),
        return_stats=True)
    assert ml.laplacian_smooth.launches == before + 1
    want = filter_small_components(mesh_ops.laplacian_smooth(finalized, 3, 0.5), 2500)
    assert stats["final_faces"] == len(want.faces)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert np.abs(got.vertices.astype(np.float64) - want.vertices).max() <= LAPLACIAN_ATOL


# The denoiser's convolutions (ops/csrc/conv1d_stream.cu) against conv1d_ref,
# F.conv1d in f32 (TF32 off): max abs error over max |plain|.
CONV_BAR = 1e-5


def _conv_on_card(shape, batch, cuda, seed=0):
    x, w, b, stride, pad = conv_inputs(shape, batch, seed)
    return x.to(cuda), w.to(cuda), b.to(cuda), stride, pad


def _conv_err(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ((2, 1), (4, 2)), ids=("b2_latent32", "b4_latent64"))
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv1d_matches_plain(cuda, shape, batch, record_property):
    """The kernel at each of the full-width MDM's 39 conv shapes, at B 2
    latent 32 and at B 4 latent 64 (the text path's CFG, M up to 256),
    against conv1d_ref; two launches bit-equal, each counted."""
    from surfd_tpu_torch.ops import conv1d_kernel as ck

    x, w, b, stride, pad = _conv_on_card(shape, batch, cuda)
    key = (w.shape[2], stride)
    before = ck.conv1d.launches.get(key, 0)
    with torch.no_grad():
        got, again = ck.conv1d(x, w, b, stride, pad), ck.conv1d(x, w, b, stride, pad)
        want = ck.conv1d_ref(x, w, b, stride, pad)
    torch.cuda.synchronize()
    assert ck.conv1d.launches[key] == before + 2
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, again)
    err = _conv_err(got, want)
    record_property("err", err)
    assert err <= CONV_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged rows and columns", "one input channel",
                                  "odd length, stride 2", "M past 64, three column tiles",
                                  "no bias", "weight rows not 16-byte aligned", "residual"])
def test_conv1d_edges_match_plain(cuda, case):
    """Shapes and layouts off the MDM's: Cout not a multiple of a tile, Cin
    1 (rows of 3 weights), an odd input length under stride 2, M 136 in
    column tiles of 64, no bias, a weight whose rows start off a 16-byte
    boundary (the scalar loads); and a residual added in the epilogue, bit
    for bit the unfused kernel's output plus the residual."""
    from surfd_tpu_torch.ops import conv1d_kernel as ck

    cin, cout, k, stride, B, lin = {
        "ragged rows and columns": (96, 37, 3, 1, 3, 5),
        "one input channel": (1, 224, 3, 1, 2, 32),
        "odd length, stride 2": (224, 224, 3, 2, 2, 17),
        "M past 64, three column tiles": (224, 40, 1, 1, 4, 34),
        "no bias": (448, 448, 1, 1, 2, 16),
        "weight rows not 16-byte aligned": (96, 64, 3, 1, 2, 8),
        "residual": (224, 40, 3, 1, 3, 34),
    }[case]
    g = torch.Generator().manual_seed(4)
    x = torch.randn(B, cin, lin, generator=g).to(cuda)
    w = torch.randn(cout, cin, k, generator=g).to(cuda)
    b = None if case == "no bias" else torch.randn(cout, generator=g).to(cuda)
    if case == "weight rows not 16-byte aligned":
        w = torch.cat([torch.zeros(1, device=cuda), w.flatten()])[1:].view(cout, cin, k)
        assert w.data_ptr() % 16 != 0
    with torch.no_grad():
        got = ck.conv1d(x, w, b, stride, k // 2)
        want = ck.conv1d_ref(x, w, b, stride, k // 2)
        if case == "residual":
            res = torch.randn(got.shape, generator=g).to(cuda)
            fused = ck.conv1d(x, w, b, stride, k // 2, res)
            assert torch.equal(fused, got + res)
            assert _conv_err(fused, ck.conv1d_ref(x, w, b, stride, k // 2, res)) <= CONV_BAR
    torch.cuda.synchronize()
    assert _conv_err(got, want) <= CONV_BAR


@pytest.mark.cuda
def test_conv1d_runs_on_the_current_stream(cuda):
    """Launched inside torch.cuda.stream(s) while the default stream is held
    busy, the conv kernel runs on s."""
    from surfd_tpu_torch.ops import conv1d_kernel as ck

    x, w, b, stride, pad = _conv_on_card((896, 896, 3, 1, 4), (2, 1), cuda)
    with torch.no_grad():
        want = ck.conv1d_ref(x, w, b, stride, pad)
        torch.cuda.synchronize()
        s = torch.cuda.Stream()
        torch.cuda._sleep(50_000_000)
        with torch.cuda.stream(s):
            err = (ck.conv1d(x, w, b, stride, pad) - want).abs().max() / want.abs().max()
            s.synchronize()
            assert float(err) <= CONV_BAR
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_conv1d_rejects_bad_input(cuda):
    """Another dtype, a strided input, K 5, and a call autograd would record
    raise; the routing Conv1d with grad on goes to cuDNN (no launch) and has
    a gradient."""
    from surfd_tpu_torch.models.unet1d import Conv1d
    from surfd_tpu_torch.ops import conv1d_kernel as ck

    x = torch.randn(2, 8, 6, device=cuda)
    w = torch.randn(4, 8, 3, device=cuda)
    with torch.no_grad():
        with pytest.raises(ValueError):
            ck.conv1d(x.half(), w.half(), None, 1, 1)
        with pytest.raises(ValueError):
            ck.conv1d(x.transpose(1, 2).contiguous().transpose(1, 2)[:, :, :6], w, None, 1, 1)
        with pytest.raises(ValueError):
            ck.conv1d(x, torch.randn(4, 8, 5, device=cuda), None, 1, 2)
    with pytest.raises(ValueError, match="no backward"):
        ck.conv1d(x, w.requires_grad_(True), None, 1, 1)
    conv = Conv1d(8, 4, 3, padding=1).to(cuda)
    before = dict(ck.conv1d.launches)
    xg = x.clone().requires_grad_(True)
    conv(xg).square().sum().backward()
    assert ck.conv1d.launches == before and xg.grad is not None
    with torch.no_grad():
        assert _conv_err(conv(x), ck.conv1d_ref(x, conv.weight, conv.bias, 1, 1)) <= CONV_BAR
    assert ck.conv1d.launches[(3, 1)] == before.get((3, 1), 0) + 1


@pytest.mark.cuda
def test_graphed_denoiser_call_launches_98_convs_and_no_cudnn_conv(cuda):
    """One graphed call of the full-width category MDM at B 2, latent 32
    (cell 1's denoiser) counts 98 conv launches, 49 k3 s1, 3 k3 s2 and 46 k1
    s1; a profiled replay runs the conv kernel and no cuDNN convolution
    (implicit GEMM / fprop); its output equals the eager call's bits."""
    from torch.profiler import ProfilerActivity, profile

    from surfd_tpu_torch.models import make_cfg_model_fn
    from surfd_tpu_torch.ops import conv1d_kernel as ck

    mdm = MDM(cond_mode="category", num_actions=9)
    mdm.Unet.random_init_(torch.Generator().manual_seed(0))
    mdm = mdm.to(cuda).eval()
    fn = make_cfg_model_fn(mdm, 1.0, action=torch.tensor([1, 4], device=cuda))
    x = torch.randn(2, 32, 1, generator=torch.Generator().manual_seed(6)).to(cuda)
    t = torch.tensor([999, 998], device=cuda)
    with torch.no_grad():
        eager = fn(x, t)  # the capture
        before = dict(ck.conv1d.launches)
        got = fn(x, t)
        launched = {k: n - before.get(k, 0) for k, n in ck.conv1d.launches.items()}
        assert launched == {(3, 1): 49, (3, 2): 3, (1, 1): 46}
        assert torch.equal(got, eager)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(x, t)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("conv1d_stream" in n for n in names), names
    assert not [n for n in names if "implicit_gemm" in n or "fprop" in n or "cudnn" in n]
