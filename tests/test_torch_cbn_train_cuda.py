"""The AE decoder's fused train-mode conditional BatchNorm + ReLU
(`ops/cbn_train.py`, `ops/csrc/cbn_train.cu`) on the card: each stage's
kernels against the plain versions, two runs bit-equal, the routing.

Every test needs a CUDA card and skips without one. The file imports only
torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cbn_train_cuda.py
"""

import pytest
import torch
from torch import nn

from surfd_tpu_torch.ops import cbn_train as cb

# The kernels against the plain versions on the card, both f32: max abs error
# over max |plain|. The backward stages are handed the same statistics, so the
# two read the same ReLU mask and differ by the order of their sums alone.
# Readings on an NVIDIA H100 80GB HBM3 (PERF.md §6) set them.
BARS = {"h": 1e-5, "stats": 1e-5, "buffers": 1e-6, "backward": 2e-5, "backward2": 5e-5}
# (B, Q, C): the AE step's (cell 4), a slab and a ragged one, 4-byte loads at
# odd C, a channel tile cut short, one item
SHAPES = [(8, 20_000, 512), (2, 300, 36), (3, 257, 33), (1, 5, 7), (1, 1000, 64), (5, 256, 132)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    from surfd_tpu_torch.utils import use_full_f32

    use_full_f32()
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    """x with a per-channel offset (so μ is not 0), γ around 1, β around 0,
    the cotangents; channel 0 of x constant (the variance clamp)."""
    B, Q, C = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 0.7 + torch.linspace(-1, 2, C, device=dev)
    x[..., 0] = 0.3
    gamma = 1.0 + 0.3 * torch.randn((B, C), generator=g, device=dev)
    beta = 0.2 * torch.randn((B, C), generator=g, device=dev)
    gh, a = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    ga, ba = (torch.randn((B, C), generator=g, device=dev) for _ in range(2))
    return x, gamma, beta, gh, a, ga, ba


def _gap(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _bn(C, dev):
    bn = nn.BatchNorm1d(C, affine=False).to(dev)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    return bn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_stages_match_plain(cuda, shape, record_property):
    x, gamma, beta, gh, a, ga, ba = _inputs(shape, cuda)
    bn = _bn(shape[2], cuda)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    calls = dict(cb.cbn_relu_train.launches)
    h, stats = cb._forward(x, gamma, beta, bn)
    h_ref, stats_ref, var = cb.forward_ref(x, gamma, beta, bn.eps)
    rm_ref = rm * (1 - bn.momentum) + bn.momentum * stats_ref[0]
    rv_ref = rv * (1 - bn.momentum) + bn.momentum * var
    # channel 0 is constant: its s − μ² is rounding alone, of either sign on
    # either side, and v clamps to about 0, so r is about 1/√ε; the others
    # are held to the plain statistics
    assert abs(float(stats[1, 0]) * bn.eps ** 0.5 - 1.0) < 1e-2
    read = {"h": _gap(h, h_ref), "stats": max(_gap(stats[i, 1:], stats_ref[i, 1:])
                                              for i in (0, 1)),
            "buffers": max(_gap(bn.running_mean, rm_ref), _gap(bn.running_var, rv_ref))}
    assert torch.equal(stats[2, 1:], stats_ref[2, 1:])  # the clamp's mask
    got = cb._backward(gh, x, gamma, beta, stats)
    want = cb.backward_ref(gh, x, gamma, beta, stats)
    read["backward"] = max(_gap(u, v) for u, v in zip(got, want))
    got = cb._backward2(a, ga, ba, gh, x, gamma, beta, stats)
    want = cb.backward2_ref(a, ga, ba, gh, x, gamma, beta, stats)
    read["backward2"] = max(_gap(u, v) for u, v in zip(got, want))
    torch.cuda.synchronize()
    record_property("gaps", read)
    print(shape, read)
    assert {k: v for k, v in read.items() if not v <= BARS[k]} == {}
    assert cb.cbn_relu_train.launches == {k: n + 1 for k, n in calls.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 20_000, 512), (3, 257, 33)])
def test_two_runs_are_bit_equal(cuda, shape):
    x, gamma, beta, gh, a, ga, ba = _inputs(shape, cuda, seed=1)
    runs = []
    for _ in range(2):
        h, stats = cb._forward(x, gamma, beta, _bn(shape[2], cuda))
        runs.append((h, stats, *cb._backward(gh, x, gamma, beta, stats),
                     *cb._backward2(a, ga, ba, gh, x, gamma, beta, stats)))
    assert all(torch.equal(u, v) for u, v in zip(*runs))


@pytest.mark.cuda
def test_nan_propagates_as_composed(cuda):
    """A NaN latent row makes h NaN, as torch.relu keeps it: the AE step's
    non-finite skip must still see it."""
    x, gamma, beta, *_ = _inputs((2, 300, 36), cuda)
    gamma[1, 3] = float("nan")
    h, _ = cb._forward(x, gamma, beta, _bn(36, cuda))
    assert torch.isnan(h[1, :, 3]).all() and not torch.isnan(h[0]).any()


@pytest.mark.cuda
def test_twice_differentiable_unit_matches_composed(cuda, record_property):
    """A loss on the create-graph input gradient, differentiated again,
    through the fused unit and through the composed batch_norm + γ/β + ReLU
    on the card, both f32, each against the composed path in f64: the fused
    unit's gap is of the composed f32 path's size (the second-order loss
    cancels, so f32 reads ~1e-3 either way)."""
    from surfd_tpu_torch.models.layers import batch_norm

    B, Q, C = 4, 3000, 64
    x0, gamma0, beta0, gh, *_ = _inputs((B, Q, C), cuda, seed=2)
    w = torch.randn(C, device=cuda)

    def grads(unit, dtype=torch.float32):
        x, gamma, beta = (t.to(dtype).requires_grad_(True) for t in (x0, gamma0, beta0))
        h = unit(x, gamma, beta)
        gx = torch.autograd.grad((h.square() * w.to(dtype)).sum(), x, create_graph=True)[0]
        loss = (gx * gh.to(dtype)).sum() + (h * gh.to(dtype)).sum()
        return torch.autograd.grad(loss, (x, gamma, beta))

    bns = [_bn(C, cuda) for _ in range(3)]
    for bn in bns[1:]:
        bn.load_state_dict(bns[0].state_dict())
    bns[2].double()

    def composed(bn):
        return lambda x, g, b: torch.relu(g[:, None] * batch_norm(x, bn, True) + b[:, None])

    want = grads(composed(bns[2]), torch.float64)
    fused = [_gap(u.double(), v) for u, v in
             zip(grads(lambda x, g, b: cb.cbn_relu_train(x, g, b, bns[0])), want)]
    comp = [_gap(u.double(), v) for u, v in zip(grads(composed(bns[1])), want)]
    record_property("gaps", {"fused": fused, "composed": comp})
    print("fused", fused, "composed", comp)
    assert max(fused) <= max(4 * max(comp), 1e-5), (fused, comp)
    assert torch.allclose(bns[0].running_mean, bns[1].running_mean, rtol=0, atol=1e-6)
    assert torch.allclose(bns[0].running_var, bns[1].running_var, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_routing(cuda):
    """CUDA train → the fused unit (one launch of each stage a forward,
    create-graph gradient and backward); eval → F.batch_norm (no launch);
    the CPU → the composed path (no launch, no plain-version call)."""
    from surfd_tpu_torch.models import CbnDecoder
    from surfd_tpu_torch.ops import kernel_calls

    g = torch.Generator().manual_seed(0)
    dec = CbnDecoder(8, 64, 2).random_init_(g)
    units = 2 * 2 + 1
    coords = torch.randn(2, 300, 63, generator=g)
    lat = torch.randn(2, 8, generator=g)

    def step(dev, train):
        d = dec.to(dev).train(train)
        c = coords.to(dev).requires_grad_(True)
        out = d(c, lat.to(dev))
        gx = torch.autograd.grad(out.sum(), c, create_graph=True)[0]
        (gx.square().sum() + out.sum()).backward()

    before = dict(cb.cbn_relu_train.launches)
    plain = kernel_calls()["plain_calls"]
    step(cuda, True)
    assert cb.cbn_relu_train.launches == {
        "forward": before["forward"] + units, "backward": before["backward"] + 2 * units,
        "backward2": before["backward2"] + units}
    for dev, train in ((cuda, False), (torch.device("cpu"), True), (torch.device("cpu"), False)):
        before = dict(cb.cbn_relu_train.launches)
        step(dev, train)
        assert cb.cbn_relu_train.launches == before, (dev, train)
    assert kernel_calls()["plain_calls"] == plain


@pytest.mark.cuda
def test_rejects_what_the_kernels_do_not_take(cuda):
    x, gamma, beta, *_ = _inputs((2, 300, 36), cuda)
    bn = _bn(36, cuda)
    with pytest.raises(ValueError):
        cb.cbn_relu_train(x.double(), gamma.double(), beta.double(), bn)
    with pytest.raises(ValueError):
        cb.cbn_relu_train(x, gamma[:1], beta[:1], bn)
    with pytest.raises(ValueError):
        cb.cbn_relu_train(x, gamma.cpu(), beta, bn)
