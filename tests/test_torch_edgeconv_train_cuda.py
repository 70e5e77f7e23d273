"""The DGCNN encoder's train-mode edge convolution unit
(`ops/edgeconv_train.py`, `ops/csrc/edgeconv_train.cu`) on the card: the
kernels against the plain versions at the AE step's four block shapes and
odd ones, two runs bit-equal, a whole train-mode `Dgcnn` forward and
backward against its composed path, no (B, N, k, ·) tensor in the step, the
routing.

Every test needs a CUDA card and skips without one. The file imports only
torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_edgeconv_train_cuda.py
"""

from unittest import mock

import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from surfd_tpu_torch.models import dgcnn as tdgcnn
from surfd_tpu_torch.ops import edgeconv_train as ec

# The kernels against the plain versions on the card, both f32: max abs error
# over max |plain|. The kernels form e_ij as P_j + Q_i, the plain version as
# the composed path's Linear on [x_j − x_i, x_i]: near-ties over the
# neighbours may select another slot, so `sel` is held to a share and the
# backward is handed the kernels' own statistics and selection. Readings on
# an NVIDIA H100 80GB HBM3 (PERF.md §6) set them.
BARS = {"f": 1e-5, "stats": 1e-5, "buffers": 1e-6, "sel_differ": 1e-4, "dx": 1e-4,
        "dw": 1e-4, "dgamma": 1e-5, "dbeta": 1e-5}
# (B, N, k, Din, Dout): the AE step's four blocks (cell 4), a ragged N, k 16,
# a channel tile cut short
SHAPES = [(8, 10_000, 20, 3, 64), (8, 10_000, 20, 64, 64), (8, 10_000, 20, 64, 128),
          (8, 10_000, 20, 128, 256), (3, 1237, 20, 64, 128), (2, 999, 16, 128, 256),
          (2, 300, 16, 3, 36)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    from surfd_tpu_torch.utils import use_full_f32

    use_full_f32()
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    """x as a block sees it (the first block a cloud, later ones LeakyReLU
    outputs), the cloud's kNN, W, an affine BatchNorm whose γ has both signs
    (and moved running buffers), gf."""
    B, N, k, Din, Dout = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev)

    cloud = randn(B, N, 3)
    idx = tdgcnn.knn_indices(cloud, k)
    x = cloud if Din == 3 else torch.nn.functional.leaky_relu(randn(B, N, Din) + 0.3, 0.2)
    w = randn(Dout, 2 * Din) / (2 * Din) ** 0.5
    bn = nn.BatchNorm1d(Dout).to(dev)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.5 * randn(Dout))
        bn.weight[::7] *= -1.0
        bn.bias.copy_(0.2 * randn(Dout))
        bn.running_mean.uniform_(-1, 1, generator=g)
        bn.running_var.uniform_(0.5, 2, generator=g)
    return x, idx, w, bn, randn(B, N, Dout)


def _gap(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _copy(bn):
    out = nn.BatchNorm1d(bn.num_features).to(bn.weight.device)
    out.load_state_dict(bn.state_dict())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_stages_match_plain(cuda, shape, record_property):
    x, idx, w, bn, gf = _inputs(shape, cuda)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    adj = ec.adjacency(idx)
    calls = dict(ec.edgeconv_train.launches)
    f, (stats, esel, sel, pq) = ec._forward(x, w, adj, bn)
    f_ref, stats_ref, esel_ref, sel_ref, var = ec.forward_ref(x, idx, w, bn.weight, bn.bias,
                                                              bn.eps)
    same = sel == sel_ref
    read = {"f": _gap(f, f_ref), "stats": max(_gap(stats[i], stats_ref[i]) for i in range(3)),
            "buffers": max(_gap(bn.running_mean, rm * 0.9 + 0.1 * stats_ref[0]),
                           _gap(bn.running_var, rv * 0.9 + 0.1 * var)),
            "sel_differ": 1.0 - float(same.double().mean())}
    assert torch.equal(stats[3], stats_ref[3])  # the clamp's mask
    assert _gap(esel[same], esel_ref[same]) <= BARS["stats"]
    got = ec._backward(gf, x, w, adj, f, stats, esel, sel, pq, True)
    want = ec.backward_ref(gf, x, idx, w, stats, esel, sel, f)
    read.update({k: _gap(u, v) for k, u, v in zip(("dx", "dw", "dgamma", "dbeta"), got, want)})
    torch.cuda.synchronize()
    record_property("gaps", read)
    print(shape, read)
    assert {k: v for k, v in read.items() if not v <= BARS[k]} == {}
    assert ec.edgeconv_train.launches == {k: n + 1 for k, n in calls.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [SHAPES[3], SHAPES[6]])
def test_two_runs_are_bit_equal(cuda, shape):
    x, idx, w, bn, gf = _inputs(shape, cuda, seed=1)
    adj = ec.adjacency(idx)
    runs = []
    for _ in range(2):
        b = _copy(bn)
        f, (stats, esel, sel, pq) = ec._forward(x, w, adj, b)
        runs.append((f, stats, esel, sel, b.running_mean, b.running_var,
                     *ec._backward(gf, x, w, adj, f, stats, esel, sel, pq, True)))
    assert all(torch.equal(u, v) for u, v in zip(*runs))


@pytest.mark.cuda
def test_nan_propagates_as_composed(cuda):
    """A NaN in one point's features makes every output NaN, as the
    composed path's batch statistics do: the AE step's non-finite skip must
    still see it."""
    x, idx, w, bn, _ = _inputs(SHAPES[6], cuda)
    x[1, 17, 2] = float("nan")
    f = ec.edgeconv_train(x, ec.adjacency(idx), w, _copy(bn))
    assert torch.isnan(f).all()


def _encoder_grads(enc, pts, cot, unit: bool):
    with torch.no_grad():
        sd = {k: v.clone() for k, v in enc.state_dict().items()}
    route = tdgcnn.fused if unit else (lambda training, x: False)
    with mock.patch.object(tdgcnn, "fused", route):
        lat = enc(pts)
        grads = torch.autograd.grad(lat, list(enc.parameters()), cot)
    enc.load_state_dict(sd)
    return lat, grads


@pytest.mark.cuda
def test_dgcnn_train_matches_composed(cuda, record_property):
    """A train-mode Dgcnn (B 2 × 4,000 points, k 20, latent 32) forward and
    backward through the unit and through the composed path on the card,
    both f32, each against the composed path in f64: the unit's gaps are of
    the composed f32 path's size."""
    g = torch.Generator().manual_seed(3)
    enc = tdgcnn.Dgcnn(32, k=20).random_init_(g).to(cuda).train()
    pts = torch.rand(2, 4000, 3, generator=g).to(cuda) * 2 - 1
    cot = torch.randn(2, 32, generator=g).to(cuda)
    calls = dict(ec.edgeconv_train.launches)
    lat_u, g_u = _encoder_grads(enc, pts, cot, True)
    assert ec.edgeconv_train.launches == {k: n + 4 for k, n in calls.items()}
    lat_c, g_c = _encoder_grads(enc, pts, cot, False)
    lat_d, g_d = _encoder_grads(enc.double(), pts.double(), cot.double(), False)
    names = [n for n, _ in enc.named_parameters()]
    unit = {"latent": _gap(lat_u.double(), lat_d),
            **{n: _gap(u.double(), v) for n, u, v in zip(names, g_u, g_d)}}
    comp = {"latent": _gap(lat_c.double(), lat_d),
            **{n: _gap(u.double(), v) for n, u, v in zip(names, g_c, g_d)}}
    record_property("gaps", {"unit": unit, "composed": comp})
    print("unit", unit, "composed", comp)
    assert max(unit.values()) <= max(4 * max(comp.values()), 1e-5), (unit, comp)


class _Largest(TorchDispatchMode):
    """The largest tensor (elements) any aten op returns inside the block."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.cuda
def test_no_edge_tensor_in_the_step(cuda, record_property):
    """The four edge blocks at cell 4's B 8 × 10,000 × k 20, forward and
    backward: through the unit no op returns a tensor of B·N·k·64 elements
    (the smallest (B, N, k, ·) f32 tensor of the composed path) or more, and
    the allocator's peak is far under the composed path's."""
    g = torch.Generator().manual_seed(4)
    enc = tdgcnn.Dgcnn(32, k=20).random_init_(g).to(cuda).train()
    pts = torch.rand(8, 10_000, 3, generator=g).to(cuda) * 2 - 1
    idx = tdgcnn.knn_indices(pts, 20)
    edges = 8 * 10_000 * 20

    def blocks(unit):
        adj = ec.adjacency(idx) if unit else None
        f, feats = pts, []
        for i in range(1, 5):
            conv, bn = getattr(enc, f"conv_{i}"), getattr(enc, f"bn_{i}")
            if unit:
                f = ec.edgeconv_train(f, adj, conv.weight, bn)
            else:
                f = enc._bn_act(bn, conv(tdgcnn.gather_graph_feature(f, idx))).amax(dim=2)
            feats.append(f)
        torch.cat(feats, -1).square().sum().backward()

    read = {}
    for unit in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _Largest() as mode:
            blocks(unit)
        torch.cuda.synchronize()
        read["unit" if unit else "composed"] = {
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "largest_elements": mode.numel}
    record_property("memory", read)
    print(read)
    assert read["unit"]["largest_elements"] < edges * 64 <= read["composed"]["largest_elements"]
    assert read["unit"]["peak_gb"] < read["composed"]["peak_gb"] / 4


@pytest.mark.cuda
def test_routing(cuda):
    """CUDA train with grad → the unit, one forward and one backward stage a
    block; eval, grad off and the CPU → the composed path (no launch, no
    plain-version call)."""
    from surfd_tpu_torch.ops import kernel_calls

    g = torch.Generator().manual_seed(5)
    enc = tdgcnn.Dgcnn(16, k=8).random_init_(g)
    pts = torch.rand(2, 200, 3, generator=g)

    def step(dev, train, grad=True):
        e = enc.to(dev).train(train)
        with torch.set_grad_enabled(grad):
            lat = e(pts.to(dev))
            if grad:
                lat.sum().backward()

    plain = kernel_calls()["plain_calls"]
    before = dict(ec.edgeconv_train.launches)
    step(cuda, True)
    assert ec.edgeconv_train.launches == {k: n + 4 for k, n in before.items()}
    for dev, train, grad in ((cuda, False, True), (cuda, True, False),
                             (torch.device("cpu"), True, True)):
        before = dict(ec.edgeconv_train.launches)
        step(dev, train, grad)
        assert ec.edgeconv_train.launches == before, (dev, train, grad)
    assert kernel_calls()["plain_calls"] == plain


@pytest.mark.cuda
def test_rejects_what_the_kernels_do_not_take(cuda):
    x, idx, w, bn, _ = _inputs(SHAPES[6], cuda)
    adj = ec.adjacency(idx)
    with pytest.raises(ValueError):
        ec.edgeconv_train(x.double(), adj, w.double(), _copy(bn).double())
    with pytest.raises(ValueError):  # Dout not a multiple of 4
        ec.edgeconv_train(x, adj, w[:6], nn.BatchNorm1d(6).to(cuda))
    with pytest.raises(ValueError):
        ec.edgeconv_train(x, ec.adjacency(idx.cpu()), w, _copy(bn))
