"""The AE decoder's fused train-mode conditional BatchNorm + ReLU
(`ops/cbn_train.py`) on the CPU, through its plain versions: the unit's
forward and running buffers against the composed `batch_norm` + γ/β + ReLU,
each stage's written-out formulas against autograd of the composed path,
`gradcheck` and `gradgradcheck` in float64, the hand-written second
derivative against autograd of the written-out first, the edge cases (a
constant channel, z exactly 0, one item, a ragged slab, odd widths), and a
whole AE loss gradient with the decoder on the plain unit against the
composed decoder, in float64. The kernels themselves run on the card
(tests/test_torch_cbn_train_cuda.py)."""

from unittest import mock

import numpy as np
import pytest
import torch
from torch import nn

from surfd_tpu_torch.models import decoder as tdecoder
from surfd_tpu_torch.models.layers import batch_norm
from surfd_tpu_torch.ops import cbn_train as cb
from surfd_tpu_torch.training import ae_trainer

# (B, Q, C): a ragged last slab (Q past SLAB_ROWS), odd widths, one item, one row
SHAPES = [(3, 7, 5), (2, cb.SLAB_ROWS + 44, 6), (1, 9, 33), (4, 1, 3)]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    torch.set_num_threads(2)


def _inputs(shape, dtype=torch.float64, seed=0, constant=False, zero_z=False):
    """x with per-channel offsets, γ around 1, β around 0, cotangents.
    `constant`: channel 0 of x constant (the variance clamp); `zero_z`: γ
    and β 0 for item 0's channel 1, so that z is exactly 0 there."""
    B, Q, C = shape
    g = torch.Generator().manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=g, dtype=dtype)

    x = randn(B, Q, C) * 0.7 + torch.linspace(-1, 2, C, dtype=dtype)
    gamma, beta = 1.0 + 0.3 * randn(B, C), 0.2 * randn(B, C)
    if constant:
        x[..., 0] = 0.3
    if zero_z:
        gamma[0, 1] = beta[0, 1] = 0.0
    return x, gamma, beta, randn(B, Q, C), randn(B, Q, C), randn(B, C), randn(B, C)


def _bn(C, dtype=torch.float64):
    bn = nn.BatchNorm1d(C, affine=False).to(dtype)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    return bn


def _composed(x, gamma, beta, bn):
    return torch.relu(gamma[:, None] * batch_norm(x, bn, True) + beta[:, None])


def _leaves(*ts):
    return [t.clone().requires_grad_(True) for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_buffers_match_composed(shape, dtype):
    x, gamma, beta, *_ = _inputs(shape, dtype, constant=True, zero_z=shape[2] > 1)
    bn1 = _bn(shape[2], dtype)
    bn2 = _bn(shape[2], dtype)
    bn2.load_state_dict(bn1.state_dict())
    h = cb.cbn_relu_train(x, gamma, beta, bn1)
    want = _composed(x, gamma, beta, bn2)
    # the same ops on the same device: the same bits
    assert torch.equal(h, want)
    assert torch.equal(bn1.running_mean, bn2.running_mean)
    assert torch.equal(bn1.running_var, bn2.running_var)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ["plain", "constant", "zero_z"])
def test_stages_match_autograd_of_composed(shape, case):
    """backward_ref against the composed path's first derivative for gh;
    backward2_ref against the derivative of that first derivative (autograd
    with create_graph) for the cotangents a, Γ, Β: in float64."""
    x, gamma, beta, gh, a, ga, ba = _inputs(shape, constant=case == "constant",
                                            zero_z=case == "zero_z")
    bn = _bn(shape[2])
    _, stats, _ = cb.forward_ref(x, gamma, beta, bn.eps)
    lx, lg, lb, lgh = _leaves(x, gamma, beta, gh)
    h = _composed(lx, lg, lb, bn)
    first = torch.autograd.grad(h, (lx, lg, lb), lgh, create_graph=True)
    got = cb.backward_ref(gh, x, gamma, beta, stats)
    for u, v in zip(got, first):
        torch.testing.assert_close(u, v.detach(), rtol=1e-10, atol=1e-12)
    second = torch.autograd.grad(first, (lgh, lx, lg), (a, ga, ba), retain_graph=True,
                                 allow_unused=True)
    got = cb.backward2_ref(a, ga, ba, gh, x, gamma, beta, stats)
    for u, v in zip(got, second):
        torch.testing.assert_close(u, torch.zeros_like(u) if v is None else v,
                                   rtol=1e-9, atol=1e-11)
    # β moves only the ReLU's mask: the composed second derivative has none
    gb = torch.autograd.grad(first, lb, (a, ga, ba), allow_unused=True)[0]
    assert gb is None or not gb.any()


@pytest.mark.parametrize("shape", [(3, 7, 5), (1, 9, 4)])
def test_second_derivative_is_autograd_of_written_out_first(shape):
    """backward2_ref against autograd through backward_ref, with the
    statistics taken from x differentiably (forward_ref)."""
    x, gamma, beta, gh, a, ga, ba = _inputs(shape, seed=3)
    lx, lg, lb, lgh = _leaves(x, gamma, beta, gh)
    _, stats, _ = cb.forward_ref(lx, lg, lb, 1e-5)
    first = cb.backward_ref(lgh, lx, lg, lb, stats)
    want = torch.autograd.grad(first, (lgh, lx, lg), (a, ga, ba))
    got = cb.backward2_ref(a, ga, ba, gh, x, gamma, beta, stats.detach())
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shape", [(3, 7, 5), (1, 6, 3), (2, 5, 1)])
def test_gradcheck_and_gradgradcheck(shape):
    x, gamma, beta, *_ = _inputs(shape, seed=4)
    bn = _bn(shape[2])
    inputs = _leaves(x, gamma, beta)

    def unit(x, g, b):
        return cb.cbn_relu_train(x, g, b, bn)

    assert torch.autograd.gradcheck(unit, inputs)
    assert torch.autograd.gradgradcheck(unit, inputs)


def test_plain_versions_are_counted():
    x, gamma, beta, gh, *_ = _inputs((2, 5, 3), seed=5)
    before = (cb.forward_ref.calls, cb.backward_ref.calls, cb.backward2_ref.calls)
    launches = dict(cb.cbn_relu_train.launches)
    lx = x.clone().requires_grad_(True)
    h = cb.cbn_relu_train(lx, gamma, beta, _bn(3))
    gx = torch.autograd.grad(h, lx, gh, create_graph=True)[0]
    gx.square().sum().backward()
    assert (cb.forward_ref.calls, cb.backward_ref.calls, cb.backward2_ref.calls) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert cb.cbn_relu_train.launches == launches  # no kernel on the CPU


def test_rejects_gamma_not_per_item():
    x, gamma, beta, *_ = _inputs((2, 5, 3))
    with pytest.raises(ValueError):
        cb.cbn_relu_train(x, gamma[:, None], beta[:, None], _bn(3))
    with pytest.raises(ValueError):
        cb.cbn_relu_train(x[0], gamma, beta, _bn(3))


def test_routing_by_what_the_unit_sees():
    """The decoder sends a CUDA float32 (B, N, C) input in train mode with
    one latent per item to the fused unit; eval mode, the CPU, other dtypes
    and per-point conditions keep the composed path."""
    x, cond = torch.zeros(2, 3, 4), torch.zeros(2, 8)
    cuda_x = mock.Mock(is_cuda=True, dtype=torch.float32, dim=lambda: 3)
    assert tdecoder.fused(True, cuda_x, cond)
    assert not tdecoder.fused(False, cuda_x, cond)
    assert not tdecoder.fused(True, x, cond)
    assert not tdecoder.fused(True, mock.Mock(is_cuda=True, dtype=torch.float64, dim=lambda: 3),
                              cond)
    assert not tdecoder.fused(True, cuda_x, torch.zeros(2, 3, 8))


def _ae_grads(ae, batch, plain_unit: bool):
    """The AE step's loss and its gradients in float64, the decoder on the
    composed path or on the plain unit; the BatchNorm buffers put back."""
    saved = {k: v.clone() for k, v in ae.state_dict().items()}
    step = ae_trainer.make_ae_train_step(ae)
    route = (lambda training, x, cond: training and x.dim() == 3 and cond.dim() == 2) \
        if plain_unit else tdecoder.fused
    with mock.patch.object(tdecoder, "fused", route), \
            mock.patch.object(ae_trainer, "on_device",
                              lambda t, d, dtype=None: torch.as_tensor(np.asarray(t),
                                                                       dtype=torch.float64)):
        calls = cb.backward2_ref.calls
        loss, _ = step.loss_fn(batch)
        grads = torch.autograd.grad(loss, list(ae.parameters()), allow_unused=True)
        ran = cb.backward2_ref.calls - calls
    buffers = {k: v.clone() for k, v in ae.state_dict().items()}
    ae.load_state_dict(saved)
    return loss, grads, buffers, ran


def test_ae_loss_gradient_composed_against_plain_unit():
    """The whole AE loss (BCE + the gradient term, its second-order part
    through every CBN unit) and its gradient with respect to every
    parameter, the decoder composed and on the plain unit, float64."""
    cfg = ae_trainer.AETrainConfig(latent_size=8, hidden_dim=16, num_hidden_layers=2)
    ae = ae_trainer.init_ae(cfg, torch.Generator().manual_seed(0)).double()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # no zero kernels: every path carries gradient
        for p in ae.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g, dtype=p.dtype))
    rng = np.random.default_rng(0)
    batch = {"pcd": rng.uniform(-0.5, 0.5, (2, 64, 3)), "coords": rng.uniform(-1, 1, (2, 96, 3)),
             "udf": rng.uniform(0, 0.1, (2, 96)), "gradients": rng.normal(size=(2, 96, 3))}
    loss1, g1, buf1, ran1 = _ae_grads(ae, batch, plain_unit=False)
    loss2, g2, buf2, ran2 = _ae_grads(ae, batch, plain_unit=True)
    assert (ran1, ran2) == (0, 2 * 2 + 1)
    torch.testing.assert_close(loss2, loss1, rtol=1e-12, atol=0)
    for (name, _), u, v in zip(ae.named_parameters(), g2, g1):
        if v is None:
            assert u is None or not u.any(), name
            continue
        torch.testing.assert_close(u, v, rtol=1e-9, atol=1e-12, msg=name)
    for k in buf1:
        assert torch.equal(buf1[k], buf2[k]), k
