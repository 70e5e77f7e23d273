"""Plain PyTorch reference of Surf-D's AutoEncoder train step (upstream
`train_ae`): the DGCNN encoder (k nearest neighbours of each point by exact
squared distance, itself included; four edge convolutions of widths 64, 64,
128, 256, each a bias-free linear map of [x_j − x_i, x_i], BatchNorm,
LeakyReLU 0.2 and the max over the neighbours; a linear map of their
concatenation to the latent, BatchNorm, LeakyReLU and the max over the
points), the CBN decoder in train mode, BCE on 1 − udf/max_dist against the
decoder's logits, plus 0.1 × the masked squared error of ∂udf/∂query against
the labels' gradients (the second-order term: that gradient is kept in the
graph), AdamW.

BatchNorm in train mode takes the batch's statistics over every axis but
the features: the mean and the biased variance E[x²] − E[x]², clipped at 0
(flax's), kept in the graph. Weights: the encoder's upstream state dict
under `encoder.` (linear weights (out, in), `bn_i` scale and shift) and the
decoder's under `decoder.`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import decoder as ref_decoder
from .precision import F32, Precision

WIDTHS = (64, 64, 128, 256)
EPS = 1e-5


def param_specs(cfg: dict) -> list:
    """[(key, shape, kind)] of the AE's parameters (kinds as in
    `reference.mdm.param_specs`); the BatchNorm running statistics, which a
    train step does not read, are buffers and not listed."""
    specs, d = [], 3
    for i, w in enumerate(WIDTHS, 1):
        specs += [(f"encoder.conv_{i}.weight", (w, 2 * d), "fan_in"),
                  (f"encoder.bn_{i}.weight", (w,), "norm"), (f"encoder.bn_{i}.bias", (w,), "bias")]
        d = w
    L, H, D = cfg["latent_size"], cfg["hidden_dim"], cfg["num_hidden_layers"]
    specs += [("encoder.conv_5.weight", (L, sum(WIDTHS)), "fan_in"),
              ("encoder.bn_5.weight", (L,), "norm"), ("encoder.bn_5.bias", (L,), "bias")]

    def conv(key, cin, cout, bias_kind="bias"):
        specs.extend([(f"decoder.{key}.weight", (cout, cin, 1), "fan_in"),
                      (f"decoder.{key}.bias", (cout,), bias_kind)])

    def cbn(key):
        conv(f"{key}.conv_gamma", L, H, "norm")
        conv(f"{key}.conv_beta", L, H)

    conv("fc_p", 63, H)
    for i in range(D):
        cbn(f"blocks.{i}.bn_0")
        conv(f"blocks.{i}.fc_0", H, H)
        cbn(f"blocks.{i}.bn_1")
        conv(f"blocks.{i}.fc_1", H, H)
    cbn("bn")
    conv("fc_out", H, 1)
    return specs


def batch_norm(x: torch.Tensor, scale=None, shift=None) -> torch.Tensor:
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(0)
    var = torch.clamp(flat.square().mean(0) - mean.square(), min=0.0)
    y = (x - mean) * torch.rsqrt(var + EPS)
    if scale is not None:
        y = y * scale
    return y if shift is None else y + shift


def knn(points: torch.Tensor, k: int, p: Precision, block: int = 2048) -> torch.Tensor:
    """(B, N, k) indices of each point's k nearest, by |q|² − 2q·p + |p|²."""
    sq = points.square().sum(-1)
    out = []
    for s in range(0, points.shape[1], block):
        d = sq[:, s:s + block, None] - 2.0 * p.einsum("bnc,bmc->bnm", points[:, s:s + block],
                                                       points) + sq[:, None, :]
        out.append(d.topk(k, dim=-1, largest=False).indices)
    return torch.cat(out, dim=1)


def encode(sd: dict, pcd: torch.Tensor, k: int, p: Precision = F32) -> torch.Tensor:
    """(B, N, 3) clouds → (B, latent), BatchNorm on the batch."""
    with torch.no_grad():
        idx = knn(pcd, k, p)
    B = pcd.shape[0]
    bidx = torch.arange(B, device=pcd.device)[:, None, None]
    f, feats = pcd, []
    for i in range(1, len(WIDTHS) + 1):
        nb = f[bidx, idx]
        center = f[:, :, None, :].expand_as(nb)
        e = p.linear(torch.cat([nb - center, center], dim=-1), sd[f"encoder.conv_{i}.weight"])
        e = F.leaky_relu(batch_norm(e, sd[f"encoder.bn_{i}.weight"], sd[f"encoder.bn_{i}.bias"]), 0.2)
        f = e.amax(dim=2)
        feats.append(f)
    z = p.linear(torch.cat(feats, dim=-1), sd["encoder.conv_5.weight"])
    z = F.leaky_relu(batch_norm(z, sd["encoder.bn_5.weight"], sd["encoder.bn_5.bias"]), 0.2)
    return z.amax(dim=1)


def decode_logits(sd: dict, coords: torch.Tensor, latent: torch.Tensor, layers: int,
                  p: Precision = F32) -> torch.Tensor:
    """(B, Q, 3) queries and (B, latent) codes → (B, Q) logits, the
    conditional batch norms on the batch's statistics."""

    def lin(key, x):
        return p.linear(x, sd[f"decoder.{key}.weight"][:, :, 0], sd[f"decoder.{key}.bias"])

    def cbn(key, x):
        gamma = lin(f"{key}.conv_gamma", latent)[:, None, :]
        beta = lin(f"{key}.conv_beta", latent)[:, None, :]
        return gamma * batch_norm(x) + beta

    x = lin("fc_p", ref_decoder.posenc(coords))
    for i in range(layers):
        b = f"blocks.{i}"
        h = lin(f"{b}.fc_0", torch.relu(cbn(f"{b}.bn_0", x)))
        x = x + lin(f"{b}.fc_1", torch.relu(cbn(f"{b}.bn_1", h)))
    return lin("fc_out", torch.relu(cbn("bn", x)))[..., 0]


def loss(params: dict, batch: dict, cfg: dict, p: Precision = F32) -> torch.Tensor:
    md = cfg["max_dist"]
    coords = batch["coords"].detach().requires_grad_(True)
    latent = encode(params, batch["pcd"], cfg["k"], p)
    logits = decode_logits(params, coords, latent, cfg["num_hidden_layers"], p)
    udf = (1.0 - torch.sigmoid(logits)) * md
    g = torch.autograd.grad(udf, coords, torch.ones_like(udf), create_graph=True)[0]
    target = 1.0 - batch["udf"] / md
    bce = F.binary_cross_entropy_with_logits(logits, target)
    mask = (target > 0.0) & (target < 1.0)
    err = torch.where(mask[..., None], (g - batch["gradients"]).square(), 0.0)
    return bce + cfg["grad_loss_weight"] * err.sum() / torch.clamp(mask.sum() * 3, min=1)


def run(sd0: dict, cfg: dict, batches: list, opt: dict, p: Precision = F32) -> dict:
    """The first steps from sd0 on the given device batches: {"losses",
    "grad" (the first step's, by leaf), "delta" (the change after them)}."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in sd0.items()}
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    for i, batch in enumerate(batches, 1):
        value = loss(params, batch, cfg, p)
        grads = torch.autograd.grad(value, list(params.values()))
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(params, grads)}
        lr = max(opt["lr"] * opt["decay_rate"] ** ((i - 1) // opt["decay_every"]), opt["lr_floor"])
        with torch.no_grad():
            for (k, prm), g in zip(params.items(), grads):
                prm.mul_(1.0 - lr * opt["weight_decay"])
                m1[k].mul_(b1).add_(g, alpha=1 - b1)
                m2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                prm.sub_(lr / (1 - b1 ** i) * m1[k] / ((m2[k] / (1 - b2 ** i)).sqrt() + eps))
        del value, grads
    return {"losses": losses, "grad": first,
            "delta": {k: v.detach() - sd0[k] for k, v in params.items()}}
