"""Plain PyTorch reference of Surf-D's UDF decoder (upstream
`DecoderConditionalBatchNorm`): NeRF positional encoding of the point (the
point, then sin and cos at frequencies 2^0..2^9: 63 features), fc_p, L
conditional residual blocks x + fc_1(relu(cbn_1(fc_0(relu(cbn_0(x)))))), a
last conditional batch norm, relu, fc_out; UDF = (1 − σ(logit))·max_dist.
A conditional batch norm is γ(latent)·(x − mean)/√(var + 1e-5) + β(latent)
with the running statistics (eval mode) and γ, β 1×1 projections of the
latent. Weights: an upstream-layout `decoder.*` state dict (1×1 Conv1d
weights (out, in, 1)).
"""

from __future__ import annotations

import torch

from .precision import F32, Precision

EPS = 1e-5


def posenc(pts: torch.Tensor, num_freqs: int = 10) -> torch.Tensor:
    parts = [pts]
    for i in range(num_freqs):
        f = float(2.0 ** i)
        parts += [torch.sin(pts * f), torch.cos(pts * f)]
    return torch.cat(parts, dim=-1)


def udf(sd: dict, latent: torch.Tensor, pts: torch.Tensor, max_dist: float,
        p: Precision = F32, block: int = 2**16) -> torch.Tensor:
    """(P, 3) points → (P,) UDF for one latent (D,), in blocks of points."""
    layers = sum(1 for k in sd if k.startswith("decoder.blocks.") and k.endswith("fc_0.weight"))

    def lin(key, x):
        return p.linear(x, sd[f"decoder.{key}.weight"][:, :, 0], sd[f"decoder.{key}.bias"])

    def cbn(key, x):
        gamma = lin(f"{key}.conv_gamma", latent[None])[0]
        beta = lin(f"{key}.conv_beta", latent[None])[0]
        mean, var = sd[f"decoder.{key}.bn.running_mean"], sd[f"decoder.{key}.bn.running_var"]
        return gamma * (x - mean) / torch.sqrt(var + EPS) + beta

    out = []
    for s in range(0, len(pts), block):
        x = lin("fc_p", posenc(pts[s:s + block]))
        for i in range(layers):
            b = f"blocks.{i}"
            h = lin(f"{b}.fc_0", torch.relu(cbn(f"{b}.bn_0", x)))
            x = x + lin(f"{b}.fc_1", torch.relu(cbn(f"{b}.bn_1", h)))
        logit = lin("fc_out", torch.relu(cbn("bn", x)))[:, 0]
        out.append((1.0 - torch.sigmoid(logit)) * max_dist)
    return torch.cat(out) if out else pts.new_zeros((0,))
