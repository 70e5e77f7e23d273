"""Weights from the seed, made on the device in the upstream state-dict
layouts, and the planted sheet decoder.

A state dict comes from one `torch.randn` on the device (one generator,
seeded from the run's seed and the model's name), cut into the tensors that
a reference's `param_specs` lists and scaled by kind: LeCun-normal weights
(std 1/√fan_in), biases N(0, 0.02²), norm scales 1 + N(0, 0.05²), embeddings
at their stated std. The program loads these with `load_state_dict`; the
reference reads the same tensors.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for one named stream of draws of a run."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(name.encode())) % (2**63)


def seeded_state(specs: list, seed: int, name: str, device) -> dict:
    """{key: tensor} for [(key, shape, kind)] specs; the tensors are views of
    one buffer."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, name))
    total = sum(math.prod(shape) for _, shape, _ in specs)
    buf = torch.randn(total, generator=g, device=device)
    sd, off = {}, 0
    for key, shape, kind in specs:
        n = math.prod(shape)
        x = buf[off:off + n].view(shape)
        off += n
        if kind == "fan_in":
            x.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
        elif kind == "fan_in_rows":  # a (in, out) projection matrix
            x.mul_(1.0 / math.sqrt(shape[0]))
        elif kind == "bias":
            x.mul_(0.02)
        elif kind == "norm":
            x.mul_(0.05).add_(1.0)
        elif kind.startswith("embed"):
            x.mul_(float(kind.split(":")[1]) if ":" in kind else 1.0)
        else:
            raise ValueError(f"unknown kind {kind} of {key}")
        sd[key] = x
    return sd


def planted_decoder_state(path: str, latent_size: int, device) -> dict:
    """The shipped sheet decoder as an upstream `decoder.*` state dict at
    `latent_size`, with its latent projections folded into their biases at
    the file's own latent (projection weights zero): it draws the file's
    sheet whatever latent it is given. The file holds flax leaves (f16):
    `dec/params/...` kernels (in, out) and `dec/batch_stats/...`."""
    sd = {}
    with np.load(path) as z:
        lat = np.asarray(z["latent"], np.float32)
        p = lambda k: np.asarray(z[f"dec/params/{k}"], np.float32)
        s = lambda k: np.asarray(z[f"dec/batch_stats/{k}"], np.float32)
        layers = int(z["num_hidden_layers"])

        def conv(key, src):
            sd[f"decoder.{key}.weight"] = p(f"{src}/kernel").T[:, :, None]
            sd[f"decoder.{key}.bias"] = p(f"{src}/bias")

        def cbn(key, src):
            for gb in ("gamma", "beta"):
                k = p(f"{src}/{gb}/kernel")
                sd[f"decoder.{key}.conv_{gb}.weight"] = np.zeros((k.shape[1], latent_size, 1),
                                                                 np.float32)
                sd[f"decoder.{key}.conv_{gb}.bias"] = lat @ k + p(f"{src}/{gb}/bias")
            sd[f"decoder.{key}.bn.running_mean"] = s(f"{src}/bn/mean")
            sd[f"decoder.{key}.bn.running_var"] = s(f"{src}/bn/var")

        conv("fc_p", "fc_p")
        for i in range(layers):
            cbn(f"blocks.{i}.bn_0", f"block_{i}/bn_0")
            conv(f"blocks.{i}.fc_0", f"block_{i}/fc_0")
            cbn(f"blocks.{i}.bn_1", f"block_{i}/bn_1")
            conv(f"blocks.{i}.fc_1", f"block_{i}/fc_1")
        cbn("bn", "bn_out")
        conv("fc_out", "fc_out")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in sd.items()}


def sheet_surface(path: str, device) -> torch.Tensor:
    """(S, 3) samples of the planted sheet's ground-truth surface."""
    with np.load(path) as z:
        return torch.from_numpy(np.asarray(z["surface_samples"], np.float32)).to(device)
