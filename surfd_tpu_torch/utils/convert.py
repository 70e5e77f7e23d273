"""Weight bridge: Flax variables (nested dicts of numpy arrays) → the port's
state dicts, in the upstream Surf-D layout.

Layout rules (the inverse of the JAX package's torch converters):
  Flax Dense kernel (in, out)        → Linear weight (out, in):        K.T
  Flax Dense kernel as a 1×1 conv    → Conv1d weight (out, in, 1):     K.T[:, :, None]
  Flax Conv kernel (k, in, out)      → Conv1d weight (out, in, k):     K.transpose(2, 1, 0)
  Flax batch_stats mean/var          → BatchNorm running_mean/var (+ num_batches_tracked)
  Flax BatchNorm scale/bias          → BatchNorm weight/bias

The decoder comes out under `decoder.*`, the denoiser under `Unet.*`, the
encoder unprefixed (`conv_1..5`, `bn_1..5`). Unlike
the upstream export, the category model keeps its CFG null-class row as the
last row of `label_emb` (upstream checkpoints lack it; `pad_null_class_row`
restores it as zeros).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1x1(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _convk(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _bn_stats(sd, prefix, stats):
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _groupnorm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["GroupNorm_0"]["scale"])
    sd[f"{prefix}.bias"] = _t(p["GroupNorm_0"]["bias"])


def decoder_state_from_flax(variables) -> StateDict:
    """CbnDecoder {'params', 'batch_stats'} → `decoder.*` state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    layers = sum(1 for k in params if k.startswith("block_"))
    sd: StateDict = {}

    def cbn(prefix, p, s):
        _conv1x1(sd, f"{prefix}.conv_gamma", p["gamma"])
        _conv1x1(sd, f"{prefix}.conv_beta", p["beta"])
        _bn_stats(sd, f"{prefix}.bn", s["bn"])

    _conv1x1(sd, "decoder.fc_p", params["fc_p"])
    _conv1x1(sd, "decoder.fc_out", params["fc_out"])
    for i in range(layers):
        b = f"decoder.blocks.{i}"
        p, s = params[f"block_{i}"], stats[f"block_{i}"]
        cbn(f"{b}.bn_0", p["bn_0"], s["bn_0"])
        cbn(f"{b}.bn_1", p["bn_1"], s["bn_1"])
        _conv1x1(sd, f"{b}.fc_0", p["fc_0"])
        _conv1x1(sd, f"{b}.fc_1", p["fc_1"])
    cbn("decoder.bn", params["bn_out"], stats["bn_out"])
    return sd


def dgcnn_state_from_flax(variables) -> StateDict:
    """Dgcnn {'params', 'batch_stats'} → the upstream encoder state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    names = [f"block{i}" for i in range(1, 5)] + ["head"]
    sd: StateDict = {}
    for i, name in enumerate(names, 1):
        _dense(sd, f"conv_{i}", params[f"{name}_conv"])
        bn = params[f"{name}_bn"]
        sd[f"bn_{i}.weight"] = _t(bn["scale"])
        sd[f"bn_{i}.bias"] = _t(bn["bias"])
        _bn_stats(sd, f"bn_{i}", stats[f"{name}_bn"])
    return sd


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    """Keys under `prefix` with it removed (e.g. `decoder.` for CbnDecoder)."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def mdm_state_from_flax(variables, channel_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                        attention_resolutions=(4, 2, 1)) -> StateDict:
    """MDM {'params': {'unet': ...}} → `Unet.*` state dict (null row kept)."""
    unet = variables["params"]["unet"]
    sd: StateDict = {}

    def res(prefix, p):
        _groupnorm(sd, f"{prefix}.in_layers.0", p["GroupNorm32_0"])
        _convk(sd, f"{prefix}.in_layers.2", p["in_conv"])
        _dense(sd, f"{prefix}.emb_layers.1", p["emb_proj"])
        _groupnorm(sd, f"{prefix}.out_layers.0", p["GroupNorm32_1"])
        _convk(sd, f"{prefix}.out_layers.3", p["out_conv"])
        if "skip" in p:
            _convk(sd, f"{prefix}.skip_connection", p["skip"])

    def attn(prefix, p):
        _groupnorm(sd, f"{prefix}.norm", p["GroupNorm32_0"])
        _convk(sd, f"{prefix}.qkv", p["qkv"])
        _convk(sd, f"{prefix}.proj_out", p["proj_out"])

    _dense(sd, "time_embed.0", unet["time_embed_0"])
    _dense(sd, "time_embed.2", unet["time_embed_2"])
    _convk(sd, "input_blocks.0.0", unet["in_conv"])
    _groupnorm(sd, "out.0", unet["GroupNorm32_0"])
    _convk(sd, "out.2", unet["out_conv"])
    if "label_emb" in unet:
        sd["label_emb.weight"] = _t(unet["label_emb"]["embedding"])
    if "context_proj" in unet:
        _dense(sd, "sketch_emb", unet["context_proj"])

    idx, ds = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            res(f"input_blocks.{idx}.0", unet[f"down_{level}_{i}"])
            if ds in attention_resolutions:
                attn(f"input_blocks.{idx}.1", unet[f"down_attn_{level}_{i}"])
            idx += 1
        if level != len(channel_mult) - 1:
            _convk(sd, f"input_blocks.{idx}.0.op", unet[f"downsample_{level}"]["op"])
            idx += 1
            ds *= 2

    res("middle_block.0", unet["mid_res_0"])
    attn("middle_block.1", unet["mid_attn"])
    res("middle_block.2", unet["mid_res_1"])

    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            res(f"output_blocks.{idx}.0", unet[f"up_{level}_{i}"])
            pos = 1
            if ds in attention_resolutions:
                attn(f"output_blocks.{idx}.{pos}", unet[f"up_attn_{level}_{i}"])
                pos += 1
            if level and i == num_res_blocks:
                _convk(sd, f"output_blocks.{idx}.{pos}.conv", unet[f"upsample_{level}"]["conv"])
                ds //= 2
            idx += 1
    return {"Unet." + k: v for k, v in sd.items()}


def pad_null_class_row(sd: StateDict, num_actions: int) -> StateDict:
    """Append the zero CFG null-class row to an upstream `label_emb` that
    has exactly `num_actions` rows; other state dicts pass through."""
    key = "Unet.label_emb.weight"
    if key in sd and sd[key].shape[0] == num_actions:
        w = sd[key]
        sd = dict(sd)
        sd[key] = torch.cat([w, torch.zeros_like(w[:1])], dim=0)
    return sd


def nest_flat_keys(flat: dict, prefix: str = "") -> dict:
    """{'a/b/c': x} → {'a': {'b': {'c': x}}} for the keys under `prefix`."""
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def load_flax_npz(path: str) -> dict:
    """Flax variables from a flat npz (`params/...`, `batch_stats/...` keys):
    the JAX package's `ae_decoder.npz` or `ae_encoder.npz`."""
    with np.load(path) as z:
        flat = {k: np.asarray(z[k], np.float32) for k in z.files}
    return nest_flat_keys(flat)



def load_sheet_fixture(path: str) -> dict:
    """The shipped trained sheet decoder (`bench_sheet_decoder.npz`).

    Returns `state_dict` (`decoder.*`, f32 — the file stores f16 leaves),
    `latent` (D,) f32, `max_dist`, `hidden_dim`, `num_hidden_layers` and
    `surface_samples` (S, 3) f32 of the ground-truth surface.
    """
    with np.load(path) as z:
        flat = {k: np.asarray(z[k], np.float32) for k in z.files if k.startswith("dec/")}
        out = {
            "latent": np.asarray(z["latent"], np.float32),
            "max_dist": float(z["max_dist"]),
            "hidden_dim": int(z["hidden_dim"]),
            "num_hidden_layers": int(z["num_hidden_layers"]),
            "surface_samples": np.asarray(z["surface_samples"], np.float32),
        }
    out["state_dict"] = decoder_state_from_flax(nest_flat_keys(flat, "dec/"))
    return out
