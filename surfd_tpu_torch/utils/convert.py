"""Weight bridge: Flax variables (nested dicts of numpy arrays) → the port's
state dicts, in the upstream Surf-D layout, and back to the JAX package's
flat-key npz layout for the AE (`decoder_flat_from_state`,
`dgcnn_flat_from_state`) and CLIP (`clip_flat_from_state`).

Layout rules (the inverse of the JAX package's torch converters):
  Flax Dense kernel (in, out)        → Linear weight (out, in):        K.T
  Flax Dense kernel as a 1×1 conv    → Conv1d weight (out, in, 1):     K.T[:, :, None]
  Flax Conv kernel (k, in, out)      → Conv1d weight (out, in, k):     K.transpose(2, 1, 0)
  Flax batch_stats mean/var          → BatchNorm running_mean/var (+ num_batches_tracked)
  Flax BatchNorm scale/bias          → BatchNorm weight/bias

The decoder comes out under `decoder.*`, the denoiser under `Unet.*`, the
encoder unprefixed (`conv_1..5`, `bn_1..5`); the UNet at every setting of
the JAX module (`unet1d_state_from_flax`), the attention blocks
(`attention_state_from_flax`), the classifier half-UNet
(`encoder_unet_state_from_flax`) and the grid AE
(`grid_ae_state_from_flax`, Conv3d kernels (kd, kh, kw, in, out) → (out,
in, kd, kh, kw)) unprefixed. Unlike
the upstream export, the category model keeps its CFG null-class row as the
last row of `label_emb` (upstream checkpoints lack it; `pad_null_class_row`
restores it as zeros). CLIP comes out in OpenAI's layout (`clip_state_from_flax`,
`load_clip`), whose attention packs q, k and v as one `in_proj_weight` (3W, W).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

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


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def decoder_flat_from_state(sd: StateDict) -> Dict[str, np.ndarray]:
    """A `decoder.*` state dict → CbnDecoder's variables as the JAX package's
    flat-key npz (`ae_decoder.npz`: `params/...`, `batch_stats/...`), numpy
    f32; the inverse of `decoder_state_from_flax` (`num_batches_tracked`,
    which flax does not keep, is dropped). Other keys are ignored."""
    out: Dict[str, np.ndarray] = {}

    def conv1x1(name, prefix):
        out[f"params/{name}/kernel"] = _np(sd[f"{prefix}.weight"])[:, :, 0].T
        out[f"params/{name}/bias"] = _np(sd[f"{prefix}.bias"])

    def cbn(name, prefix):
        conv1x1(f"{name}/gamma", f"{prefix}.conv_gamma")
        conv1x1(f"{name}/beta", f"{prefix}.conv_beta")
        out[f"batch_stats/{name}/bn/mean"] = _np(sd[f"{prefix}.bn.running_mean"])
        out[f"batch_stats/{name}/bn/var"] = _np(sd[f"{prefix}.bn.running_var"])

    conv1x1("fc_p", "decoder.fc_p")
    conv1x1("fc_out", "decoder.fc_out")
    i = 0
    while f"decoder.blocks.{i}.fc_0.weight" in sd:
        b = f"decoder.blocks.{i}"
        cbn(f"block_{i}/bn_0", f"{b}.bn_0")
        cbn(f"block_{i}/bn_1", f"{b}.bn_1")
        conv1x1(f"block_{i}/fc_0", f"{b}.fc_0")
        conv1x1(f"block_{i}/fc_1", f"{b}.fc_1")
        i += 1
    cbn("bn_out", "decoder.bn")
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def dgcnn_flat_from_state(sd: StateDict) -> Dict[str, np.ndarray]:
    """The encoder's state dict (`conv_1..5`, `bn_1..5`) → Dgcnn's variables
    as the JAX package's flat-key npz (`ae_encoder.npz`), numpy f32; the
    inverse of `dgcnn_state_from_flax`."""
    out: Dict[str, np.ndarray] = {}
    for i, name in enumerate([f"block{j}" for j in range(1, 5)] + ["head"], 1):
        out[f"params/{name}_conv/kernel"] = _np(sd[f"conv_{i}.weight"]).T
        out[f"params/{name}_bn/scale"] = _np(sd[f"bn_{i}.weight"])
        out[f"params/{name}_bn/bias"] = _np(sd[f"bn_{i}.bias"])
        out[f"batch_stats/{name}_bn/mean"] = _np(sd[f"bn_{i}.running_mean"])
        out[f"batch_stats/{name}_bn/var"] = _np(sd[f"bn_{i}.running_var"])
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    """Keys under `prefix` with it removed (e.g. `decoder.` for CbnDecoder)."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _layernorm(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _cross_attention(sd, prefix, p):
    for n in ("to_q", "to_k", "to_v"):
        _dense(sd, f"{prefix}.{n}", p[n])
    _dense(sd, f"{prefix}.to_out.0", p["to_out"])


def _feed_forward(sd, prefix, p):
    if "geglu" in p:
        _dense(sd, f"{prefix}.net.0.proj", p["geglu"]["proj"])
    else:
        _dense(sd, f"{prefix}.net.0.0", p["fc_in"])
    _dense(sd, f"{prefix}.net.2", p["fc_out"])


def _transformer_block(sd, prefix, p):
    _cross_attention(sd, f"{prefix}.attn1", p["attn1"])
    _cross_attention(sd, f"{prefix}.attn2", p["attn2"])
    _feed_forward(sd, f"{prefix}.ff", p["ff"])
    for n in ("norm1", "norm2", "norm3"):
        _layernorm(sd, f"{prefix}.{n}", p[n])


def _spatial_transformer(sd, prefix, p):
    _groupnorm(sd, f"{prefix}.norm", p["GroupNorm32_0"])
    _dense(sd, f"{prefix}.proj_in", p["proj_in"])
    for i in range(sum(1 for k in p if k.startswith("block_"))):
        _transformer_block(sd, f"{prefix}.transformer_blocks.{i}", p[f"block_{i}"])
    _dense(sd, f"{prefix}.proj_out", p["proj_out"])


def _unprefixed(fill, params) -> StateDict:
    sd: StateDict = {}
    fill(sd, "_", params)
    return {k[2:]: v for k, v in sd.items()}


def attention_state_from_flax(module: str, params) -> StateDict:
    """The Flax params of one block of models/attention.py → the port's
    state dict in upstream `modules/attention.py` keys. module: "GEGLU",
    "FeedForward", "CrossAttention", "BasicTransformerBlock",
    "SpatialTransformer1D" or "LinearAttention"."""
    def geglu(sd, prefix, p):
        _dense(sd, f"{prefix}.proj", p["proj"])

    def linear(sd, prefix, p):
        _dense(sd, f"{prefix}.to_qkv", p["to_qkv"])
        _dense(sd, f"{prefix}.to_out", p["to_out"])

    fills = {"GEGLU": geglu, "FeedForward": _feed_forward, "CrossAttention": _cross_attention,
             "BasicTransformerBlock": _transformer_block,
             "SpatialTransformer1D": _spatial_transformer, "LinearAttention": linear}
    return _unprefixed(fills[module], params)


def _res_block(sd, prefix, p):
    _groupnorm(sd, f"{prefix}.in_layers.0", p["GroupNorm32_0"])
    _convk(sd, f"{prefix}.in_layers.2", p["in_conv"])
    _dense(sd, f"{prefix}.emb_layers.1", p["emb_proj"])
    _groupnorm(sd, f"{prefix}.out_layers.0", p["GroupNorm32_1"])
    _convk(sd, f"{prefix}.out_layers.3", p["out_conv"])
    if "skip" in p:
        _convk(sd, f"{prefix}.skip_connection", p["skip"])


def _attn_site(sd, prefix, p):
    """An attention site: AttentionBlock1D, or a SpatialTransformer1D."""
    if "proj_in" in p:
        _spatial_transformer(sd, prefix, p)
        return
    _groupnorm(sd, f"{prefix}.norm", p["GroupNorm32_0"])
    _convk(sd, f"{prefix}.qkv", p["qkv"])
    _convk(sd, f"{prefix}.proj_out", p["proj_out"])


def _encoder_trunk(sd, net, channel_mult, num_res_blocks, attention_resolutions) -> int:
    """time_embed, input_blocks (and their numbering) and middle_block, as
    UNet1D and EncoderUNet1D share them; returns the downsample rate."""
    _dense(sd, "time_embed.0", net["time_embed_0"])
    _dense(sd, "time_embed.2", net["time_embed_2"])
    _convk(sd, "input_blocks.0.0", net["in_conv"])
    idx, ds = 1, 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            _res_block(sd, f"input_blocks.{idx}.0", net[f"down_{level}_{i}"])
            if ds in attention_resolutions:
                _attn_site(sd, f"input_blocks.{idx}.1", net[f"down_attn_{level}_{i}"])
            idx += 1
        if level != len(channel_mult) - 1:
            if f"downsample_{level}" in net:  # conv_resample=False has no weights
                _convk(sd, f"input_blocks.{idx}.0.op", net[f"downsample_{level}"]["op"])
            idx += 1
            ds *= 2
    _res_block(sd, "middle_block.0", net["mid_res_0"])
    _attn_site(sd, "middle_block.1", net["mid_attn"])
    _res_block(sd, "middle_block.2", net["mid_res_1"])
    return ds


def unet1d_state_from_flax(params, channel_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                           attention_resolutions=(4, 2, 1)) -> StateDict:
    """UNet1D's Flax params → the port's UNet1D state dict (upstream keys), at
    every setting of the JAX module: scale-shift norm (a twice-wide
    `emb_layers.1`), conv_resample off (no resampling weights) and the
    spatial transformer at the attention sites."""
    unet = params
    sd: StateDict = {}
    ds = _encoder_trunk(sd, unet, channel_mult, num_res_blocks, attention_resolutions)
    _groupnorm(sd, "out.0", unet["GroupNorm32_0"])
    _convk(sd, "out.2", unet["out_conv"])
    if "label_emb" in unet:
        sd["label_emb.weight"] = _t(unet["label_emb"]["embedding"])
    if "context_proj" in unet:
        _dense(sd, "sketch_emb", unet["context_proj"])
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            _res_block(sd, f"output_blocks.{idx}.0", unet[f"up_{level}_{i}"])
            pos = 1
            if ds in attention_resolutions:
                _attn_site(sd, f"output_blocks.{idx}.{pos}", unet[f"up_attn_{level}_{i}"])
                pos += 1
            if level and i == num_res_blocks:
                if f"upsample_{level}" in unet:
                    _convk(sd, f"output_blocks.{idx}.{pos}.conv", unet[f"upsample_{level}"]["conv"])
                ds //= 2
            idx += 1
    return sd


def mdm_state_from_flax(variables, channel_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                        attention_resolutions=(4, 2, 1)) -> StateDict:
    """MDM {'params': {'unet': ...}} → `Unet.*` state dict (null row kept)."""
    sd = unet1d_state_from_flax(variables["params"]["unet"], channel_mult, num_res_blocks,
                                attention_resolutions)
    return {"Unet." + k: v for k, v in sd.items()}


def encoder_unet_state_from_flax(variables, channel_mult=(1, 2, 4, 4), num_res_blocks: int = 2,
                                 attention_resolutions=(4, 2, 1), pool: str = "adaptive"
                                 ) -> StateDict:
    """EncoderUNet1D {'params': ...} → the port's state dict in upstream
    `EncoderUNetModel` keys (`time_embed`, `input_blocks`, `middle_block`,
    `out`), which the JAX package's `convert_encoder_unet` reads back."""
    net = variables["params"]
    sd: StateDict = {}
    _encoder_trunk(sd, net, channel_mult, num_res_blocks, attention_resolutions)
    if pool == "adaptive":
        _groupnorm(sd, "out.0", net["GroupNorm32_0"])
        _convk(sd, "out.3", net["out_conv"])
    elif pool == "attention":
        _groupnorm(sd, "out.0", net["GroupNorm32_0"])
        ap = net["attn_pool"]
        sd["out.2.positional_embedding"] = _t(np.asarray(ap["positional_embedding"]).T)
        _convk(sd, "out.2.qkv_proj", ap["qkv_proj"])
        _convk(sd, "out.2.c_proj", ap["c_proj"])
    else:
        _dense(sd, "out.0", net["out_0"])
        if pool == "spatial_v2":
            _groupnorm(sd, "out.1", net["GroupNorm32_0"])
            _dense(sd, "out.3", net["out_3"])
        else:
            _dense(sd, "out.2", net["out_3"])
    return sd


def grid_ae_state_from_flax(variables) -> StateDict:
    """GridAutoencoder {'params': ...} (channel-last Flax) → the port's
    channel-first state dict: Conv kernels (kd, kh, kw, in, out) → (out, in,
    kd, kh, kw), Dense kernels transposed, names as models/grid_ae.py."""
    params = variables["params"]
    sd: StateDict = {}

    def conv3(prefix, p):
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
        sd[f"{prefix}.bias"] = _t(p["bias"])

    def res(prefix, p):
        _groupnorm(sd, f"{prefix}.norm1", p["GroupNorm32_0"])
        conv3(f"{prefix}.conv1", p["conv1"])
        _groupnorm(sd, f"{prefix}.norm2", p["GroupNorm32_1"])
        conv3(f"{prefix}.conv2", p["conv2"])
        if "shortcut" in p:
            conv3(f"{prefix}.shortcut", p["shortcut"])

    conv3("conv_in", params["conv_in"])
    conv3("to_latent", params["to_latent"])
    conv3("from_latent", params["from_latent"])
    conv3("conv_out", params["conv_out"])
    _groupnorm(sd, "out_norm", params["out_norm"])
    attn = params["mid_attn"]
    _groupnorm(sd, "mid_attn.norm", attn["GroupNorm32_0"])
    for n in ("q", "k", "v", "proj_out"):
        _dense(sd, f"mid_attn.{n}", attn[n])
    for kind, fill in (("down_res", res), ("up_res", res),
                       ("downs", lambda pre, p: conv3(f"{pre}.conv", p["Conv_0"])),
                       ("ups", lambda pre, p: conv3(f"{pre}.conv", p["Conv_0"]))):
        i = 0
        while f"{kind}_{i}" in params:
            fill(f"{kind}.{i}", params[f"{kind}_{i}"])
            i += 1
    return sd


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


# ---------------------------------------------------------------------------
# CLIP: the JAX package's Flax parameters and npz, OpenAI `.pt` checkpoints
# ---------------------------------------------------------------------------

# Zoo names → the checkpoint file in the cache directory, with the SHA-256
# that OpenAI publishes for it. Nothing is downloaded.
CLIP_ZOO = {"ViT-B/32": ("ViT-B-32.pt",
                         "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af")}
# Keys of OpenAI's TorchScript state dicts that are settings, not weights.
_CLIP_META_KEYS = ("input_resolution", "context_length", "vocab_size")
_TOWERS = (("visual", "visual.transformer.resblocks"), ("text", "transformer.resblocks"))


def _clip_block_from_flax(sd, prefix, p):
    width = np.asarray(p["ln_1"]["scale"]).shape[0]
    sd[f"{prefix}.ln_1.weight"], sd[f"{prefix}.ln_1.bias"] = _t(p["ln_1"]["scale"]), _t(p["ln_1"]["bias"])
    sd[f"{prefix}.ln_2.weight"], sd[f"{prefix}.ln_2.bias"] = _t(p["ln_2"]["scale"]), _t(p["ln_2"]["bias"])
    attn = p["attn"]
    # Flax MHA kernels (W, heads, head_dim) → rows of the packed (3W, W) weight
    sd[f"{prefix}.attn.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(attn[n]["kernel"]).reshape(width, width).T for n in ("query", "key", "value")]))
    sd[f"{prefix}.attn.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(attn[n]["bias"]).reshape(width) for n in ("query", "key", "value")]))
    sd[f"{prefix}.attn.out_proj.weight"] = _t(np.asarray(attn["out"]["kernel"]).reshape(width, width).T)
    sd[f"{prefix}.attn.out_proj.bias"] = _t(attn["out"]["bias"])
    _dense(sd, f"{prefix}.mlp.c_fc", p["mlp_fc"])
    _dense(sd, f"{prefix}.mlp.c_proj", p["mlp_proj"])


def clip_state_from_flax(variables) -> StateDict:
    """The JAX package's CLIP variables ({'params': {'visual', 'text'}}) →
    the port's state dict in OpenAI's layout (the inverse of
    `convert_torch_clip_state_dict`); `logit_scale`, which the JAX towers do
    not hold, at OpenAI's initial log(1 / 0.07)."""
    params = variables["params"]
    vis, txt = params["visual"], params["text"]
    sd: StateDict = {
        # Flax conv (kh, kw, in, out) → torch (out, in, kh, kw)
        "visual.conv1.weight": _t(np.asarray(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1)),
        "visual.class_embedding": _t(vis["class_embedding"]),
        "visual.positional_embedding": _t(vis["positional_embedding"]),
        "visual.ln_pre.weight": _t(vis["ln_pre"]["scale"]),
        "visual.ln_pre.bias": _t(vis["ln_pre"]["bias"]),
        "visual.ln_post.weight": _t(vis["ln_post"]["scale"]),
        "visual.ln_post.bias": _t(vis["ln_post"]["bias"]),
        "visual.proj": _t(vis["proj"]),
        "token_embedding.weight": _t(txt["token_embedding"]["embedding"]),
        "positional_embedding": _t(txt["positional_embedding"]),
        "ln_final.weight": _t(txt["ln_final"]["scale"]),
        "ln_final.bias": _t(txt["ln_final"]["bias"]),
        "text_projection": _t(txt["text_projection"]),
        "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32),
    }
    for tower, prefix in _TOWERS:
        blocks = params[tower]
        for i in range(sum(1 for k in blocks if k.startswith("block_"))):
            _clip_block_from_flax(sd, f"{prefix}.{i}", blocks[f"block_{i}"])
    return sd


def clip_flat_from_state(state) -> dict:
    """The port's CLIP state dict → the JAX package's flat-key npz layout
    (`params/visual/...`, `params/text/...`: `save_params_npz` of the
    variables `convert_torch_clip_state_dict` makes), numpy f32."""
    g = {k: v.detach().float().cpu().numpy() for k, v in state.items()}
    out = {
        "params/visual/conv1/kernel": g["visual.conv1.weight"].transpose(2, 3, 1, 0),
        "params/visual/class_embedding": g["visual.class_embedding"],
        "params/visual/positional_embedding": g["visual.positional_embedding"],
        "params/visual/ln_pre/scale": g["visual.ln_pre.weight"],
        "params/visual/ln_pre/bias": g["visual.ln_pre.bias"],
        "params/visual/ln_post/scale": g["visual.ln_post.weight"],
        "params/visual/ln_post/bias": g["visual.ln_post.bias"],
        "params/visual/proj": g["visual.proj"],
        "params/text/token_embedding/embedding": g["token_embedding.weight"],
        "params/text/positional_embedding": g["positional_embedding"],
        "params/text/ln_final/scale": g["ln_final.weight"],
        "params/text/ln_final/bias": g["ln_final.bias"],
        "params/text/text_projection": g["text_projection"],
    }
    for tower, prefix in _TOWERS:
        i = 0
        while f"{prefix}.{i}.ln_1.weight" in g:
            src, dst = f"{prefix}.{i}", f"params/{tower}/block_{i}"
            width = g[f"{src}.ln_1.weight"].shape[0]
            heads = max(width // 64, 1)
            for ln in ("ln_1", "ln_2"):
                out[f"{dst}/{ln}/scale"] = g[f"{src}.{ln}.weight"]
                out[f"{dst}/{ln}/bias"] = g[f"{src}.{ln}.bias"]
            ws = np.split(g[f"{src}.attn.in_proj_weight"], 3)
            bs = np.split(g[f"{src}.attn.in_proj_bias"], 3)
            for name, w, b in zip(("query", "key", "value"), ws, bs):
                out[f"{dst}/attn/{name}/kernel"] = w.T.reshape(width, heads, width // heads)
                out[f"{dst}/attn/{name}/bias"] = b.reshape(heads, width // heads)
            out[f"{dst}/attn/out/kernel"] = g[f"{src}.attn.out_proj.weight"].T.reshape(
                heads, width // heads, width)
            out[f"{dst}/attn/out/bias"] = g[f"{src}.attn.out_proj.bias"]
            for fl, tl in (("mlp_fc", "c_fc"), ("mlp_proj", "c_proj")):
                out[f"{dst}/{fl}/kernel"] = g[f"{src}.mlp.{tl}.weight"].T
                out[f"{dst}/{fl}/bias"] = g[f"{src}.mlp.{tl}.bias"]
            i += 1
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def _clip_from_state(sd: StateDict):
    from ..models.clip import Clip, clip_config_from_state

    model = Clip(**clip_config_from_state(sd))
    model.load_state_dict(sd, strict=True)
    return model


def load_clip_params(npz_path: str):
    """A Clip module (eval, CPU) from the JAX package's CLIP npz
    (`save_clip_params` of either package); the configuration is read from
    the shapes."""
    return _clip_from_state(clip_state_from_flax(load_flax_npz(npz_path)))


def save_clip_params(npz_path: str, model) -> None:
    """A Clip module's weights as the JAX package's flat-key npz, which its
    `load_clip_params` reads."""
    np.savez(npz_path, **clip_flat_from_state(model.state_dict()))


def _clip_cache_dir() -> str:
    """Where the JAX package caches zoo checkpoints: $SURFD_CLIP_CACHE, else
    ~/.cache/surfd_tpu/clip."""
    return os.environ.get("SURFD_CLIP_CACHE",
                          os.path.join(os.path.expanduser("~"), ".cache", "surfd_tpu", "clip"))


def _read_pt(path: str) -> StateDict:
    """An OpenAI `.pt` (TorchScript, or a plain state dict) as an f32 state
    dict without its setting keys."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float() for k, v in sd.items() if k not in _CLIP_META_KEYS}


def load_clip(name_or_path: str = "ViT-B/32", cache_dir: Optional[str] = None):
    """A Clip module (eval, CPU, f32) from a `.npz` in the JAX package's
    layout, an OpenAI `.pt`, or a zoo name whose checkpoint is already in the
    cache directory (checked against its published SHA-256). Never downloads:
    a missing checkpoint raises with where to put it."""
    if name_or_path.endswith(".npz"):
        return load_clip_params(name_or_path)
    if name_or_path.endswith(".pt"):
        return _clip_from_state(_read_pt(name_or_path))
    if name_or_path not in CLIP_ZOO:
        raise KeyError(f"unknown CLIP model {name_or_path!r}; available: {list(CLIP_ZOO)}")
    fname, sha = CLIP_ZOO[name_or_path]
    path = os.path.join(cache_dir or _clip_cache_dir(), fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{name_or_path}: no checkpoint at {path}. This package does not download; "
            f"place OpenAI's {fname} there (or set SURFD_CLIP_CACHE), or pass a .pt or "
            ".npz path to load_clip")
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    if h.hexdigest() != sha:
        raise RuntimeError(f"{path}: SHA-256 {h.hexdigest()} is not the published {sha}")
    return _clip_from_state(_read_pt(path))
