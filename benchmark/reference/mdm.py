"""Plain PyTorch reference of Surf-D's denoiser: the MDM facade around the
guided-diffusion 1-D UNet (upstream `models/mdm.py:34-57`), as a function of
an upstream-layout state dict (`Unet.*` keys).

The UNet: a 3-tap input convolution; per level `num_res_blocks` residual
blocks (GroupNorm(32) → SiLU → conv, the time embedding added before the
second GroupNorm → SiLU → conv, a 1×1 skip where the width changes), each
followed by self-attention (QKVAttentionLegacy, one 1×1 qkv convolution,
softmax over keys of (q·s)(k·s), s = c^-1/4) at downsample rates in
`attention_resolutions`; a stride-2 convolution between levels; a middle
res-attn-res; the mirrored output levels with the skips concatenated and a
nearest ×2 upsample then a convolution; GroupNorm → SiLU → conv out. The time
embedding is the [cos | sin] sinusoid through Linear → SiLU → Linear; a
category adds `label_emb`, a context (text, sketch, image) adds
`sketch_emb(context)` to it.

`param_specs` lists every tensor with its upstream key, shape and kind, so
that the benchmark can make weights from a seed without the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision

GROUPS = 32


def _layout(cfg: dict):
    """The UNet as a list of (block prefix, [layer specs]) in state-dict
    order; a layer spec is ("conv_in", cin, cout), ("res", cin, cout),
    ("attn", ch), ("down", ch) or ("up", ch)."""
    mc = cfg["model_channels"]
    mult = cfg["channel_mult"]
    nrb = cfg["num_res_blocks"]
    attn_res = cfg["attention_resolutions"]
    blocks = [("input_blocks.0", [("conv_in", cfg.get("in_channels", 1), mc)])]
    ch, chans, ds = mc, [mc], 1
    for level, m in enumerate(mult):
        for _ in range(nrb):
            layers = [("res", ch, m * mc)]
            ch = m * mc
            if ds in attn_res:
                layers.append(("attn", ch))
            blocks.append((f"input_blocks.{len(blocks)}", layers))
            chans.append(ch)
        if level != len(mult) - 1:
            blocks.append((f"input_blocks.{len(blocks)}", [("down", ch)]))
            chans.append(ch)
            ds *= 2
    blocks.append(("middle_block", [("res", ch, ch), ("attn", ch), ("res", ch, ch)]))
    k = 0
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nrb + 1):
            layers = [("res", ch + chans.pop(), m * mc)]
            ch = m * mc
            if ds in attn_res:
                layers.append(("attn", ch))
            if level and i == nrb:
                layers.append(("up", ch))
                ds //= 2
            blocks.append((f"output_blocks.{k}", layers))
            k += 1
    return blocks, ch


def param_specs(cfg: dict) -> list:
    """[(key, shape, kind)] of the denoiser's state dict; kind is "fan_in"
    (a weight drawn with std 1/√fan_in), "bias", "norm" (a norm's scale) or
    "embed" (an embedding table, std 1)."""
    mc = cfg["model_channels"]
    ted = 4 * mc
    specs = []

    def conv(key, cin, cout, k):
        specs.extend([(f"{key}.weight", (cout, cin, k), "fan_in"), (f"{key}.bias", (cout,), "bias")])

    def lin(key, cin, cout):
        specs.extend([(f"{key}.weight", (cout, cin), "fan_in"), (f"{key}.bias", (cout,), "bias")])

    def norm(key, c):
        specs.extend([(f"{key}.weight", (c,), "norm"), (f"{key}.bias", (c,), "bias")])

    lin("Unet.time_embed.0", mc, ted)
    lin("Unet.time_embed.2", ted, ted)
    if cfg["cond_mode"] == "category":
        specs.append(("Unet.label_emb.weight", (cfg["num_actions"] + 1, ted), "embed"))
    elif cfg["cond_mode"] in ("text", "sketch", "img"):
        lin("Unet.sketch_emb", cfg["context_dim"], ted)
    blocks, ch = _layout(cfg)
    for prefix, layers in blocks:
        for j, spec in enumerate(layers):
            key = f"Unet.{prefix}.{j}"
            kind = spec[0]
            if kind == "conv_in":
                conv(key, spec[1], spec[2], 3)
            elif kind == "res":
                cin, cout = spec[1], spec[2]
                norm(f"{key}.in_layers.0", cin)
                conv(f"{key}.in_layers.2", cin, cout, 3)
                lin(f"{key}.emb_layers.1", ted, cout)
                norm(f"{key}.out_layers.0", cout)
                conv(f"{key}.out_layers.3", cout, cout, 3)
                if cin != cout:
                    conv(f"{key}.skip_connection", cin, cout, 1)
            elif kind == "attn":
                norm(f"{key}.norm", spec[1])
                conv(f"{key}.qkv", spec[1], 3 * spec[1], 1)
                conv(f"{key}.proj_out", spec[1], spec[1], 1)
            elif kind == "down":
                conv(f"{key}.op", spec[1], spec[1], 3)
            else:  # up
                conv(f"{key}.conv", spec[1], spec[1], 3)
    norm("Unet.out.0", ch)
    conv("Unet.out.2", mc, cfg.get("out_channels", 1), 3)
    return specs


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def attention(qkv: torch.Tensor, heads: int, p: Precision) -> torch.Tensor:
    """QKVAttentionLegacy: (B, 3·H·c, T) → (B, H·c, T)."""
    B, W, T = qkv.shape
    c = W // (3 * heads)
    q, k, v = qkv.reshape(B * heads, 3 * c, T).split(c, dim=1)
    s = 1.0 / math.sqrt(math.sqrt(c))
    w = torch.softmax(p.einsum("bct,bcs->bts", q * s, k * s), dim=-1)
    return p.einsum("bts,bcs->bct", w, v).reshape(B, heads * c, T)


def forward(sd: dict, cfg: dict, x: torch.Tensor, t: torch.Tensor, y=None, context=None,
            p: Precision = F32) -> torch.Tensor:
    """The denoiser: (B, L, 1) latents at steps t (B,) → (B, L, 1) x₀."""
    mc = cfg["model_channels"]

    def w(key):
        return sd[f"Unet.{key}.weight"], sd[f"Unet.{key}.bias"]

    def lin(key, h):
        return p.linear(h, *w(key))

    def conv(key, h, stride=1, padding=1):
        return p.conv1d(h, *w(key), stride=stride, padding=padding)

    def gn(key, h):
        groups = GROUPS
        while h.shape[1] % groups:  # narrow test widths
            groups //= 2
        return F.group_norm(h, groups, *w(key), eps=1e-5)

    emb = lin("time_embed.2", F.silu(lin("time_embed.0", timestep_embedding(t, mc))))
    if y is not None:
        emb = emb + sd["Unet.label_emb.weight"][y]
    if context is not None:
        emb = emb + lin("sketch_emb", context)

    def res(key, h):
        a = conv(f"{key}.in_layers.2", F.silu(gn(f"{key}.in_layers.0", h)))
        a = a + lin(f"{key}.emb_layers.1", F.silu(emb))[:, :, None]
        a = conv(f"{key}.out_layers.3", F.silu(gn(f"{key}.out_layers.0", a)))
        skip = conv(f"{key}.skip_connection", h, padding=0) if f"Unet.{key}.skip_connection.weight" in sd else h
        return skip + a

    def attn(key, h):
        qkv = conv(f"{key}.qkv", gn(f"{key}.norm", h), padding=0)
        return h + conv(f"{key}.proj_out", attention(qkv, cfg["num_heads"], p), padding=0)

    def run(prefix, layers, h):
        for j, spec in enumerate(layers):
            key = f"{prefix}.{j}"
            kind = spec[0]
            if kind == "conv_in":
                h = conv(key, h)
            elif kind == "res":
                h = res(key, h)
            elif kind == "attn":
                h = attn(key, h)
            elif kind == "down":
                h = conv(f"{key}.op", h, stride=2)
            else:
                h = conv(f"{key}.conv", F.interpolate(h, scale_factor=2, mode="nearest"))
        return h

    blocks, _ = _layout(cfg)
    h = x.permute(0, 2, 1)
    hs = []
    for prefix, layers in blocks:
        if prefix.startswith("input_blocks"):
            h = run(prefix, layers, h)
            hs.append(h)
        elif prefix == "middle_block":
            h = run(prefix, layers, h)
        else:
            h = run(prefix, layers, torch.cat([h, hs.pop()], dim=1))
    h = conv("out.2", F.silu(gn("out.0", h)))
    return h.permute(0, 2, 1)


def guided(sd: dict, cfg: dict, scale: float, y=None, context=None, p: Precision = F32):
    """model_fn(x, t) with classifier-free guidance: uncond + s·(cond − uncond),
    the unconditional branch the null class (category) or a zero context;
    at s = 1 the conditional model alone."""
    if scale == 1.0:
        return lambda x, t: forward(sd, cfg, x, t, y=y, context=context, p=p)

    def fn(x, t):
        x2, t2 = torch.cat([x, x]), torch.cat([t, t])
        if y is not None:
            out = forward(sd, cfg, x2, t2, y=torch.cat([y, torch.full_like(y, cfg["num_actions"])]),
                          p=p)
        else:
            out = forward(sd, cfg, x2, t2, context=torch.cat([context, torch.zeros_like(context)]),
                          p=p)
        cond, uncond = out.chunk(2)
        return uncond + scale * (cond - uncond)

    return fn
