"""Plain PyTorch reference of CLIP's text tower (OpenAI CLIP, ViT-B/32's
text transformer): token embedding plus positions, pre-LN blocks of causal
multi-head self-attention (packed `in_proj_weight`) and a QuickGELU MLP
(x·σ(1.702x)), a final LayerNorm, read at each row's end-of-text token (its
largest id) and projected by `text_projection`. Weights: an OpenAI-layout
state dict.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import F32, Precision


def encode_text(sd: dict, tokens: torch.Tensor, heads: int, p: Precision = F32) -> torch.Tensor:
    """(B, T) token ids → (B, embed_dim)."""
    tokens = tokens.long()
    x = sd["token_embedding.weight"][tokens] + sd["positional_embedding"]
    B, T, W = x.shape
    c = W // heads
    mask = torch.full((T, T), float("-inf"), device=x.device).triu_(1)
    layers = sum(1 for k in sd if k.startswith("transformer.resblocks.") and k.endswith("ln_1.weight"))

    def ln(key, h):
        return F.layer_norm(h, (W,), sd[f"{key}.weight"], sd[f"{key}.bias"], eps=1e-5)

    def lin(key, h):
        return p.linear(h, sd[f"{key}.weight"], sd[f"{key}.bias"])

    for i in range(layers):
        b = f"transformer.resblocks.{i}"
        h = ln(f"{b}.ln_1", x)
        qkv = p.linear(h, sd[f"{b}.attn.in_proj_weight"], sd[f"{b}.attn.in_proj_bias"])
        q, k, v = (t.reshape(B, T, heads, c).transpose(1, 2) for t in qkv.split(W, dim=-1))
        logits = p.einsum("bhtc,bhsc->bhts", q, k) / math.sqrt(c) + mask
        a = p.einsum("bhts,bhsc->bhtc", torch.softmax(logits, dim=-1), v)
        x = x + lin(f"{b}.attn.out_proj", a.transpose(1, 2).reshape(B, T, W))
        h = lin(f"{b}.mlp.c_fc", ln(f"{b}.ln_2", x))
        x = x + lin(f"{b}.mlp.c_proj", h * torch.sigmoid(1.702 * h))
    x = ln("ln_final", x)
    return p.matmul(x[torch.arange(B, device=x.device), tokens.argmax(dim=-1)],
                    sd["text_projection"])


def text_param_specs(cfg: dict) -> list:
    """[(key, shape, kind)] of the text tower's OpenAI-layout state dict;
    kind as in `reference.mdm.param_specs`, plus "embed:<std>"."""
    W, L, V, T, E = (cfg["text_width"], cfg["text_layers"], cfg["vocab_size"],
                     cfg["context_length"], cfg["embed_dim"])
    specs = [("token_embedding.weight", (V, W), "embed:0.02"),
             ("positional_embedding", (T, W), "embed:0.01")]
    for i in range(L):
        b = f"transformer.resblocks.{i}"
        specs += [(f"{b}.ln_1.weight", (W,), "norm"), (f"{b}.ln_1.bias", (W,), "bias"),
                  (f"{b}.attn.in_proj_weight", (3 * W, W), "fan_in"),
                  (f"{b}.attn.in_proj_bias", (3 * W,), "bias"),
                  (f"{b}.attn.out_proj.weight", (W, W), "fan_in"),
                  (f"{b}.attn.out_proj.bias", (W,), "bias"),
                  (f"{b}.ln_2.weight", (W,), "norm"), (f"{b}.ln_2.bias", (W,), "bias"),
                  (f"{b}.mlp.c_fc.weight", (4 * W, W), "fan_in"),
                  (f"{b}.mlp.c_fc.bias", (4 * W,), "bias"),
                  (f"{b}.mlp.c_proj.weight", (W, 4 * W), "fan_in"),
                  (f"{b}.mlp.c_proj.bias", (W,), "bias")]
    specs += [("ln_final.weight", (W,), "norm"), ("ln_final.bias", (W,), "bias"),
              ("text_projection", (W, E), "fan_in_rows")]
    return specs
