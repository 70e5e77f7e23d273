"""CLIP ViT-B/32 (image and text towers) and its BPE tokenizer, PyTorch
counterpart of surfd_tpu/models/clip.py.

Only what Surf-D uses: `encode_image` / `encode_text`, each giving the
unnormalised 512-d projection that conditions the denoiser. Module names are
OpenAI CLIP's (`visual.conv1`, `visual.transformer.resblocks.{i}.attn.in_proj_weight`,
`token_embedding`, `ln_final`, `text_projection`, `logit_scale`, ...), so an
OpenAI state dict loads with strict=True; `utils/convert.py` bridges the JAX
package's Flax parameters and npz files, and reads `.pt` checkpoints.

The attention, LayerNorms and MLPs are PyTorch ops (the JAX package computes
them with XLA, outside any Pallas kernel). CLIP is frozen everywhere in
Surf-D; the towers run in eval mode under no_grad.
"""

from __future__ import annotations

import functools
import gzip
import html
import math
import os
from typing import Optional

import numpy as np
import torch
from torch import nn


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block; causal for the text tower."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.attn = nn.MultiheadAttention(width, heads, batch_first=True)
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width))
        self.mlp.add_module("gelu", QuickGELU())
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width))
        self.ln_2 = nn.LayerNorm(width)
        self.causal = causal

    def forward(self, x):  # (B, T, W)
        h = self.ln_1(x)
        mask: Optional[torch.Tensor] = None
        if self.causal:  # upstream's -inf above the diagonal
            T = x.shape[1]
            mask = torch.full((T, T), float("-inf"), device=x.device).triu_(1)
        x = x + self.attn(h, h, h, attn_mask=mask, need_weights=False)[0]
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool = False):
        super().__init__()
        self.resblocks = nn.Sequential(
            *[ResidualAttentionBlock(width, heads, causal) for _ in range(layers)])

    def forward(self, x):
        return self.resblocks(x)


def _heads(width: int) -> int:
    """One head per 64 channels, the published CLIP rule (768 → 12, 512 → 8)."""
    return max(width // 64, 1)


class VisionTower(nn.Module):
    """ViT image encoder: (B, H, W, 3) normalised images → (B, out_dim)."""

    def __init__(self, image_size=224, patch_size=32, width=768, layers=12, out_dim=512):
        super().__init__()
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, layers, _heads(width))
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, out_dim))

    def forward(self, images):
        x = self.conv1(images.permute(0, 3, 1, 2))  # (B, W, gh, gw)
        x = x.flatten(2).transpose(1, 2)  # patches in (h, w) row-major order
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj


class Clip(nn.Module):
    """Both towers, the text tower's modules at the top level as upstream.
    Defaults are ViT-B/32's published widths."""

    def __init__(self, image_size=224, patch_size=32, vision_width=768, vision_layers=12,
                 embed_dim=512, vocab_size=49408, context_length=77, text_width=512,
                 text_layers=12):
        super().__init__()
        self.visual = VisionTower(image_size, patch_size, vision_width, vision_layers, embed_dim)
        self.transformer = Transformer(text_width, text_layers, _heads(text_width), causal=True)
        self.token_embedding = nn.Embedding(vocab_size, text_width)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, text_width))
        self.ln_final = nn.LayerNorm(text_width)
        self.text_projection = nn.Parameter(torch.zeros(text_width, embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))  # unused here
        self.eval()

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images as `clip_preprocess` returns them → (B, embed_dim)."""
        return self.visual(images)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, context_length) token ids → (B, embed_dim), read at each row's
        end-of-text token (its largest id)."""
        tokens = tokens.long()
        x = self.token_embedding(tokens) + self.positional_embedding
        x = self.ln_final(self.transformer(x))
        eot = tokens.argmax(dim=-1)
        return x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator) -> "Clip":
        """Seeded weights: LeCun normal for the linear, attention and patch
        weights; N(0, 0.02) for the token and class embeddings, N(0, 0.01) for
        the positional ones, N(0, width^-1/2) for the projections; zero
        biases, unit norms. Not the JAX package's `init_clip()` weights."""
        def normal_(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):  # fan-in: all but dim 0
                normal_(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.MultiheadAttention):
                normal_(m.in_proj_weight, m.embed_dim ** -0.5)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, 0.02)
        for tower in (self.visual, self):
            normal_(tower.positional_embedding, 0.01)
        normal_(self.visual.class_embedding, 0.02)
        for p in (self.visual.proj, self.text_projection):
            normal_(p, p.shape[0] ** -0.5)
        return self


def clip_config_from_state(sd) -> dict:
    """Clip(...) keyword arguments inferred from a state dict's shapes, as
    the JAX package's `clip_config_from_shapes` infers them from its params."""
    conv = sd["visual.conv1.weight"].shape  # (width, 3, p, p)
    grid = math.isqrt(sd["visual.positional_embedding"].shape[0] - 1)

    def n_blocks(prefix):
        i = 0
        while f"{prefix}.{i}.ln_1.weight" in sd:
            i += 1
        return i

    vocab, twidth = sd["token_embedding.weight"].shape
    return dict(
        patch_size=int(conv[2]),
        vision_width=int(conv[0]),
        image_size=int(conv[2]) * grid,
        vision_layers=n_blocks("visual.transformer.resblocks"),
        embed_dim=int(sd["visual.proj"].shape[1]),
        vocab_size=int(vocab),
        context_length=int(sd["positional_embedding"].shape[0]),
        text_width=int(twidth),
        text_layers=n_blocks("transformer.resblocks"),
    )


# ---------------------------------------------------------------------------
# Tokenizer (BPE)
# ---------------------------------------------------------------------------

DEFAULT_BPE_PATHS = (
    os.environ.get("SURFD_CLIP_BPE", ""),
    # the 48,894 merges the tokenizer consumes, no version header
    os.path.join(os.path.dirname(__file__), os.pardir, "assets", "clip_bpe_merges.txt.gz"),
)


@functools.lru_cache()
def _bytes_to_unicode():
    """Reversible byte → unicode map (the GPT-2 / CLIP construction)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class SimpleTokenizer:
    """CLIP's byte-pair-encoding tokenizer over a merge table: the packaged
    file (no header, exactly the consumed merges) or the published
    `bpe_simple_vocab_16e6.txt.gz` (a version header, then the full list)."""

    def __init__(self, bpe_path: Optional[str] = None):
        if bpe_path is None:
            bpe_path = next((p for p in DEFAULT_BPE_PATHS if p and os.path.exists(p)), None)
        if bpe_path is None:
            raise FileNotFoundError(
                "CLIP BPE merges not found; set SURFD_CLIP_BPE to bpe_simple_vocab_16e6.txt.gz")
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        if merges and merges[0].startswith('"'):  # published: header + 262k merges
            merges = merges[1: 49152 - 256 - 2 + 1]
        else:  # packaged: the consumed merges only
            merges = [m for m in merges if m][: 49152 - 256 - 2]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        # The published pattern's \p{L} / \p{N} classes need the `regex`
        # module; without it, ASCII classes (equal on English prompts, wrong
        # on other scripts): `unicode_ok` says which.
        try:
            import regex as re

            self.pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                re.IGNORECASE,
            )
            self.unicode_ok = True
        except ImportError:
            import re

            self.pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
                re.IGNORECASE,
            )
            self.unicode_ok = False
        self._re = re

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = html.unescape(html.unescape(text)).strip().lower()
        text = self._re.sub(r"\s+", " ", text)
        ids = []
        for token in self._re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


@functools.lru_cache(maxsize=4)
def get_tokenizer(bpe_path: Optional[str] = None) -> SimpleTokenizer:
    """The tokenizer of one merge file, built once per path."""
    return SimpleTokenizer(bpe_path)


def tokenize(texts, context_length: int = 77, truncate: bool = True, bpe_path=None) -> np.ndarray:
    """Texts → (B, context_length) int32 token matrix: start-of-text, the
    BPE ids, end-of-text, zeros. A text past the length is cut and keeps its
    end-of-text token last (or raises with truncate=False)."""
    tok = get_tokenizer(bpe_path)
    if isinstance(texts, str):
        texts = [texts]
    sot = tok.encoder["<|startoftext|>"]
    eot = tok.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [sot] + tok.encode(t) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"text too long: {t!r}")
            ids = ids[:context_length]
            ids[-1] = eot
        out[i, : len(ids)] = ids
    return out
