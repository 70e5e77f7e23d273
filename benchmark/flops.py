"""Model FLOPs counted from shapes, never from the program: the decoder's per
point analytically, the denoiser's and CLIP's forward with
`FlopCounterMode` over the plain references on the meta device (matrix
products and convolutions, 2 FLOPs a multiply-add). And the table of peaks."""

from __future__ import annotations

import functools
import json
import os

import torch

from .reference import clip as ref_clip
from .reference import mdm as ref_mdm

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peak(kind: str) -> float:
    """A published dense peak of one H100 SXM (FLOP/s or bytes/s)."""
    with open(PEAKS) as f:
        return float(json.load(f)[kind])


def decoder_point_flops(hidden: int, layers: int, in_dim: int = 63) -> int:
    """One point through the CBN decoder: fc_p (in_dim × H), 2L hidden
    H × H products, fc_out (H × 1); 5,308,416 at H 512, L 5."""
    return 2 * (in_dim * hidden + 2 * layers * hidden * hidden + hidden)


def _counted(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _meta_state(specs) -> dict:
    return {k: torch.empty(shape, device="meta") for k, shape, _ in specs}


@functools.lru_cache(maxsize=None)
def mdm_forward_flops(model_json: str, rows: int) -> int:
    """One denoiser forward over `rows` latents (CFG's two branches are two
    rows each)."""
    cfg = json.loads(model_json)
    sd = _meta_state(ref_mdm.param_specs(cfg))
    x = torch.empty((rows, cfg["latent_size"], 1), device="meta")
    t = torch.zeros((rows,), dtype=torch.int64, device="meta")
    y = torch.zeros((rows,), dtype=torch.int64, device="meta") if cfg["cond_mode"] == "category" else None
    ctx = (torch.empty((rows, cfg["context_dim"]), device="meta")
           if cfg["cond_mode"] in ("text", "sketch", "img") else None)
    return _counted(lambda: ref_mdm.forward(sd, cfg, x, t, y=y, context=ctx))


@functools.lru_cache(maxsize=None)
def mdm_train_flops(model_json: str, rows: int) -> int:
    """One train step's denoiser forward and backward over `rows` latents
    (the loss and the optimizer's elementwise work are not counted)."""
    cfg = json.loads(model_json)
    sd = {k: torch.empty(shape, device="meta", requires_grad=True)
          for k, shape, _ in ref_mdm.param_specs(cfg)}
    x = torch.empty((rows, cfg["latent_size"], 1), device="meta")
    t = torch.zeros((rows,), dtype=torch.int64, device="meta")
    y = torch.zeros((rows,), dtype=torch.int64, device="meta") if cfg["cond_mode"] == "category" else None
    ctx = (torch.empty((rows, cfg["context_dim"]), device="meta")
           if cfg["cond_mode"] in ("text", "sketch", "img") else None)
    return _counted(lambda: ref_mdm.forward(sd, cfg, x, t, y=y, context=ctx).abs().mean().backward())


@functools.lru_cache(maxsize=None)
def ae_train_flops(ae_json: str, rows: int) -> int:
    """One AE train step: the encoder and the decoder over the batch, the
    query gradient kept in the graph, and the backward of the whole loss
    (the kNN's distance products included)."""
    from .reference import ae_train as ref_ae

    cfg = json.loads(ae_json)
    sd = {k: torch.empty(shape, device="meta", requires_grad=True)
          for k, shape, _ in ref_ae.param_specs(cfg)}
    batch = {"pcd": torch.empty((rows, cfg["num_points_pcd"], 3), device="meta"),
             "coords": torch.empty((rows, cfg["num_points_forward"], 3), device="meta"),
             "udf": torch.empty((rows, cfg["num_points_forward"]), device="meta"),
             "gradients": torch.empty((rows, cfg["num_points_forward"], 3), device="meta")}
    return _counted(lambda: ref_ae.loss(sd, batch, cfg).backward())


@functools.lru_cache(maxsize=None)
def clip_text_flops(clip_json: str, rows: int) -> int:
    cfg = json.loads(clip_json)
    sd = _meta_state(ref_clip.text_param_specs(cfg))
    tokens = torch.zeros((rows, cfg["context_length"]), dtype=torch.int64, device="meta")
    return _counted(lambda: ref_clip.encode_text(sd, tokens, cfg["text_width"] // 64))


def share(flops: float, seconds: float, peak_flops: float) -> float | None:
    """Achieved FLOP/s as a percentage of a peak; None without time."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / peak_flops
