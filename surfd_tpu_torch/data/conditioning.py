"""Image and sketch preprocessing for the CLIP image tower, on the host:
numpy copy of surfd_tpu/data/conditioning.py (the reference's `mask2bbox`,
`crop_square` and CLIP input transforms). Images are numpy (H, W, C) uint8
or float arrays; no torchvision.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def mask2bbox(mask: np.ndarray):
    """Tight bbox (x0, y0, x1, y1) of a binary mask; the whole image when it is empty."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, mask.shape[1], mask.shape[0]
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def crop_square(img: np.ndarray, bbox, pad_ratio: float = 0.1, fill: float = 255.0):
    """Square crop around a bbox with padding; what falls outside the image
    is `fill` (white)."""
    x0, y0, x1, y1 = bbox
    w, h = x1 - x0, y1 - y0
    side = int(max(w, h) * (1 + pad_ratio))
    cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
    half = side // 2
    out = np.full((side, side, img.shape[2]), fill, dtype=img.dtype)
    sx0, sy0 = max(cx - half, 0), max(cy - half, 0)
    sx1, sy1 = min(cx + half, img.shape[1]), min(cy + half, img.shape[0])
    dx0, dy0 = sx0 - (cx - half), sy0 - (cy - half)
    out[dy0 : dy0 + (sy1 - sy0), dx0 : dx0 + (sx1 - sx0)] = img[sy0:sy1, sx0:sx1]
    return out


def composite_on_white(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Keep masked pixels, white elsewhere."""
    out = img.copy()
    out[~mask.astype(bool)] = 255
    return out


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """Minimal bilinear resize — replaces torchvision Resize.

    size: int → (size, size); (out_h, out_w) tuple → per-axis sizes (needed
    for CLIP's aspect-preserving shorter-side resize)."""
    h, w = img.shape[:2]
    out_h, out_w = (size, size) if isinstance(size, int) else size
    ys = np.linspace(0, h - 1, out_h)
    xs = np.linspace(0, w - 1, out_w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def clip_preprocess(img: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 (H, W, 3) → normalized float (size, size, 3) for the CLIP image
    tower (CLIP's transform: shorter-side resize preserving the aspect
    ratio, center crop, normalize)."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    resized = resize_bilinear(
        img, (max(int(round(h * scale)), size), max(int(round(w * scale)), size))
    )
    # center crop of the aspect-preserved resize
    H, W = resized.shape[:2]
    y0, x0 = (H - size) // 2, (W - size) // 2
    crop = resized[y0 : y0 + size, x0 : x0 + size]
    crop = crop / 255.0
    return ((crop - CLIP_MEAN) / CLIP_STD).astype(np.float32)
