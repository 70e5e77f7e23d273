"""Image and sketch preprocessing for the CLIP image tower: every function of
surfd_tpu_torch/data/conditioning.py is bit-equal to the JAX package's
(numpy on both sides), on images and masks from numpy seeds, including a
crop at the image border and an empty mask."""

import numpy as np
import pytest

from surfd_tpu.data import conditioning as jcond
from surfd_tpu_torch.data import conditioning as cond


def _img(h, w, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3)).astype(dtype)


def _mask(h, w, box):
    m = np.zeros((h, w), bool)
    if box is not None:
        y0, y1, x0, x1 = box
        m[y0:y1, x0:x1] = True
    return m


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_constants_equal():
    _equal(cond.CLIP_MEAN, jcond.CLIP_MEAN)
    _equal(cond.CLIP_STD, jcond.CLIP_STD)


# (mask box as y0, y1, x0, x1 in a 60 x 80 image): inside, at the corner, at
# the right border, one pixel, the whole image, empty
BOXES = [(10, 30, 20, 50), (0, 12, 0, 9), (25, 59, 70, 80), (33, 34, 41, 42), (0, 60, 0, 80), None]


@pytest.mark.parametrize("box", BOXES)
def test_mask2bbox_bit_equal(box):
    m = _mask(60, 80, box)
    assert cond.mask2bbox(m) == jcond.mask2bbox(m)


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("pad_ratio", [0.1, 0.0, 0.5])
def test_crop_square_bit_equal(box, pad_ratio):
    img, m = _img(60, 80, 1), _mask(60, 80, box)
    bbox = jcond.mask2bbox(m)
    _equal(cond.crop_square(img, bbox, pad_ratio), jcond.crop_square(img, bbox, pad_ratio))


@pytest.mark.parametrize("box", BOXES)
def test_composite_on_white_bit_equal(box):
    img, m = _img(60, 80, 2), _mask(60, 80, box)
    got = cond.composite_on_white(img, m)
    _equal(got, jcond.composite_on_white(img, m))
    _equal(cond.crop_square(got, cond.mask2bbox(m)),
           jcond.crop_square(jcond.composite_on_white(img, m), jcond.mask2bbox(m)))


@pytest.mark.parametrize("size", [224, 17, (31, 45), (224, 300)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_bilinear_bit_equal(size, dtype):
    img = _img(50, 70, 3, dtype)
    _equal(cond.resize_bilinear(img, size), jcond.resize_bilinear(img, size))


@pytest.mark.parametrize("hw", [(60, 80), (300, 120), (224, 224), (13, 500), (7, 9)])
def test_clip_preprocess_bit_equal(hw):
    img = _img(*hw, seed=4)
    got = cond.clip_preprocess(img)
    assert got.shape == (224, 224, 3)
    _equal(got, jcond.clip_preprocess(img))
    _equal(cond.clip_preprocess(img, 64), jcond.clip_preprocess(img, 64))
