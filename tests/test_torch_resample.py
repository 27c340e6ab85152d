"""utils/resample.py against Pillow's bicubic resize of 8-bit RGB images.

The port's datasets resize decoded pixels with ``resize_bicubic`` where the
JAX package's call ``Image.resize(size, Image.BICUBIC)`` (or ``resize``'s
bicubic default); the card's machine has no Pillow. The two must agree bit
for bit: at the sizes COCO's images take to 512 (the shorter side to 512,
both orientations), from tiny and odd sizes, shrinking and growing, on one
side only, and to the same size. Two planted faults of the two-pass
arithmetic must disagree: no rounding to uint8 between the passes, and the
vertical pass first.
"""
import numpy as np
import pytest
from PIL import Image

from layoutllm_t2i_torch.utils import resample as rs

# (source (w, h), target (w, h))
PAIRS = [
    ((640, 480), (683, 512)), ((480, 640), (512, 683)),
    ((333, 500), (512, 769)), ((37, 23), (512, 512)),
    ((700, 300), (512, 512)), ((64, 64), (16, 16)),
    ((513, 512), (512, 512)),
    # more: shrinking hard, growing from one pixel, one side only, same size
    ((1000, 20), (33, 7)), ((1, 1), (9, 5)), ((5, 5), (1, 1)),
    ((300, 200), (768, 512)), ((50, 60), (50, 97)), ((50, 60), (13, 60)),
    ((41, 29), (41, 29)), ((97, 61), (40, 200)),
]
# both sides change and neither is a whole-number scale: every fault shows
FAULT_PAIRS = [((160, 120), (171, 128)), ((37, 23), (512, 512)),
               ((97, 61), (40, 200))]


def _image(w, h, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _pillow(img, size):
    return np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC))


@pytest.mark.parametrize("src,dst", PAIRS)
def test_bit_equal_to_pillow(src, dst):
    img = _image(*src)
    got = rs.resize_bicubic(img, dst)
    assert got.dtype == np.uint8 and got.shape == (dst[1], dst[0], 3)
    np.testing.assert_array_equal(got, _pillow(img, dst))


def test_resize_default_filter_is_the_same():
    # the JAX TSV and condition-map datasets call resize(size): bicubic
    img = _image(45, 31, seed=1)
    np.testing.assert_array_equal(
        rs.resize_bicubic(img, (16, 16)),
        np.asarray(Image.fromarray(img).resize((16, 16))))


def _dense(in_size, out_size):
    """The fixed-point weights of one side as an (out, in) matrix."""
    xmin, k = rs.coefficients(in_size, out_size)
    w = np.zeros((out_size, in_size))
    for o in range(out_size):
        for t in range(k.shape[1]):
            if xmin[o] + t < in_size:
                w[o, xmin[o] + t] += k[o, t]
    return w


def _unrounded_between_passes(img, size):
    half, one = 1 << (rs.PRECISION_BITS - 1), 1 << rs.PRECISION_BITS
    h = np.einsum("ow,hwc->hoc", _dense(img.shape[1], size[0]),
                  img.astype(np.float64)) / one
    v = np.einsum("oh,hwc->owc", _dense(img.shape[0], size[1]), h)
    return np.clip(np.floor((v + half) / one), 0, 255).astype(np.uint8)


def _vertical_first(img, size):
    v = rs._rows_pass(img, size[1])
    return np.ascontiguousarray(
        rs._rows_pass(np.ascontiguousarray(v.transpose(1, 0, 2)),
                      size[0]).transpose(1, 0, 2))


@pytest.mark.parametrize("fault", [_unrounded_between_passes, _vertical_first])
@pytest.mark.parametrize("src,dst", FAULT_PAIRS)
def test_planted_faults_disagree(fault, src, dst):
    img = _image(*src)
    want = _pillow(img, dst)
    np.testing.assert_array_equal(rs.resize_bicubic(img, dst), want)
    assert not np.array_equal(fault(img, dst), want)


def test_partial_sums_fit_int32():
    # the passes accumulate in int32 as Pillow's C does: every output's
    # positive (and negative) fixed-point weights, times 255, plus the
    # rounding start, stay below 2^31 (the passes assume a weight sum < 2)
    sizes = list(range(1, 70)) + [333, 480, 500, 513, 640, 700, 1000]
    worst = 0.0
    for n_in in sizes:
        for n_out in list(range(1, 70)) + [512, 683, 769]:
            _, k = rs.coefficients(n_in, n_out)
            pos = np.clip(k, 0, None).sum(1).max()
            neg = -np.clip(k, None, 0).sum(1).min()
            worst = max(worst, pos / (1 << rs.PRECISION_BITS))
            assert 255 * max(pos, neg) + (1 << (rs.PRECISION_BITS - 1)) < 2 ** 31
    assert worst < 2


def test_refuses_other_images():
    with pytest.raises(ValueError, match="uint8"):
        rs.resize_bicubic(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError, match="positive"):
        rs.resize_bicubic(np.zeros((4, 4, 3), np.uint8), (0, 2))
