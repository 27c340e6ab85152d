"""Pillow's bicubic resize of an 8-bit RGB image, in numpy.

The JAX package's datasets decode and resize with Pillow
(``Image.resize(size, Image.BICUBIC)``, and ``resize(size)`` whose default
filter is bicubic); the card's machine has no Pillow. ``resize_bicubic``
computes what Pillow's ``ImagingResample`` computes for an 8-bit image
(libImaging/Resample.c), so its pixels are Pillow's bit for bit:

* the filter is Keys' cubic convolution with a = -0.5 and support 2,
  widened by the scale when the side shrinks;
* each output pixel's taps span ``int(center -/+ support + 0.5)``, clipped
  to the image, with weights normalised to sum 1 and rounded to fixed point
  at 22 bits, half away from zero (``normalize_coeffs_8bpc``);
* a horizontal pass sums pixel times weight from a start of 2^21 and clips
  ``sum >> 22`` to uint8; the vertical pass does the same on that result;
* a pass whose side does not change is skipped.
"""
from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def coefficients(in_size: int, out_size: int):
    """(first tap (out,), fixed-point weights (out, taps) int64) of one
    side, as ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` give them;
    the weights past an output's last tap are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward 0; a negative start clips to 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    ss = 1.0 / filterscale
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    # summed tap by tap, in C's order (numpy's pairwise sum rounds apart)
    ww = np.zeros((out_size, 1))
    for t in range(ksize):
        ww[:, 0] += w[:, t]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    scaled = w * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(scaled < 0, scaled - 0.5, scaled + 0.5))
    return xmin, fixed.astype(np.int64)


def _rows_pass(img: np.ndarray, out_size: int) -> np.ndarray:
    """One pass along the rows (axis 0) of an (H, W, C) uint8 image, rounded
    and clipped to uint8. Each tap gathers whole rows."""
    xmin, k = coefficients(img.shape[0], out_size)
    # int32 holds every partial sum, as C's int does: an output's positive
    # weights sum to 1 plus its negative ones' magnitude, under 2 (1.134 at
    # most in tests/test_torch_resample.py's sweep), and
    # 255 * 2 * 2^22 + 2^21 < 2^31
    k = k.astype(np.int32)
    last = img.shape[0] - 1
    acc = np.full((out_size,) + img.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int32)
    for t in range(k.shape[1]):
        # taps past an output's last one have weight 0: any row will do
        acc += img[np.minimum(xmin + t, last)].astype(np.int32) * k[:, t, None, None]
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size) -> np.ndarray:
    """Pillow's ``Image.fromarray(img).resize(size, Image.BICUBIC)`` for an
    (H, W, 3) uint8 image; ``size`` is (width, height), as Pillow takes it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"want an (H, W, C) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    out_w, out_h = (int(s) for s in size)
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize to {size}: both sides must be positive")
    out = img
    if out_w != out.shape[1]:
        out = _rows_pass(np.ascontiguousarray(out.transpose(1, 0, 2)),
                         out_w).transpose(1, 0, 2)
    if out_h != out.shape[0]:
        out = _rows_pass(out, out_h)
    return np.ascontiguousarray(out) if out is not img else out.copy()
