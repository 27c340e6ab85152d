"""Image resizes that match ``jax.image.resize``.

``jax.image.resize`` samples at half-pixel centres, drops the taps that
fall outside the image and renormalises the rest, and widens its kernel
by the scale when it shrinks (antialiasing); its "bicubic" is Keys' cubic
with a = -0.5. PyTorch's ``F.interpolate`` does the same only with
``antialias=True``, on upsampling too: without it, its bilinear clamps
the edge taps and its bicubic is a = -0.75. The resize runs in f32 and
returns the input's dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_nhwc(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """(B, H, W, C) -> (B, *size, C) by ``method`` ("bilinear" or
    "bicubic"), as ``jax.image.resize`` computes it."""
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"resize method {method!r}: want bilinear or bicubic")
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(size),
                      mode=method, align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)
