"""Power-of-two batch bucketing (copy of layoutllm_t2i_tpu/utils/buckets.py's
``pad_rows_pow2``): ragged phrase/relation counts pad to a few fixed
batch sizes."""
from __future__ import annotations

from typing import Optional

import numpy as np


def pow2_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two >= n (minimum 1), optionally capped at ``cap``."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap) if cap is not None else b


def pad_rows_pow2(arr: np.ndarray) -> np.ndarray:
    """Pad axis 0 to its power-of-two bucket by repeating the last row (a
    fixed-signature pad: padded rows compute real values the caller slices
    off)."""
    n = arr.shape[0]
    bucket = pow2_bucket(n)
    if bucket == n:
        return arr
    pad = np.tile(arr[-1:], (bucket - n,) + (1,) * (arr.ndim - 1))
    return np.concatenate([arr, pad], axis=0)
