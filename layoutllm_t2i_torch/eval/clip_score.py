"""CLIPScore / RefCLIPScore evaluation (a copy of
layoutllm_t2i_tpu/eval/clip_score.py: NumPy over the CLIP towers' features,
which pipeline/reward.py's RewardModel computes on the card).

Reference: GLIGEN/clip_score.py:172-263 (w=2.5 scaling, harmonic-mean
RefCLIPScore). Caption-overlap metrics (BLEU/METEOR/...) from pycocoevalcap
are not reimplemented here — CLIPScore is the quality headline used by the
paper's eval.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def clip_score(image_features: np.ndarray, text_features: np.ndarray,
               w: float = 2.5) -> np.ndarray:
    """Per-pair CLIPScore: w * max(cos(image, text), 0)."""
    im = image_features / np.linalg.norm(image_features, axis=-1, keepdims=True)
    tx = text_features / np.linalg.norm(text_features, axis=-1, keepdims=True)
    return w * np.clip((im * tx).sum(-1), 0, None)


def ref_clip_score(image_features: np.ndarray, cand_features: np.ndarray,
                   ref_features_list: List[np.ndarray], w: float = 2.5) -> np.ndarray:
    """Harmonic mean of CLIPScore(image, candidate) and max ref similarity."""
    s_img = clip_score(image_features, cand_features, w=w)
    im = image_features / np.linalg.norm(image_features, axis=-1, keepdims=True)
    out = np.zeros(len(image_features))
    for i, refs in enumerate(ref_features_list):
        r = refs / np.linalg.norm(refs, axis=-1, keepdims=True)
        s_ref = np.clip((im[i][None] * r).sum(-1).max(), 0, None)
        denom = s_img[i] + s_ref
        out[i] = 2 * s_img[i] * s_ref / denom if denom > 0 else 0.0
    return out
