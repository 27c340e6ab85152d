"""From layoutllm_t2i_tpu/data/tsv.py, only ``reproject_embedding``: the
text_image modality's --projection_matrix. The TSV datasets themselves
belong to the data loaders, which are not ported (ROADMAP.md Queue 1,
"data loaders")."""
from __future__ import annotations

import numpy as np


def reproject_embedding(emb: np.ndarray, projection_matrix: np.ndarray,
                        norm: float = 28.7) -> np.ndarray:
    """'after_reproject': penultimate CLIP feature -> projected and rescaled
    (tsv_dataset.py:190-200, txt2img.py:119-144)."""
    out = emb @ projection_matrix.T
    out = out / np.linalg.norm(out) * norm
    return out
