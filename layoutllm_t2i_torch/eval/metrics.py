"""Layout metrics: pairwise IoU, Hungarian max-IoU, DocSim (a copy of
layoutllm_t2i_tpu/eval/metrics.py: host-only NumPy + scipy, so the port
keeps its own copy and imports nothing of the JAX package).

Reference semantics: tools/metrics.py (compute_iou:15, compute_maximum_iou:
58-91, compute_docsim:93-164). Host-side NumPy + scipy Hungarian; these run
per-layout on tiny arrays so there is nothing to accelerate.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

Layout = Tuple[np.ndarray, np.ndarray]  # (boxes (N,4), labels (N,))


def compute_iou(box_1: np.ndarray, box_2: np.ndarray, generalized: bool = False):
    """Elementwise IoU of two (N, 4) ltrb arrays."""
    l1, t1, r1, b1 = box_1.T
    l2, t2, r2, b2 = box_2.T
    a1, a2 = (r1 - l1) * (b1 - t1), (r2 - l2) * (b2 - t2)

    l_max = np.maximum(l1, l2)
    r_min = np.minimum(r1, r2)
    t_max = np.maximum(t1, t2)
    b_min = np.minimum(b1, b2)
    cond = (l_max < r_min) & (t_max < b_min)
    ai = np.where(cond, (r_min - l_max) * (b_min - t_max), 0.0)

    au = a1 + a2 - ai
    iou = ai / au
    if not generalized:
        return iou

    l_min = np.minimum(l1, l2)
    r_max = np.maximum(r1, r2)
    t_min = np.minimum(t1, t2)
    b_max = np.maximum(b1, b2)
    ac = (r_max - l_min) * (b_max - t_min)
    return iou - (ac - au) / ac


def _max_iou_one(layout_1: Layout, layout_2: Layout) -> float:
    (bi, li), (bj, lj) = layout_1, layout_2
    bi, bj = np.asarray(bi, dtype=np.float64), np.asarray(bj, dtype=np.float64)
    li, lj = np.asarray(li), np.asarray(lj)
    n_total = len(bi)
    score = 0.0
    for lbl in set(li.tolist()):
        _bi = bi[li == lbl]
        _bj = bj[lj == lbl]
        n, m = len(_bi), len(_bj)
        if m == 0:
            continue
        ii, jj = np.meshgrid(range(n), range(m))
        iou = compute_iou(_bi[ii.flatten()], _bj[jj.flatten()]).reshape(n, m)
        rr, cc = linear_sum_assignment(iou, maximize=True)
        score += iou[rr, cc].sum()
    return score / n_total


def compute_maximum_iou(layouts_gt: List[Layout], layouts_gen: List[Layout]) -> np.ndarray:
    return np.array([_max_iou_one(a, b) for a, b in zip(layouts_gt, layouts_gen)])


def _bbox_sim(b1, c1, b2, c2, C_S: float = 2.0, C: float = 0.5) -> float:
    if c1 != c2:
        return 0.0
    cx1, cy1, w1, h1 = b1
    cx2, cy2, w2, h2 = b2
    delta_c = np.sqrt((cx1 - cx2) ** 2 + (cy1 - cy2) ** 2)
    delta_s = abs(w1 - w2) + abs(h1 - h2)
    area = min(w1 * h1, w2 * h2)
    alpha = np.clip(area, 0.0, None) ** C
    return float(alpha * 2.0 ** (-delta_c - C_S * delta_s))


def _docsim_one(layout_1: Layout, layout_2: Layout, max_diff_thresh: int = 3) -> float:
    (b1, c1), (b2, c2) = layout_1, layout_2
    n, m = len(b1), len(b2)
    if n >= m + max_diff_thresh or n <= m - max_diff_thresh:
        return 0.0
    scores = np.asarray(
        [[_bbox_sim(b1[i], c1[i], b2[j], c2[j]) for j in range(m)] for i in range(n)]
    ).reshape(n, m)
    rr, cc = linear_sum_assignment(scores, maximize=True)
    matched = scores[rr, cc]
    return float(matched.mean()) if len(matched) else 0.0


def compute_docsim(layouts_gt: List[Layout], layouts_gen: List[Layout]) -> np.ndarray:
    return np.array([_docsim_one(a, b) for a, b in zip(layouts_gt, layouts_gen)])
