"""Synthetic layout batches for smoke tests and throughput benchmarks
(a copy of layoutllm_t2i_tpu/data/synthetic.py, numpy only; shape-compatible
with the JAX package's data/coco.py output)."""
from __future__ import annotations

import itertools

import numpy as np

_CAPTIONS = [
    "a dog chasing a frisbee in a park",
    "two cats sitting on a red couch",
    "a person riding a horse on the beach",
    "a bowl of fruit next to a bottle on the table",
]
_LABELS = [["dog", "frisbee"], ["cat", "cat", "couch"], ["person", "horse"],
           ["bowl", "bottle", "dining table"]]


def synthetic_layout_batches(batch_size: int, image_size: int = 512,
                             max_boxes: int = 30, seed: int = 0):
    rng = np.random.default_rng(seed)
    for step in itertools.count():
        idx = [(step * batch_size + i) % len(_CAPTIONS) for i in range(batch_size)]
        boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
        masks = np.zeros((batch_size, max_boxes), np.float32)
        labels = []
        for row, j in enumerate(idx):
            labs = _LABELS[j]
            labels.append(labs)
            for k in range(len(labs)):
                x0, y0 = rng.uniform(0, 0.5, 2)
                w, h = rng.uniform(0.2, 0.5, 2)
                boxes[row, k] = [x0, y0, min(x0 + w, 1.0), min(y0 + h, 1.0)]
                masks[row, k] = 1
        yield {
            "image": rng.uniform(-1, 1, (batch_size, image_size, image_size, 3)).astype(np.float32),
            "caption": [_CAPTIONS[j] for j in idx],
            "boxes": boxes,
            "masks": masks,
            "labels": labels,
        }
