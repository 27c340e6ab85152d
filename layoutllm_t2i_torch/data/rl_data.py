"""RL training data: COCO2014 sample/candidate JSON files + images
(layoutllm_t2i_tpu/data/rl_data.py).

Reference: data.py:14-56 and the JSON schema of data/train2014_train_{N}.json:
{"id": [...], "data": [{img_id, name, width, height, bbox (center-normalized
xcycwh), label, captions}, ...]}. Images are 512x512 RGB float [0, 1]
arrays for the reward's CLIP vision tower.

The card's machine has no Pillow: a 512x512 8-bit RGB PNG in the form
utils/images.py writes is read with the port's own decoder; any other image
(a COCO JPEG, another size or PNG form) goes through Pillow, as the JAX
package reads every image, and raises without it.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..utils.images import PNGFormatError, read_png


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_rl_data(sampled_data_dir: str, train_number: int, cand_number: int):
    """(train_examples, cand_examples, train_ids, cand_ids)."""
    train = load_json(os.path.join(sampled_data_dir, f"train2014_train_{train_number}.json"))
    cand = load_json(os.path.join(sampled_data_dir, f"train2014_candidate_{cand_number}.json"))
    return train["data"], cand["data"], train["id"], cand["id"]


def load_image(img_dir: str, name: str, size: int = 512) -> np.ndarray:
    """(size, size, 3) float32 RGB in [0, 1]."""
    path = os.path.join(img_dir, name)
    if name.lower().endswith(".png"):
        with open(path, "rb") as f:
            data = f.read()
        try:
            pixels = read_png(data)
        except PNGFormatError:
            pixels = None
        if pixels is not None and pixels.shape == (size, size, 3):
            return pixels.astype(np.float32) / 255.0
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(
            f"load_image: {name} needs Pillow, which is not installed (without "
            f"it only {size}x{size} 8-bit RGB PNGs with unfiltered rows are "
            "read)") from exc
    img = Image.open(path).convert("RGB").resize((size, size))
    return np.asarray(img, dtype=np.float32) / 255.0


class RLBatches:
    """Sequential batches over the train examples (the reference DataLoader
    uses shuffle=False, train_rl.py:134-140)."""

    def __init__(self, examples: List[Dict], img_dir: str, batch_size: int):
        self.examples = examples
        self.img_dir = img_dir
        self.batch_size = batch_size

    def __iter__(self):
        for i in range(0, len(self.examples), self.batch_size):
            chunk = self.examples[i : i + self.batch_size]
            imgs = np.stack([load_image(self.img_dir, ex["name"]) for ex in chunk])
            yield chunk, imgs, list(range(i, i + len(chunk)))

    def __len__(self):
        return (len(self.examples) + self.batch_size - 1) // self.batch_size
