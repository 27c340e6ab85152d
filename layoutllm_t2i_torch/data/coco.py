"""COCO layout dataset for relation-aware diffusion training (a copy of
layoutllm_t2i_tpu/data/coco.py; reference GLIGEN/dataset/dataset_layout.py
and the center-crop box remapping of base_dataset.py:56-173).

Per item: a 512x512 image in [-1, 1] NHWC, the area-sorted top-K boxes as
normalised xyxy (remapped through the crop, resize and flip), one
category-name label a box, one caption. Items are bit-equal to the JAX
dataset's for the same seed: the same ``random.Random`` draws in the same
order (flip, then caption), the same float arithmetic for the boxes, and
Pillow's bicubic resize (``utils/resample.py``) on the decoded pixels.
An 8-bit RGB PNG with unfiltered rows needs no Pillow
(``utils/images.py decode_rgb``).
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List

import numpy as np

from ..utils.images import read_rgb
from ..utils.resample import resize_bicubic


class CocoIndex:
    def __init__(self, instances_json: str, captions_json: str):
        with open(instances_json) as f:
            inst = json.load(f)
        with open(captions_json) as f:
            caps = json.load(f)
        self.images = {im["id"]: im for im in inst["images"]}
        self.cat_names = {c["id"]: c["name"] for c in inst["categories"]}
        self.anns_by_image: Dict[int, List[dict]] = {}
        for a in inst["annotations"]:
            if a.get("iscrowd", 0):
                continue
            self.anns_by_image.setdefault(a["image_id"], []).append(a)
        self.caps_by_image: Dict[int, List[str]] = {}
        for a in caps["annotations"]:
            self.caps_by_image.setdefault(a["image_id"], []).append(a["caption"])


def center_crop_params(w: int, h: int, out_size: int):
    """(scale, crop_x, crop_y) of the resize-shorter-side + center-crop
    transform (base_dataset.py center_crop_arr)."""
    scale = out_size / min(w, h)
    nw, nh = round(w * scale), round(h * scale)
    cx = (nw - out_size) // 2
    cy = (nh - out_size) // 2
    return scale, cx, cy


def remap_box_xywh(box, scale, cx, cy, out_size, flip: bool):
    """COCO xywh pixel box -> normalized xyxy in the cropped square; returns
    None when the remapped box is degenerate (recalculate_box_and_verify)."""
    x, y, w, h = box
    x0, y0, x1, y1 = x * scale - cx, y * scale - cy, (x + w) * scale - cx, (y + h) * scale - cy
    x0, x1 = max(0.0, x0), min(float(out_size), x1)
    y0, y1 = max(0.0, y0), min(float(out_size), y1)
    if x1 - x0 < 1 or y1 - y0 < 1:
        return None
    if flip:
        x0, x1 = out_size - x1, out_size - x0
    return [x0 / out_size, y0 / out_size, x1 / out_size, y1 / out_size]


def center_crop(pixels: np.ndarray, out_size: int):
    """(the resized and center-cropped (out_size, out_size, 3) uint8 image,
    scale, crop_x, crop_y): Pillow's bicubic resize of the shorter side to
    ``out_size``, then the crop box as a slice."""
    h, w = pixels.shape[:2]
    scale, cx, cy = center_crop_params(w, h, out_size)
    img = resize_bicubic(pixels, (round(w * scale), round(h * scale)))
    return img[cy:cy + out_size, cx:cx + out_size], scale, cx, cy


class LayoutDataset:
    def __init__(self, image_dir: str, instances_json: str, captions_json: str,
                 image_size: int = 512, max_boxes: int = 30,
                 min_boxes: int = 1, random_flip: bool = True, seed: int = 0):
        self.index = CocoIndex(instances_json, captions_json)
        self.image_dir = image_dir
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.random_flip = random_flip
        # shared by the loader's worker threads, as in the JAX dataset: with
        # more than one worker the flip and caption draws follow thread timing
        self.rng = random.Random(seed)
        self.ids = [
            i for i, anns in self.index.anns_by_image.items()
            if min_boxes <= len(anns) and i in self.index.caps_by_image
        ]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int):
        img_id = self.ids[i]
        info = self.index.images[img_id]
        img, scale, cx, cy = center_crop(
            read_rgb(os.path.join(self.image_dir, info["file_name"])),
            self.image_size)
        flip = self.random_flip and self.rng.random() < 0.5
        if flip:
            img = img[:, ::-1]

        anns = sorted(self.index.anns_by_image[img_id],
                      key=lambda a: a["area"], reverse=True)
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        masks = np.zeros((self.max_boxes,), np.float32)
        labels: List[str] = []
        k = 0
        for a in anns:
            if k >= self.max_boxes:
                break
            remapped = remap_box_xywh(a["bbox"], scale, cx, cy, self.image_size, flip)
            if remapped is None:
                continue
            boxes[k] = remapped
            masks[k] = 1
            labels.append(self.index.cat_names[a["category_id"]])
            k += 1

        caption = self.rng.choice(self.index.caps_by_image[img_id])
        image = np.asarray(img, np.float32) / 127.5 - 1.0
        return {"image": image, "caption": caption, "boxes": boxes,
                "masks": masks, "labels": labels}


def process_shard():
    """(process index, process count) of ``torch.distributed`` when it is
    initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def coco_layout_batches(coco_root: str, batch_size: int, image_size: int = 512,
                        max_boxes: int = 30, split: str = "train2014",
                        seed: int = 0, shuffle: bool = True,
                        num_workers: int = 4):
    """Prefetched epoch-shuffled batches of ``coco_root/split`` with
    ``annotations/{instances,captions}_<split>.json``; each process of an
    initialised ``torch.distributed`` group gets its DistributedSampler-style
    slice of every epoch (data/loader.py)."""
    from .loader import PrefetchLoader

    ds = LayoutDataset(
        image_dir=os.path.join(coco_root, split),
        instances_json=os.path.join(coco_root, "annotations", f"instances_{split}.json"),
        captions_json=os.path.join(coco_root, "annotations", f"captions_{split}.json"),
        image_size=image_size, max_boxes=max_boxes, seed=seed,
    )
    rank, world = process_shard()
    return PrefetchLoader(
        ds, batch_size, shuffle=shuffle, seed=seed, num_workers=num_workers,
        process_index=rank, process_count=world,
    )
