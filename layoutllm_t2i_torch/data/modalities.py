"""Modality datasets: condition-map pairs and COCO person keypoints (a copy
of layoutllm_t2i_tpu/data/modalities.py).

Reference capability: GLIGEN/dataset/dataset_{canny,hed,depth,normal,sem}.py
(image + same-name condition map, ~125 LoC each) and dataset_kp.py (COCO
keypoints). The map variants share one implementation here, parameterized by
the condition directory; keypoints are parsed from the COCO person_keypoints
JSON directly (no pycocotools). Images decode through ``utils/images.py
read_rgb`` and resize with Pillow's bicubic filter (``utils/resample.py``),
so items are bit-equal to the JAX datasets'.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np

from ..utils.images import read_rgb
from ..utils.resample import resize_bicubic
from .coco import center_crop


class ConditionMapDataset:
    """Pairs (image, condition map) by file name.

    image_dir/X.jpg + condition_dir/X.png -> 512px image in [-1,1] and the
    map in [0,1] (grayscale maps replicated to 3 channels like the reference
    datasets). Used for canny/hed/depth/normal/sem training."""

    def __init__(self, image_dir: str, condition_dir: str, captions: Optional[Dict[str, str]] = None,
                 image_size: int = 512, seed: int = 0):
        self.image_dir = image_dir
        self.condition_dir = condition_dir
        self.image_size = image_size
        self.captions = captions or {}
        names = []
        cond_files = {os.path.splitext(f)[0]: f for f in os.listdir(condition_dir)}
        for f in sorted(os.listdir(image_dir)):
            stem = os.path.splitext(f)[0]
            if stem in cond_files:
                names.append((f, cond_files[stem]))
        self.names = names
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.names)

    def __getitem__(self, i: int):
        img_name, cond_name = self.names[i]
        size = (self.image_size, self.image_size)
        img = resize_bicubic(read_rgb(os.path.join(self.image_dir, img_name)), size)
        cond = resize_bicubic(
            read_rgb(os.path.join(self.condition_dir, cond_name)), size)
        stem = os.path.splitext(img_name)[0]
        return {
            "image": np.asarray(img, np.float32) / 127.5 - 1.0,
            "condition": np.asarray(cond, np.float32) / 255.0,
            "caption": self.captions.get(stem, ""),
        }


# COCO 17-keypoint order (person_keypoints_*.json "keypoints" field)
COCO_KEYPOINT_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear", "left_shoulder",
    "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
    "left_hip", "right_hip", "left_knee", "right_knee", "left_ankle",
    "right_ankle",
]


class KeypointDataset:
    """COCO person keypoints -> (points (P*17, 2) normalized xy, masks).

    Mirrors dataset_kp.py's role: per image up to max_persons annotated
    people; invisible keypoints (v == 0) are masked."""

    def __init__(self, image_dir: str, keypoints_json: str, captions_json: str,
                 image_size: int = 512, max_persons: int = 8, seed: int = 0):
        with open(keypoints_json) as f:
            kp = json.load(f)
        with open(captions_json) as f:
            caps = json.load(f)
        self.images = {im["id"]: im for im in kp["images"]}
        self.anns_by_image: Dict[int, List[dict]] = {}
        for a in kp["annotations"]:
            if a.get("num_keypoints", 0) > 0:
                self.anns_by_image.setdefault(a["image_id"], []).append(a)
        self.caps_by_image: Dict[int, List[str]] = {}
        for a in caps["annotations"]:
            self.caps_by_image.setdefault(a["image_id"], []).append(a["caption"])
        self.ids = [i for i in self.anns_by_image if i in self.caps_by_image]
        self.image_dir = image_dir
        self.image_size = image_size
        self.max_persons = max_persons
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx: int):
        img_id = self.ids[idx]
        info = self.images[img_id]
        img, scale, cx, cy = center_crop(
            read_rgb(os.path.join(self.image_dir, info["file_name"])),
            self.image_size)

        pts = np.zeros((self.max_persons * 17, 2), np.float32)
        masks = np.zeros((self.max_persons * 17,), np.float32)
        anns = self.anns_by_image[img_id][: self.max_persons]
        for p, a in enumerate(anns):
            kps = np.asarray(a["keypoints"], np.float32).reshape(17, 3)
            for k in range(17):
                x, y, v = kps[k]
                if v == 0:
                    continue
                xx = (x * scale - cx) / self.image_size
                yy = (y * scale - cy) / self.image_size
                if 0 <= xx <= 1 and 0 <= yy <= 1:
                    pts[p * 17 + k] = [xx, yy]
                    masks[p * 17 + k] = 1.0
        caption = self.rng.choice(self.caps_by_image[img_id])
        return {
            "image": np.asarray(img, np.float32) / 127.5 - 1.0,
            "points": pts, "masks": masks, "caption": caption,
        }
