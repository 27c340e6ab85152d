"""Composite RL reward (layoutllm_t2i_tpu/pipeline/reward.py): CLIP
text-image + image-image similarity, aesthetic MLP (x0.1), Hungarian max-IoU
(x10) and DocSim (x10).

Reference: models/policy.py:36-138 (Reward). The CLIP text and vision towers
and the aesthetic MLP run in f32 on the model's device, the card unless
``device="cpu"``: every tower LayerNorm is K3's f32 form there. The
open-vocabulary label -> nearest COCO-80 class runs through cached CLIP
text features; the Hungarian assignments stay on the host (scipy), since
layouts are tiny.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..eval.metrics import compute_docsim, compute_maximum_iou
from ..models.clip_text import CLIPTextConfig, clip_text_features
from ..models.clip_vision import (CLIPVisionConfig, clip_image_features,
                                  preprocess_images)
from ..models.policy import aesthetic_apply, l2_normalize
from ..utils.trees import ParamTree

COCO80_LABELS = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

Layout = Tuple[Sequence[Sequence[float]], Sequence[str]]  # (boxes, labels)

# the composite's weights (policy.py:105-138)
AESTHETIC_WEIGHT, MAX_IOU_WEIGHT, DOCSIM_WEIGHT = 0.1, 10.0, 10.0


def _f32_on(params, device: torch.device) -> ParamTree:
    """``params`` (a ParamTree, moved in place, or a nested dict) as an f32
    ParamTree on ``device``."""
    tree = params if isinstance(params, ParamTree) else ParamTree(params)
    return tree.to(device=device, dtype=torch.float32)


class RewardModel:
    """The towers and the aesthetic MLP are moved to ``device`` in f32 once,
    at construction, with the 80 COCO label embeddings."""

    def __init__(self, text_cfg: CLIPTextConfig, text_params: Any,
                 vision_cfg: CLIPVisionConfig, vision_params: Any,
                 aesthetic_params: Any, tokenizer, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.text_cfg, self.vision_cfg = text_cfg, vision_cfg
        self.text_params = _f32_on(text_params, self.device)  # + text_projection
        self.vision_params = _f32_on(vision_params, self.device)  # + visual_projection
        self.aesthetic_params = _f32_on(aesthetic_params, self.device)
        self.tokenizer = tokenizer
        self.label2index = {l: i for i, l in enumerate(COCO80_LABELS)}
        self.labels_emb = l2_normalize(
            self.text_features(COCO80_LABELS)).cpu().numpy()
        self._label_cache: Dict[str, str] = {}

    # -- features ---------------------------------------------------------

    @torch.no_grad()
    def text_features(self, texts: List[str]) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(self.tokenizer(texts), np.int64))
        return clip_text_features(self.text_params, self.text_cfg,
                                  ids.to(self.device))

    @torch.no_grad()
    def image_features(self, images) -> torch.Tensor:
        """images: (B, H, W, 3) float in [0, 1]."""
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        return clip_image_features(self.vision_params, self.vision_cfg,
                                   preprocess_images(x, self.vision_cfg))

    # -- open-vocab label mapping (policy.py:84-102) ------------------------

    def nearest_coco_label(self, label: str) -> str:
        if label in self.label2index:
            return label
        if label in self._label_cache:
            return self._label_cache[label]
        emb = l2_normalize(self.text_features([label])).cpu().numpy()
        sim = emb @ self.labels_emb.T
        out = COCO80_LABELS[int(sim.flatten().argmax())]
        self._label_cache[label] = out
        return out

    def _layout_ids(self, layouts: List[Layout], close_set: bool):
        out = []
        for boxes, labels in layouts:
            if close_set:
                labels = [self.nearest_coco_label(l) for l in labels]
            ids = [self.label2index[l] for l in labels]
            out.append((np.asarray(boxes, dtype=np.float64), np.asarray(ids)))
        return out

    # -- composite reward (policy.py:105-138) --------------------------------

    @torch.no_grad()
    def components(self, captions: List[str], imgs_pred, imgs_gt,
                   layout_pred: List[Layout],
                   layout_gt: List[Layout]) -> Dict[str, np.ndarray]:
        """Each term of the composite, unweighted: ``clip`` (text-image plus
        image-image cosine), ``aesthetic``, ``max_iou`` and ``docsim``."""
        txt = l2_normalize(self.text_features(captions))
        fp = l2_normalize(self.image_features(imgs_pred))
        fg = l2_normalize(self.image_features(imgs_gt))
        clip = torch.sum(txt * fp, dim=-1) + torch.sum(fg * fp, dim=-1)
        aes = aesthetic_apply(self.aesthetic_params, l2_normalize(fp))
        pred_ids = self._layout_ids(layout_pred, close_set=True)
        gt_ids = self._layout_ids(layout_gt, close_set=False)
        return {"clip": clip.cpu().numpy(), "aesthetic": aes.cpu().numpy(),
                "max_iou": compute_maximum_iou(gt_ids, pred_ids),
                "docsim": compute_docsim(gt_ids, pred_ids)}

    def __call__(self, captions: List[str], imgs_pred, imgs_gt,
                 layout_pred: List[Layout],
                 layout_gt: List[Layout]) -> np.ndarray:
        c = self.components(captions, imgs_pred, imgs_gt, layout_pred,
                            layout_gt)
        return (c["clip"] + c["aesthetic"] * AESTHETIC_WEIGHT
                + c["max_iou"] * MAX_IOU_WEIGHT + c["docsim"] * DOCSIM_WEIGHT)
