"""Inpainting masks (layoutllm_t2i_tpu/pipeline/inpaint.py; reference
GLIGEN/inpaint_mask_func.py): box -> keep-mask rasterisation and the random
free-form stroke masks of the object and background. Host NumPy; the
strokes are drawn with Pillow's ImageDraw (in place of cv2's line and
circle), imported inside the functions that draw them: no card path calls
them (only ``draw_masks_from_boxes``' randomize_fg_mask and
random_add_bg_mask do), and the card's machine has no Pillow. The
sampler's per-step blend is diffusion/samplers.py InpaintBlend.

Mask convention: 1 = visible/keep, 0 = the region to inpaint.
"""
from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np


def _free_form_mask(rng: random.Random, h: int, w: int, max_vertex: int,
                    max_length: int, min_brush: int, max_brush: int,
                    max_angle: int) -> np.ndarray:
    from PIL import Image, ImageDraw

    img = Image.new("F", (w, h), 0.0)
    draw = ImageDraw.Draw(img)
    num_vertex = rng.randint(1, max_vertex)
    y, x = rng.randint(1, h - 1), rng.randint(1, w - 1)
    brush = min_brush
    for i in range(num_vertex):
        angle = rng.randint(1, max_angle) / 360.0 * 2 * np.pi
        if i % 2 == 0:
            angle = 2 * np.pi - angle
        length = rng.randint(0, max_length)
        brush = rng.randint(min_brush, max_brush) // 2 * 2
        ny = int(np.clip(y + length * np.cos(angle), 0, h - 1))
        nx = int(np.clip(x + length * np.sin(angle), 0, w - 1))
        draw.line([(x, y), (nx, ny)], fill=1.0, width=brush)
        draw.ellipse([x - brush // 2, y - brush // 2, x + brush // 2, y + brush // 2],
                     fill=1.0)
        y, x = ny, nx
    draw.ellipse([x - brush // 2, y - brush // 2, x + brush // 2, y + brush // 2],
                 fill=1.0)
    return np.asarray(img, dtype=np.float32)


def generate_stroke_mask(rng: random.Random, size: int, max_parts: int,
                         max_vertex: int, max_length: int, min_brush: int,
                         max_brush: int, max_angle: int = 360) -> np.ndarray:
    mask = np.zeros((size, size), np.float32)
    for _ in range(rng.randint(1, max_parts)):
        mask += _free_form_mask(rng, size, size, max_vertex, max_length,
                                min_brush, max_brush, max_angle)
    return np.minimum(mask, 1.0)


def get_fg_mask(rng: random.Random, height: int, width: int) -> np.ndarray:
    """Random object mask covering ~75% of the box (inpaint_mask_func.py:47)."""
    from PIL import Image

    m = 1.0 - generate_stroke_mask(rng, 64, max_parts=6, max_vertex=10,
                                   max_length=80, min_brush=10, max_brush=32)
    img = Image.fromarray(m).resize((width, height), Image.NEAREST)
    return np.asarray(img, dtype=np.float32)


def get_bg_mask(rng: random.Random, size: int = 64) -> np.ndarray:
    """Random global mask covering ~30% (inpaint_mask_func.py:94)."""
    return 1.0 - generate_stroke_mask(rng, size, max_parts=4, max_vertex=10,
                                      max_length=32, min_brush=3, max_brush=12)


def draw_masks_from_boxes(boxes: np.ndarray, size: int = 64,
                          randomize_fg_mask: bool = False,
                          random_add_bg_mask: bool = False,
                          seed: Optional[int] = None) -> np.ndarray:
    """boxes: (B, MO, 4) normalized xyxy -> (B, size, size, 1) keep-masks
    (NHWC; the torch reference emits NCHW)."""
    rng = random.Random(seed)
    out = []
    for batch_boxes in boxes:
        image_mask = np.ones((size, size), np.float32)
        for bx in batch_boxes:
            x0, y0, x1, y1 = (np.asarray(bx) * size).astype(int)
            ow, oh = x1 - x0, y1 - y0
            if ow <= 0 or oh <= 0:
                continue
            if randomize_fg_mask and rng.random() < 0.5 and oh >= 4 and ow >= 4:
                image_mask[y0:y1, x0:x1] *= get_fg_mask(rng, oh, ow)
            else:
                image_mask[y0:y1, x0:x1] = 0
        if random_add_bg_mask and rng.random() < 0.5:
            image_mask *= get_bg_mask(rng, size)
        out.append(image_mask)
    return np.stack(out)[..., None]
