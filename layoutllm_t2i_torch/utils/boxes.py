"""Box drawing (layoutllm_t2i_tpu/utils/boxes.py; reference utils.py:37-46,
txt2img.py:329-353), in numpy: no imaging library is needed where the
port runs.

The outlines are the pixels of Pillow's ``ImageDraw.rectangle(xy,
outline, width=4)`` (the JAX package's drawing), corners truncated to
ints; the phrase labels are drawn from the 5x7 bitmap font below, not
Pillow's default font, so their pixels differ from the JAX package's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

BOX_COLOR = (0, 0, 255)
LABEL_COLOR = (255, 0, 0)
BOX_WIDTH = 4
LABEL_OFFSET = 18          # the label's top sits this far above the box
GLYPH_W, GLYPH_H = 5, 7
CELL_W, CELL_H = GLYPH_W + 1, GLYPH_H + 1

# printable ASCII 0x20-0x7e, 5 columns a glyph, bit 0 the top row
_FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "0041221408" "0201510906" "324979413e" "7e1111117e" "7f49494936"
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"
    "7f2018207f" "6314081463" "0304780403" "6151494543" "00007f4141"
    "0204081020" "41417f0000" "0402010204" "4040404040" "0001020400"
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"
    "087e090102" "081454543c" "7f08040478" "00447d4000" "2040443d00"
    "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "0201020402")


def _glyph(ch: str) -> np.ndarray:
    """(7, 5) bool pixels of one character; '?' outside printable ASCII."""
    code = ord(ch) if 0x20 <= ord(ch) <= 0x7E else ord("?")
    cols = _FONT[(code - 0x20) * GLYPH_W:(code - 0x1F) * GLYPH_W]
    return np.array([[(col >> row) & 1 for col in cols]
                     for row in range(GLYPH_H)], dtype=bool)


def label_rect(x: int, y: int, text: str) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1), exclusive ends, of a label's cells at (x, y)."""
    return x, y, x + CELL_W * len(text), y + CELL_H


def draw_text(img: np.ndarray, x: int, y: int, text: str, color) -> None:
    """Draw ``text`` into img (H, W, 3) uint8 in place, its top-left at
    (x, y), clipped to the image."""
    h, w = img.shape[:2]
    for i, ch in enumerate(text):
        g = _glyph(ch)
        gx = x + i * CELL_W
        ys, xs = np.nonzero(g)
        ys, xs = ys + y, xs + gx
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = color


def outline_mask(h: int, w: int, box, width: int = BOX_WIDTH) -> np.ndarray:
    """(h, w) bool: the pixels Pillow's ``rectangle(box, width=width)``
    outlines. Its corners truncate to ints; each of ``width`` rings is two
    horizontal spans at rows y0 + i and y1 - i (x0..x1 inclusive) and two
    vertical runs at columns x0 + i and x1 - i, drawn from row y0 + width
    towards row y1 - width + 1, that row excluded (Pillow's line)."""
    x0, y0, x1, y1 = (int(v) for v in box)
    out = np.zeros((h, w), dtype=bool)

    def hline(y, a, b):
        if 0 <= y < h and a <= b:
            out[y, max(a, 0):min(b, w - 1) + 1] = True

    def vline(x, start, stop):
        lo, hi = (start, stop - 1) if start < stop else (stop + 1, start)
        if 0 <= x < w and lo <= hi:
            out[max(lo, 0):min(hi, h - 1) + 1, x] = True

    for i in range(width):
        hline(y0 + i, x0, x1)
        hline(y1 - i, x0, x1)
        vline(x1 - i, y0 + width, y1 - width + 1)
        vline(x0 + i, y0 + width, y1 - width + 1)
    return out


def draw_boxes_ltrb(image_uint8: np.ndarray, locations: Sequence[Sequence[float]],
                    phrases: Sequence[str]) -> np.ndarray:
    """image (H, W, 3) uint8 + normalized ltrb boxes -> a copy with blue
    4-pixel box outlines and each phrase in red at (x0*w, y0*h - 18)."""
    img = np.array(image_uint8, dtype=np.uint8, copy=True)
    h, w = img.shape[:2]
    for (x0, y0, x1, y1), phrase in zip(locations, phrases):
        img[outline_mask(h, w, (x0 * w, y0 * h, x1 * w, y1 * h))] = BOX_COLOR
        draw_text(img, int(np.floor(x0 * w)),
                  int(np.floor(y0 * h - LABEL_OFFSET)), phrase, LABEL_COLOR)
    return img
