"""TSV web-scale grounding data in the upstream GLIGEN format (a copy of
layoutllm_t2i_tpu/data/tsv.py).

Reference: GLIGEN/dataset/tsv.py (TSVFile with .lineidx random access) and
tsv_dataset.py:163-320 (base64 images + per-entity precomputed CLIP text/
image embeddings; image embeddings re-projected through the CLIP projection
matrix and renormalized to norm 28.7 in 'after_reproject' mode), and the
split/merge tooling of tsv_split_merge.py. Images decode through
``utils/images.py decode_rgb`` (no Pillow for an 8-bit RGB PNG with
unfiltered rows) and resize with Pillow's bicubic filter
(``utils/resample.py``), so items are bit-equal to the JAX dataset's.
"""
from __future__ import annotations

import base64
import json
import os
import os.path as op
import threading
from typing import List, Optional

import numpy as np

from ..utils.images import decode_rgb
from ..utils.resample import resize_bicubic


class TSVFile:
    """Random-access TSV via a .lineidx offsets file. A lock keeps each
    row's seek and read together: the loader's worker threads share the
    handle (the JAX package's TSVFile does not lock, and its threads can
    read one row's start with another's end)."""

    def __init__(self, tsv_file: str, generate_lineidx: bool = True):
        self.tsv_file = tsv_file
        self.lineidx = op.splitext(tsv_file)[0] + ".lineidx"
        self._fp = None
        self._lineidx: Optional[List[int]] = None
        if not op.isfile(self.lineidx) and generate_lineidx:
            create_lineidx(self.tsv_file, self.lineidx)
        self._pid = None
        self._lock = threading.Lock()

    def num_rows(self) -> int:
        with self._lock:
            self._ensure_lineidx()
        return len(self._lineidx)

    def seek(self, idx: int) -> List[str]:
        with self._lock:
            self._ensure_tsv_opened()
            self._ensure_lineidx()
            self._fp.seek(self._lineidx[idx])
            line = self._fp.readline()
        return [s.strip() for s in line.split("\t")]

    def __len__(self):
        return self.num_rows()

    def __getitem__(self, index: int):
        return self.seek(index)

    def _ensure_lineidx(self):
        if self._lineidx is None:
            with open(self.lineidx) as fp:
                self._lineidx = [int(i.strip()) for i in fp.readlines()]

    def _ensure_tsv_opened(self):
        # one handle per process (fork-safe, like the reference's per-pid gate)
        if self._fp is None or self._pid != os.getpid():
            self._fp = open(self.tsv_file, "r")
            self._pid = os.getpid()


def create_lineidx(path_in: str, path_out: str) -> None:
    with open(path_in, "rb") as f, open(path_out, "w") as out:
        pos = 0
        while True:
            out.write(str(pos) + "\n")
            line = f.readline()
            if not line:
                break
            pos += len(line)
    # remove the trailing offset written after the final line
    with open(path_out) as f:
        lines = f.read().splitlines()
    with open(path_out, "w") as f:
        f.write("\n".join(lines[:-1]) + ("\n" if len(lines) > 1 else ""))


def decode_base64_image(b64: str) -> np.ndarray:
    return decode_rgb(base64.b64decode(b64), "base64 image")


def reproject_embedding(emb: np.ndarray, projection_matrix: np.ndarray,
                        norm: float = 28.7) -> np.ndarray:
    """'after_reproject': penultimate CLIP feature -> projected and rescaled
    (tsv_dataset.py:190-200, txt2img.py:119-144)."""
    out = emb @ projection_matrix.T
    out = out / np.linalg.norm(out) * norm
    return out


class TSVGroundingDataset:
    """Rows: (image_id, json_annotations, base64_image). Annotation schema per
    the upstream GLIGEN TSV data: caption plus per-entity boxes and
    precomputed text/image embedding indices."""

    def __init__(self, tsv_path: str, max_boxes: int = 30, image_size: int = 512,
                 projection_matrix: Optional[np.ndarray] = None):
        self.tsv = TSVFile(tsv_path)
        self.max_boxes = max_boxes
        self.image_size = image_size
        self.projection_matrix = projection_matrix

    def __len__(self):
        return len(self.tsv)

    def __getitem__(self, idx: int):
        row = self.tsv[idx]
        anno = json.loads(row[1])
        img = decode_base64_image(row[2])
        img = np.asarray(
            resize_bicubic(img, (self.image_size, self.image_size)),
            np.float32) / 127.5 - 1.0

        boxes = np.zeros((self.max_boxes, 4), np.float32)
        masks = np.zeros((self.max_boxes,), np.float32)
        text_emb = np.zeros((self.max_boxes, 768), np.float32)
        image_emb = np.zeros((self.max_boxes, 768), np.float32)
        for k, ent in enumerate(anno.get("entities", [])[: self.max_boxes]):
            boxes[k] = ent["box"]
            masks[k] = 1
            if "text_embedding" in ent:
                text_emb[k] = np.asarray(ent["text_embedding"], np.float32)
            if "image_embedding" in ent:
                e = np.asarray(ent["image_embedding"], np.float32)
                if self.projection_matrix is not None:
                    e = reproject_embedding(e, self.projection_matrix)
                image_emb[k] = e
        return {
            "image": img, "caption": anno.get("caption", ""), "boxes": boxes,
            "masks": masks, "text_embeddings": text_emb,
            "image_embeddings": image_emb,
        }


def tsv_split(tsv_path: str, num_shards: int, out_dir: str) -> List[str]:
    """Shard a TSV + lineidx into num_shards contiguous pieces
    (tsv_split_merge.py equivalent)."""
    os.makedirs(out_dir, exist_ok=True)
    src = TSVFile(tsv_path)
    n = len(src)
    per = (n + num_shards - 1) // num_shards
    outs = []
    base = op.splitext(op.basename(tsv_path))[0]
    for s in range(num_shards):
        path = op.join(out_dir, f"{base}.{s}.tsv")
        with open(path, "w") as f:
            for i in range(s * per, min((s + 1) * per, n)):
                f.write("\t".join(src[i]) + "\n")
        create_lineidx(path, op.splitext(path)[0] + ".lineidx")
        outs.append(path)
    return outs


def tsv_merge(tsv_paths: List[str], out_path: str) -> str:
    with open(out_path, "w") as f:
        for p in tsv_paths:
            src = TSVFile(p)
            for i in range(len(src)):
                f.write("\t".join(src[i]) + "\n")
    create_lineidx(out_path, op.splitext(out_path)[0] + ".lineidx")
    return out_path
