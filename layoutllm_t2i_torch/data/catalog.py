"""Dataset catalog registrations (a copy of layoutllm_t2i_tpu/data/catalog.py;
reference GLIGEN/dataset/catalog.py:3-149).

The reference registry maps 12 names to dataset classes + storage paths under
a data ROOT. Registrations here mirror those names onto our constructors:

  * TSV grounding corpora (VG/Flickr/SBU/CC3M/CC12M/O365) -> TSVGroundingDataset
    over the same `GROUNDING/<name>/tsv/train-00.tsv` layout;
  * COCO2017Keypoint -> LayoutDataset (the reference repurposes
    dataset_layout.LayoutDataset for this entry, catalog.py:112-122);
  * condition-map corpora (CC3M hed/canny/depth, DIODENormal, ADESemantic) ->
    ConditionMapDataset. The reference streams maps from per-modality dataset
    classes over TSV/zip; here maps live as image files in a sibling
    directory (pass ``condition_dir``) — same capability, simpler storage.

Importing this module populates ``concat.DATASET_CATALOG``; build with
``concat.build_datasets({"VGGrounding": {...}}, ROOT=...)``.
"""
from __future__ import annotations

import os

from .coco import LayoutDataset
from .concat import register_dataset
from .modalities import ConditionMapDataset, KeypointDataset
from .tsv import TSVGroundingDataset

_TSV_PATHS = {
    "VGGrounding": "GROUNDING/gqa/tsv/train-00.tsv",
    "FlickrGrounding": "GROUNDING/flickr30k/tsv/train-00.tsv",
    "SBUGrounding": "GROUNDING/SBU/tsv/train-00.tsv",
    "CC3MGrounding": "GROUNDING/CC3M/tsv/train-00.tsv",
    "CC12MGrounding": "GROUNDING/CC12M/tsv/train-00.tsv",
    "Obj365Detection": "OBJECTS365/tsv/train-00.tsv",
}


def _register_tsv(name: str, rel_path: str):
    @register_dataset(name)
    def _build(ROOT: str, tsv_path: str | None = None, **kw):
        return TSVGroundingDataset(
            tsv_path=tsv_path or os.path.join(ROOT, rel_path), **kw)
    return _build


for _name, _rel in _TSV_PATHS.items():
    _register_tsv(_name, _rel)


_MAP_DIRS = {
    "CC3MGroundingHed": ("GROUNDING/CC3M/images", "GROUNDING/CC3M/hed"),
    "CC3MGroundingCanny": ("GROUNDING/CC3M/images", "GROUNDING/CC3M/canny"),
    "CC3MGroundingDepth": ("GROUNDING/CC3M/images", "GROUNDING/CC3M/depth"),
    "DIODENormal": ("DIODE/images", "DIODE/normal"),
    "ADESemantic": ("ADE/images", "ADE/annotations"),
}


def _register_map(name: str, img_rel: str, cond_rel: str):
    @register_dataset(name)
    def _build(ROOT: str, image_dir: str | None = None,
               condition_dir: str | None = None, **kw):
        return ConditionMapDataset(
            image_dir=image_dir or os.path.join(ROOT, img_rel),
            condition_dir=condition_dir or os.path.join(ROOT, cond_rel), **kw)
    return _build


for _name, (_img, _cond) in _MAP_DIRS.items():
    _register_map(_name, _img, _cond)


@register_dataset("COCO2017Keypoint")
def _coco2017_keypoint(ROOT: str, image_dir: str | None = None,
                       instances_json: str | None = None,
                       captions_json: str | None = None, **kw):
    base = os.path.join(ROOT, "COCO")
    return LayoutDataset(
        image_dir=image_dir or os.path.join(base, "images"),
        instances_json=instances_json or os.path.join(
            base, "annotations/instances_train2017.json"),
        captions_json=captions_json or os.path.join(
            base, "annotations/captions_train2017.json"), **kw)


@register_dataset("COCO2014Layout")
def _coco2014_layout(ROOT: str, image_dir: str | None = None,
                     instances_json: str | None = None,
                     captions_json: str | None = None, **kw):
    base = os.path.join(ROOT, "COCO2014")
    return LayoutDataset(
        image_dir=image_dir or os.path.join(base, "train2014"),
        instances_json=instances_json or os.path.join(
            base, "annotations/instances_train2014.json"),
        captions_json=captions_json or os.path.join(
            base, "annotations/captions_train2014.json"), **kw)


@register_dataset("COCOKeypoint")
def _coco_keypoint(ROOT: str, image_dir: str | None = None,
                   keypoints_json: str | None = None,
                   captions_json: str | None = None, **kw):
    base = os.path.join(ROOT, "COCO")
    return KeypointDataset(
        image_dir=image_dir or os.path.join(base, "images"),
        keypoints_json=keypoints_json or os.path.join(
            base, "annotations/person_keypoints_train2017.json"),
        captions_json=captions_json or os.path.join(
            base, "annotations/captions_train2017.json"), **kw)
