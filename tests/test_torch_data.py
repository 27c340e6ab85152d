"""The port's data loaders (layoutllm_t2i_torch/data/) against the JAX
package's, on fixtures this module writes.

* Every dataset's items are bit-equal to the JAX dataset's for the same
  seed (``np.array_equal`` on images, boxes, masks, embeddings and points;
  captions and labels equal): ``LayoutDataset`` with flips, crowd boxes,
  boxes the crop makes degenerate, images without a caption and
  ``min_boxes``; ``TSVGroundingDataset`` with and without a projection
  matrix; ``ConditionMapDataset``; ``KeypointDataset``; ``ConcatDataset``;
  and all 14 catalog names built from one root. The images come in
  utils/images.py's PNG form (read without Pillow) and as a JPEG, a
  grayscale PNG, an RGBA PNG and a row-filtered RGB PNG (Pillow's route).
* The ``.lineidx``, ``tsv_split`` and ``tsv_merge`` files equal the JAX
  package's byte for byte; a TSV's rows stay whole when 16 threads read
  them through one ``TSVFile``.
* ``PrefetchLoader`` gives the JAX loader's batches in order at one worker
  over two epochs (one process, and each of two), the same batches at 4
  and at 16 workers, never decodes more than ``prefetch + num_workers``
  batches ahead of its consumer (the JAX loader decodes the whole epoch),
  hands a failed fetch to its consumer and stops its thread when closed.
* With Pillow blocked, PNG-form fixtures load through every dataset, equal
  to the JAX items taken with Pillow, and a JPEG raises an error naming
  the file and Pillow.
"""
import base64
import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from layoutllm_t2i_tpu.data import coco as jcoco
from layoutllm_t2i_tpu.data import concat as jconcat
from layoutllm_t2i_tpu.data import loader as jloader
from layoutllm_t2i_tpu.data import modalities as jmod
from layoutllm_t2i_tpu.data import tsv as jtsv

from layoutllm_t2i_torch.data import coco as pcoco
from layoutllm_t2i_torch.data import concat as pconcat
from layoutllm_t2i_torch.data import loader as ploader
from layoutllm_t2i_torch.data import modalities as pmod
from layoutllm_t2i_torch.data import tsv as ptsv
from layoutllm_t2i_torch.utils.images import PNGFormatError, png_bytes_uint8, read_png

SIZE = 32
CATEGORIES = [{"id": 1, "name": "person"}, {"id": 3, "name": "car"},
              {"id": 18, "name": "dog"}, {"id": 62, "name": "chair"}]
# (file stem, (w, h), format): "png" is utils/images.py's form, read
# without Pillow; the others take Pillow's route
IMAGES = [("a", (40, 30), "png"), ("b", (30, 40), "jpg"),
          ("c", (33, 50), "gray"), ("d", (32, 32), "rgba"),
          ("e", (20, 13), "filtered"), ("f", (50, 21), "png"),
          ("g", (45, 45), "png"), ("h", (64, 48), "png")]
PNG_IMAGES = [(stem, wh, "png") for stem, wh, _ in IMAGES]


def _pixels(w, h, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def image_bytes(arr: np.ndarray, fmt: str) -> bytes:
    if fmt == "png":
        return png_bytes_uint8(arr)
    buf = io.BytesIO()
    img = Image.fromarray(arr)
    if fmt == "jpg":
        img.save(buf, format="JPEG", quality=90)
    elif fmt == "gray":
        img.convert("L").save(buf, format="PNG")
    elif fmt == "rgba":
        img.putalpha(Image.fromarray(arr[..., 0]))
        img.save(buf, format="PNG")
    else:  # "filtered": Pillow's PNG writer filters rows adaptively
        img.save(buf, format="PNG")
    return buf.getvalue()


def write_images(dirname, images, seed=0):
    """{stem: (file name, w, h)} of ``images`` written under ``dirname``."""
    os.makedirs(dirname, exist_ok=True)
    names = {}
    for i, (stem, (w, h), fmt) in enumerate(images):
        name = stem + (".jpg" if fmt == "jpg" else ".png")
        with open(os.path.join(dirname, name), "wb") as f:
            f.write(image_bytes(_pixels(w, h, seed + i), fmt))
        names[stem] = (name, w, h)
    return names


def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def write_coco(image_dir, instances, captions, images=IMAGES, seed=0):
    """The images, and COCO instances and captions JSON for them (ids 1..N
    in order): 1-6 seeded boxes an image, a crowd box on "a" and a box on
    "a" that the crop leaves degenerate, one box only on "f", no caption
    for "g", three captions on each other image."""
    rng = np.random.default_rng(seed)
    names = write_images(image_dir, images, seed)
    inst = {"images": [], "annotations": [], "categories": CATEGORIES}
    caps = {"annotations": []}
    for img_id, (stem, (name, w, h)) in enumerate(names.items(), 1):
        inst["images"].append({"id": img_id, "file_name": name, "width": w,
                               "height": h})
        boxes = []
        for _ in range(1 if stem == "f" else int(rng.integers(2, 7))):
            x, y = rng.uniform(0, w * 0.8), rng.uniform(0, h * 0.8)
            boxes.append([x, y, rng.uniform(1, w - x), rng.uniform(1, h - y)])
        if stem == "a":
            # 40x30 to 32: the resize gives 43 columns, the crop drops 5
            boxes.append([0.0, 0.0, 3.0, 20.0])
        for k, box in enumerate(boxes):
            inst["annotations"].append({
                "id": len(inst["annotations"]) + 1, "image_id": img_id,
                "bbox": box, "area": float(box[2] * box[3]),
                "category_id": CATEGORIES[int(rng.integers(4))]["id"],
                "iscrowd": int(stem == "a" and k == 0)})
        if stem != "g":
            caps["annotations"] += [{"image_id": img_id,
                                     "caption": f"{stem} caption {c}"}
                                    for c in range(3)]
    _dump(instances, inst)
    _dump(captions, caps)
    return names


def write_keypoints(names, keypoints, seed=0):
    """person_keypoints JSON over write_coco's images (the same ids): 0-3
    persons an image, with invisible points (v 0) and points outside the
    crop."""
    rng = np.random.default_rng(seed)
    kp = {"images": [], "annotations": [], "categories": CATEGORIES[:1]}
    for img_id, (name, w, h) in enumerate(names.values(), 1):
        kp["images"].append({"id": img_id, "file_name": name, "width": w,
                             "height": h})
        for _ in range(int(rng.integers(0, 4))):
            pts = np.stack([rng.uniform(-2, w + 2, 17),
                            rng.uniform(-2, h + 2, 17),
                            rng.integers(0, 3, 17)], 1)
            kp["annotations"].append({
                "image_id": img_id, "num_keypoints": int((pts[:, 2] > 0).sum()),
                "keypoints": [float(v) for v in pts.reshape(-1)]})
    _dump(keypoints, kp)


def write_tsv(path, images=IMAGES, seed=0, n=6):
    """Rows (id, annotations JSON, base64 image) over ``images`` in turn;
    0-4 entities a row with boxes, some with text and image embeddings."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i in range(n):
            _, (w, h), fmt = images[i % len(images)]
            ents = []
            for k in range(int(rng.integers(0, 5))):
                x0, y0 = rng.uniform(0, 0.5, 2)
                ent = {"box": [float(x0), float(y0), float(x0 + 0.3),
                               float(y0 + 0.4)]}
                if k % 2 == 0:
                    ent["text_embedding"] = rng.normal(size=768).tolist()
                if k != 1:
                    ent["image_embedding"] = rng.normal(size=768).tolist()
                ents.append(ent)
            anno = {"caption": f"row {i}", "entities": ents}
            b64 = base64.b64encode(image_bytes(_pixels(w, h, seed + i), fmt))
            f.write(f"id{i}\t{json.dumps(anno)}\t{b64.decode()}\n")


def write_maps(image_dir, cond_dir, images=IMAGES, seed=0):
    """Six images and five same-stem maps of other sizes (grayscale PNGs
    and utils/images.py PNGs in turn, or all PNG-form with a PNG-form
    ``images``); the sixth image has no map."""
    write_images(image_dir, images[:6], seed + 200)
    gray = images is IMAGES
    maps = [(stem, (w + 3, h - 2), "gray" if gray and i % 2 else "png")
            for i, (stem, (w, h), _) in enumerate(images[:5])]
    write_images(cond_dir, maps, seed + 300)


# the catalog's storage layout under one ROOT (data/catalog.py)
TSV_NAMES = {"VGGrounding": "GROUNDING/gqa/tsv/train-00.tsv",
             "FlickrGrounding": "GROUNDING/flickr30k/tsv/train-00.tsv",
             "SBUGrounding": "GROUNDING/SBU/tsv/train-00.tsv",
             "CC3MGrounding": "GROUNDING/CC3M/tsv/train-00.tsv",
             "CC12MGrounding": "GROUNDING/CC12M/tsv/train-00.tsv",
             "Obj365Detection": "OBJECTS365/tsv/train-00.tsv"}
MAP_NAMES = {"CC3MGroundingHed": ("GROUNDING/CC3M/images", "GROUNDING/CC3M/hed"),
             "CC3MGroundingCanny": ("GROUNDING/CC3M/images", "GROUNDING/CC3M/canny"),
             "CC3MGroundingDepth": ("GROUNDING/CC3M/images", "GROUNDING/CC3M/depth"),
             "DIODENormal": ("DIODE/images", "DIODE/normal"),
             "ADESemantic": ("ADE/images", "ADE/annotations")}
COCO_NAMES = ("COCO2017Keypoint", "COCO2014Layout", "COCOKeypoint")


def write_root(r, images=IMAGES):
    """Every catalog entry's files under ``r``."""
    j = lambda *p: os.path.join(r, *p)
    for i, rel in enumerate(TSV_NAMES.values()):
        write_tsv(j(rel), images, seed=i)
    for i, (img_rel, cond_rel) in enumerate(MAP_NAMES.values()):
        write_maps(j(img_rel), j(cond_rel), images, seed=i)
    write_coco(j("COCO2014", "train2014"),
               j("COCO2014", "annotations", "instances_train2014.json"),
               j("COCO2014", "annotations", "captions_train2014.json"), images)
    names = write_coco(j("COCO", "images"),
                       j("COCO", "annotations", "instances_train2017.json"),
                       j("COCO", "annotations", "captions_train2017.json"),
                       images, seed=5)
    write_keypoints(names, j("COCO", "annotations",
                             "person_keypoints_train2017.json"), seed=7)
    return r


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_root(str(tmp_path_factory.mktemp("data_root")))


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            assert np.array_equal(g, w), key
        else:
            assert g == w, key


def assert_datasets_equal(port_ds, jax_ds, passes=1):
    """Every item, in order, ``passes`` times (the flip and caption draws
    go on from the pass before)."""
    assert len(port_ds) == len(jax_ds) > 0
    for _ in range(passes):
        for i in range(len(jax_ds)):
            assert_items_equal(port_ds[i], jax_ds[i])


def _coco_paths(root):
    j = lambda *p: os.path.join(root, "COCO2014", *p)
    return dict(image_dir=j("train2014"),
                instances_json=j("annotations", "instances_train2014.json"),
                captions_json=j("annotations", "captions_train2014.json"))


def _kp_args(root):
    j = lambda *p: os.path.join(root, "COCO", *p)
    return (j("images"), j("annotations", "person_keypoints_train2017.json"),
            j("annotations", "captions_train2017.json"))


def test_fixtures_take_both_routes(root):
    image_dir = _coco_paths(root)["image_dir"]
    for stem, _, fmt in IMAGES:
        data = open(os.path.join(image_dir, stem + (".jpg" if fmt == "jpg"
                                                    else ".png")), "rb").read()
        if fmt == "png":
            read_png(data)
        else:
            with pytest.raises(ValueError):  # a PNGFormatError, or not a PNG
                read_png(data)
    with pytest.raises(PNGFormatError, match="filter"):
        read_png(open(os.path.join(image_dir, "e.png"), "rb").read())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(min_boxes=3, max_boxes=2),
    dict(random_flip=False, seed=4, image_size=24),
], ids=["flips", "min_boxes", "no_flip"])
def test_layout_dataset_bit_equal(root, kw):
    kw = {"image_size": SIZE, **kw}
    port = pcoco.LayoutDataset(**_coco_paths(root), **kw)
    jax_ds = jcoco.LayoutDataset(**_coco_paths(root), **kw)
    assert port.ids == jax_ds.ids
    assert_datasets_equal(port, jax_ds, passes=2)


def test_layout_dataset_skips_crowd_degenerate_and_captionless(root):
    ds = pcoco.LayoutDataset(**_coco_paths(root), image_size=SIZE,
                             random_flip=False)
    by_name = {im["file_name"]: im["id"] for im in ds.index.images.values()}
    with open(_coco_paths(root)["instances_json"]) as f:
        crowd = [a for a in json.load(f)["annotations"] if a["iscrowd"]]
    assert len(crowd) == 1
    assert crowd[0]["id"] not in {
        a["id"] for a in ds.index.anns_by_image[crowd[0]["image_id"]]}
    assert by_name["g.png"] not in ds.ids  # no caption
    a = ds[ds.ids.index(by_name["a.png"])]
    assert a["masks"].sum() == len(ds.index.anns_by_image[by_name["a.png"]]) - 1
    on = a["boxes"][a["masks"] > 0]
    assert ((on >= 0) & (on <= 1)).all() and (on[:, 2:] > on[:, :2]).all()
    assert a["image"].shape == (SIZE, SIZE, 3)
    assert -1 <= a["image"].min() and a["image"].max() <= 1
    assert by_name["f.png"] not in pcoco.LayoutDataset(
        **_coco_paths(root), image_size=SIZE, min_boxes=2).ids


@pytest.mark.parametrize("projected", [False, True])
def test_tsv_dataset_bit_equal(root, projected):
    path = os.path.join(root, TSV_NAMES["VGGrounding"])
    proj = (np.random.default_rng(9).normal(size=(768, 768)).astype(np.float32)
            if projected else None)
    assert_datasets_equal(
        ptsv.TSVGroundingDataset(path, max_boxes=3, image_size=SIZE,
                                 projection_matrix=proj),
        jtsv.TSVGroundingDataset(path, max_boxes=3, image_size=SIZE,
                                 projection_matrix=proj))


def test_tsv_rows_intact_under_threads(root):
    # 16 threads share one TSVFile handle, threads switched often: every
    # row read whole (the JAX TSVFile, unlocked, can splice two rows)
    tsv = ptsv.TSVFile(os.path.join(root, TSV_NAMES["CC12MGrounding"]))
    want = [tsv[i] for i in range(len(tsv))]
    bad = []

    def read():
        for _ in range(20):
            for i in range(len(want)):
                if tsv[i] != want[i]:
                    bad.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=read) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


def test_tsv_files_byte_equal(root, tmp_path):
    with open(os.path.join(root, TSV_NAMES["SBUGrounding"]), "rb") as f:
        src = f.read()
    out = {}
    for name, mod in (("port", ptsv), ("jax", jtsv)):
        d = tmp_path / name
        d.mkdir()
        tsv = d / "t.tsv"
        tsv.write_bytes(src)
        mod.create_lineidx(str(tsv), str(d / "t.lineidx"))
        shards = mod.tsv_split(str(tsv), 4, str(d / "shards"))
        merged = mod.tsv_merge(shards, str(d / "merged.tsv"))
        files = [str(d / "t.lineidx"), merged,
                 os.path.splitext(merged)[0] + ".lineidx"]
        for s in shards:
            files += [s, os.path.splitext(s)[0] + ".lineidx"]
        out[name] = [(os.path.relpath(f, d), (d / f).read_bytes()) for f in files]
        # the merged shards are the source again, row for row
        assert (d / "merged.tsv").read_bytes() == src
        rows = mod.TSVFile(str(tsv))
        assert len(rows) == 6 and rows[5][0] == "id5"
    assert out["port"] == out["jax"]


def test_condition_map_dataset_bit_equal(root):
    img_rel, cond_rel = MAP_NAMES["DIODENormal"]
    args = (os.path.join(root, img_rel), os.path.join(root, cond_rel))
    caps = {"a": "a map", "c": "c map"}
    port = pmod.ConditionMapDataset(*args, captions=caps, image_size=SIZE)
    assert len(port) == 5  # the image without a map is left out
    assert_datasets_equal(
        port, jmod.ConditionMapDataset(*args, captions=caps, image_size=SIZE))
    item = port[0]
    assert 0 <= item["condition"].min() and item["condition"].max() <= 1


def test_keypoint_dataset_bit_equal(root):
    port = pmod.KeypointDataset(*_kp_args(root), image_size=SIZE, max_persons=2)
    jax_ds = jmod.KeypointDataset(*_kp_args(root), image_size=SIZE, max_persons=2)
    assert pmod.COCO_KEYPOINT_NAMES == jmod.COCO_KEYPOINT_NAMES
    assert_datasets_equal(port, jax_ds, passes=2)
    masked = np.concatenate([port[i]["points"][port[i]["masks"] > 0]
                             for i in range(len(port))])
    assert len(masked) and ((masked >= 0) & (masked <= 1)).all()


def test_concat_dataset_bit_equal(root):
    def build(coco, tsv, mod, concat):
        parts = [coco.LayoutDataset(**_coco_paths(root), image_size=SIZE),
                 tsv.TSVGroundingDataset(os.path.join(root, TSV_NAMES["CC3MGrounding"]),
                                         image_size=SIZE),
                 mod.KeypointDataset(*_kp_args(root), image_size=SIZE)]
        return concat.ConcatDataset(parts, repeats=[2, 1, 3])

    port = build(pcoco, ptsv, pmod, pconcat)
    jax_ds = build(jcoco, jtsv, jmod, jconcat)
    assert port.total_images() == jax_ds.total_images() == len(port)
    assert_datasets_equal(port, jax_ds)
    with pytest.raises(ValueError, match="repeats"):
        pconcat.ConcatDataset([[1]], repeats=[1, 2])


def test_catalog_builds_the_14_names_from_one_root(root):
    names = set(TSV_NAMES) | set(MAP_NAMES) | set(COCO_NAMES)
    assert len(names) == 14
    assert set(pconcat.DATASET_CATALOG) == set(jconcat.DATASET_CATALOG) == names
    spec = {name: {} for name in sorted(names)}
    port = pconcat.build_datasets(spec, ROOT=root, image_size=16)
    jax_ds = jconcat.build_datasets(spec, ROOT=root, image_size=16)
    for name, p, j in zip(spec, port, jax_ds):
        assert type(p).__name__ == type(j).__name__, name
        assert_datasets_equal(p, j)
    with pytest.raises(KeyError, match="unknown dataset"):
        pconcat.build_datasets({"NoSuchSet": {}}, ROOT=root)


# ---------------------------------------------------------------- the loader


class Indexed:
    """Items that name their index; counts every fetch."""

    def __init__(self, n):
        self.n = n
        self.fetched = 0
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.lock:
            self.fetched += 1
        return {"x": np.full((2,), i, np.int64), "name": f"i{i}"}


def _take(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("process_count", [1, 2])
def test_loader_batches_equal_jax_at_one_worker(root, process_count):
    # the flips and captions draw from the dataset's rng in fetch order, so
    # at one worker the batches are bit-equal
    for rank in range(process_count):
        batches = {}
        for name, coco, loader in (("port", pcoco, ploader),
                                   ("jax", jcoco, jloader)):
            ds = coco.LayoutDataset(**_coco_paths(root), image_size=SIZE)
            ld = loader.PrefetchLoader(ds, 2, seed=3, num_workers=1,
                                       process_index=rank,
                                       process_count=process_count)
            batches[name] = _take(ld, 2 * len(ld._epoch_batches(0)))
        assert len(batches["port"]) == len(batches["jax"]) >= 2
        for got, want in zip(batches["port"], batches["jax"]):
            assert_items_equal(got, want)


@pytest.mark.parametrize("workers", [4, 16])
def test_loader_batches_at_many_workers(workers):
    # 16 workers, threads switched often: no batch lost, doubled
    # or out of order; each epoch a permutation of its 28 items
    n, b, epochs = 30, 4, 3
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        port = _take(ploader.PrefetchLoader(Indexed(n), b, seed=1,
                                            num_workers=workers),
                     epochs * (n // b))
    finally:
        sys.setswitchinterval(interval)
    jax_ld = jloader.PrefetchLoader(Indexed(n), b, seed=1, num_workers=workers)
    want = [list(idxs) for e in range(epochs) for idxs in jax_ld._epoch_batches(e)]
    assert [list(batch["x"][:, 0]) for batch in port] == want
    per = n // b
    for e in range(epochs):
        epoch = [i for idxs in want[e * per:(e + 1) * per] for i in idxs]
        assert len(set(epoch)) == len(epoch) == per * b


def test_coco_batches_take_the_process_slice(root, monkeypatch):
    # coco_layout_batches reads the process's rank and the group's size
    # from an initialised torch.distributed, else (0, 1)
    import torch.distributed as dist

    coco_root = os.path.join(root, "COCO2014")
    loader = pcoco.coco_layout_batches(coco_root, 2, SIZE)
    assert (loader.process_index, loader.process_count) == (0, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    loader = pcoco.coco_layout_batches(coco_root, 2, SIZE)
    assert (loader.process_index, loader.process_count) == (1, 2)
    assert len(loader.dataset) == 7 and loader._epoch_batches(0) == \
        jloader.PrefetchLoader(loader.dataset, 2, process_index=1,
                               process_count=2)._epoch_batches(0)


def _wait_for(pred, timeout=5.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    return pred()


def test_loader_lookahead_is_bounded():
    n, b, workers, prefetch = 400, 4, 4, 2
    ds = Indexed(n)
    it = iter(ploader.PrefetchLoader(ds, b, num_workers=workers,
                                     prefetch=prefetch))
    taken = 0
    for step in (1, 4):
        for _ in range(step):
            next(it)
        taken += step
        # the window fills to the bound and stays there
        bound = (taken + prefetch + workers) * b
        assert _wait_for(lambda: ds.fetched == bound), (ds.fetched, bound)
        time.sleep(0.2)
        assert ds.fetched == bound
    it.close()
    # the JAX loader submits the whole epoch at once
    jds = Indexed(n)
    jit = iter(jloader.PrefetchLoader(jds, b, num_workers=workers,
                                      prefetch=prefetch))
    next(jit)
    assert _wait_for(lambda: jds.fetched == n)
    jit.close()


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "PrefetchLoader"]


class Failing(Indexed):
    def __getitem__(self, i):
        if i == 4:  # in the second batch
            raise OSError("item 4 unreadable")
        return super().__getitem__(i)


def test_loader_close_stops_its_thread_and_failures_reach_the_consumer():
    it = iter(ploader.PrefetchLoader(Indexed(40), 4, num_workers=2))
    next(it)
    assert len(_loader_threads()) == 1
    it.close()
    assert not _loader_threads()

    it = iter(ploader.PrefetchLoader(Failing(12), 3, shuffle=False,
                                     num_workers=2))
    next(it)
    with pytest.raises(OSError, match="item 4"):
        next(it)
    assert _wait_for(lambda: not _loader_threads())
    with pytest.raises(ValueError, match="no batch"):
        next(iter(ploader.PrefetchLoader(Indexed(3), 4)))


# ------------------------------------------------------------ without Pillow


def _every_dataset(coco, tsv, mod, r):
    """One dataset of each kind over the PNG-form root."""
    img_rel, cond_rel = MAP_NAMES["ADESemantic"]
    return [coco.LayoutDataset(**_coco_paths(r), image_size=SIZE),
            tsv.TSVGroundingDataset(os.path.join(r, TSV_NAMES["CC12MGrounding"]),
                                    image_size=SIZE),
            mod.ConditionMapDataset(os.path.join(r, img_rel),
                                    os.path.join(r, cond_rel), image_size=SIZE),
            mod.KeypointDataset(*_kp_args(r), image_size=SIZE)]


@pytest.fixture(scope="module")
def png_root(tmp_path_factory):
    """The catalog root with every image in utils/images.py's PNG form, and
    the JAX datasets' items on it, taken with Pillow."""
    r = write_root(str(tmp_path_factory.mktemp("png_root")), PNG_IMAGES)
    want = [ds[i] for ds in _every_dataset(jcoco, jtsv, jmod, r)
            for i in range(len(ds))]
    return r, want


def test_png_form_loads_without_pillow(png_root, root, monkeypatch):
    r, want = png_root
    for name in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)  # importing PIL raises
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    got = [ds[i] for ds in _every_dataset(pcoco, ptsv, pmod, r)
           for i in range(len(ds))]
    assert len(got) == len(want) > 10
    for g, w in zip(got, want):
        assert_items_equal(g, w)
    ds = pcoco.LayoutDataset(**_coco_paths(root), image_size=SIZE)
    jpg = os.path.join(_coco_paths(root)["image_dir"], "b.jpg")
    by_name = {im["file_name"]: im["id"] for im in ds.index.images.values()}
    with pytest.raises(RuntimeError, match=f"{jpg}: .* without Pillow"):
        ds[ds.ids.index(by_name["b.jpg"])]
