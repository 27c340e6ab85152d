"""The port's COCO-NSS1K runner (eval/nss1k.py) against the JAX package's,
on the CPU at small geometry.

* ``run_bench`` with GT layouts: the JAX pipeline (``random_models(
  small=True)``) and the port's on the same weights (checkpoint/from_jax.py)
  and the same noise (the port pipeline is handed JAX's ``_batch_noise``),
  PLMS-4, CFG 7.5, alpha (0.3, 0, 0.7), one batch of 2. Images pass
  tests/parity_setup.py's gates; CLIPScore within 1e-4. The scorer is a
  deterministic fixture (crc32-seeded text features, pooled-pixel image
  features, a shared bias so the cosines are positive and w*max(cos, 0) is
  not clamped to 0, as tests/test_nss1k_real_splits.py builds it), in each
  package's RewardModel, so ``_layout_ids`` and the COCO-80 snapping are
  each package's own.
* Planner mode from a canned layout cache through each package's planner:
  mIoU, DocSim and the parsed count equal to JAX's within 1e-6 (one
  planned label outside COCO-80); a caption the cache does not hold is
  dropped from the layout metrics.
* ``run_all_splits``' overall row: the n-weighted means of the split rows;
  a ragged tail chunk at its own batch.
* ``load_gt_images`` with Pillow unimportable reads utils/images.py PNGs,
  resizes one of another size bit-equal to Pillow's bicubic filter, and
  raises on a JPEG; with Pillow it equals JAX's on the same files.
* ``main`` with ``--small --device cpu`` prints one JSON line with the JAX
  runner's keys (``--data_path`` with the planner, and FID from a random
  Inception ``.pth``); a ``--sharded`` batch that does not divide over
  the ranks is refused before any model is built; ``--fast`` expands as JAX's ``resolve_fast_preset`` does.
"""
import argparse
import builtins
import json
import sys
import zlib

import numpy as np
import jax
import pytest
import torch

from layoutllm_t2i_tpu.eval import nss1k as jn
from layoutllm_t2i_tpu.pipeline import planner as jplanner
from layoutllm_t2i_tpu.pipeline.inference import InferencePipeline as JaxPipeline
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models
from layoutllm_t2i_tpu.pipeline.reward import RewardModel as JaxReward

from parity_setup import PSNR_GATE_DB, SSIM_GATE, psnr, ssim

from layoutllm_t2i_torch.checkpoint.from_jax import load_from_jax
from layoutllm_t2i_torch.eval import fid as pfid
from layoutllm_t2i_torch.eval import nss1k as pn
from layoutllm_t2i_torch.pipeline import planner as pplanner
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.pipeline.loaders import random_models
from layoutllm_t2i_torch.pipeline.reward import COCO80_LABELS
from layoutllm_t2i_torch.pipeline.reward import RewardModel as PortReward
from layoutllm_t2i_torch.utils.images import png_bytes
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SAMPLE = dict(steps=4, sampler="plms", guidance_scale=7.5,
              alpha_type=(0.3, 0.0, 0.7))
CLIP_TOL = 1e-4
LAYOUT_TOL = 1e-6
EXAMPLES = [
    {"img_id": 1, "name": "1.png", "width": 640, "height": 480,
     "bbox": [[0.3, 0.6, 0.4, 0.5], [0.7, 0.7, 0.3, 0.3]],
     "label": ["dog", "frisbee"], "captions": "a dog chasing a frisbee on the grass"},
    {"img_id": 2, "name": "2.png", "width": 640, "height": 480,
     "bbox": [[0.5, 0.4, 0.5, 0.4], [0.5, 0.8, 0.8, 0.3]],
     "label": ["cat", "couch"], "captions": "a cat sitting on top of a couch"},
    {"img_id": 3, "name": "3.png", "width": 640, "height": 480,
     "bbox": [[0.5, 0.5, 0.6, 0.6]], "label": ["person"],
     "captions": "a person holding an umbrella"},
]
# the planner's canned LLM outputs: the second caption's labels are open
# vocabulary ("kitten" snaps to a COCO-80 class); the third is not cached
LAYOUT_CACHE = {
    EXAMPLES[0]["captions"]: [["dog", [0.1, 0.35, 0.4, 0.5]],
                              ["frisbee", [0.55, 0.55, 0.3, 0.3]]],
    EXAMPLES[1]["captions"]: [["kitten", [0.25, 0.2, 0.5, 0.4]],
                              ["couch", [0.1, 0.65, 0.8, 0.3]]],
}
CANDIDATES = [
    {"img_id": 10 + i, "name": f"c{i}.png", "width": 640, "height": 480,
     "bbox": [[0.5, 0.5, 0.2, 0.2]], "label": [lab], "captions": f"a {lab} on a table"}
    for i, lab in enumerate(["cup", "bowl", "vase"])]
_DIM = 64


def _text_feat(texts):
    out = np.zeros((len(texts), _DIM), np.float32)
    for i, t in enumerate(texts):
        out[i] = np.random.default_rng(zlib.crc32(str(t).encode())).standard_normal(_DIM)
    out[:, 0] += 4.0  # shared direction -> positive caption-image cosines
    return out


def _image_feat(images):
    images = np.asarray(images, np.float32)
    b, h, w, c = images.shape
    pooled = images.reshape(b, 4, h // 4, 4, w // 4, c).mean(axis=(2, 4))
    flat = pooled.reshape(b, -1)
    proj = np.random.default_rng(7).standard_normal((flat.shape[1], _DIM))
    out = (flat @ proj).astype(np.float32)
    out /= np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-6)
    out[:, 0] += 4.0
    return out


def _fixture_reward(cls, to_array):
    """``cls``'s label mapping and layout ids over the fixture features (no
    towers are built); ``to_array`` gives features as that package returns
    them."""
    r = object.__new__(cls)
    r.text_features = lambda texts: to_array(_text_feat(texts))
    r.image_features = lambda imgs: to_array(_image_feat(imgs))
    r.label2index = {l: i for i, l in enumerate(COCO80_LABELS)}
    emb = _text_feat(COCO80_LABELS)
    r.labels_emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    r._label_cache = {}
    return r


@pytest.fixture(scope="module")
def pipelines():
    jm = jax_random_models(seed=0, small=True)
    pm = random_models(small=True, device="cpu", seed=1)
    for name in ("unet_params", "vae_params", "clip_params"):
        load_from_jax(getattr(pm, name), getattr(jm, name))
    jp, pp = JaxPipeline(jm, **SAMPLE), InferencePipeline(pm, **SAMPLE)
    # the port pipeline draws JAX's noise for a seed
    pp._batch_noise = lambda b, seed, seeds=None: (
        torch.from_numpy(np.asarray(jp._batch_noise(b, seed, None)[0])), None)
    return jp, pp


@pytest.fixture(scope="module")
def rewards():
    return (_fixture_reward(JaxReward, jax.numpy.asarray),
            _fixture_reward(PortReward, torch.from_numpy))


def test_run_bench_gt_matches_jax(pipelines, rewards):
    jp, pp = pipelines
    jr, pr = rewards
    want = jn.run_bench(jp, jr, EXAMPLES[:2], batch_size=2, seed=5,
                        collect_images=True)
    got = pn.run_bench(pp, pr, EXAMPLES[:2], batch_size=2, seed=5,
                       collect_images=True)
    assert set(got) == set(want) and got["n"] == want["n"] == 2
    assert got["images"].shape == want["images"].shape == (2, 16, 16, 3)
    for a, b in zip(got["images"], want["images"]):
        assert psnr(a, b) >= PSNR_GATE_DB and ssim(a, b) >= SSIM_GATE
    assert abs(got["clip_score_mean"] - want["clip_score_mean"]) <= CLIP_TOL
    assert got["clip_score_mean"] > 0.1  # the fixture's cosines are not clamped
    assert got["sec_per_image"] > 0


def _planner(planner_mod, cache_path):
    """Each package's planner over the canned cache, shots from fixed
    scores."""
    llm = planner_mod.CachedLayoutLLM(cache_path)

    def planner_fn(captions):
        scores = np.tile(np.arange(len(CANDIDATES), dtype=np.float32),
                         (len(captions), 1))
        planned = planner_mod.plan_layouts(llm, scores, CANDIDATES, captions,
                                           shot_number=2)
        return [(cats, boxes) for cats, boxes, _out, _ids in planned]

    return planner_fn


def test_run_bench_planner_metrics_match_jax(pipelines, rewards, tmp_path):
    jp, pp = pipelines
    jr, pr = rewards
    cache = tmp_path / "layouts.json"
    cache.write_text(json.dumps(LAYOUT_CACHE))
    want = jn.run_bench(jp, jr, EXAMPLES[:2], batch_size=2,
                        planner_fn=_planner(jplanner, str(cache)))
    got = pn.run_bench(pp, pr, EXAMPLES[:2], batch_size=2,
                       planner_fn=_planner(pplanner, str(cache)))
    assert got["layout_parsed"] == want["layout_parsed"] == 2
    for key in ("layout_miou", "layout_docsim"):
        assert abs(got[key] - want[key]) <= LAYOUT_TOL, key
    assert 0 < got["layout_miou"] < 1 and 0 < got["layout_docsim"] < 1
    assert pr._label_cache == jr._label_cache and "kitten" in pr._label_cache
    assert abs(got["clip_score_mean"] - want["clip_score_mean"]) <= CLIP_TOL
    # the third caption is not in the cache: generated on an empty layout,
    # scored, and left out of the layout metrics
    more = pn.run_bench(pp, pr, EXAMPLES, batch_size=2,
                        planner_fn=_planner(pplanner, str(cache)))
    assert more["n"] == 3 and more["layout_parsed"] == 2
    for key in ("layout_miou", "layout_docsim"):
        assert abs(more[key] - got[key]) <= LAYOUT_TOL, key


class _Stub:
    def image_features(self, imgs):
        return torch.from_numpy(_image_feat(imgs))

    def text_features(self, texts):
        return torch.from_numpy(_text_feat(texts))


def test_run_all_splits_overall_row(pipelines, tmp_path):
    _, pp = pipelines
    sizes = dict(zip(pn.SPLIT_FILES, (1, 2, 3, 1, 1)))
    for name, fname in pn.SPLIT_FILES.items():
        (tmp_path / fname).write_text(json.dumps(EXAMPLES[:sizes[name]]))
    out = pn.run_all_splits(pp, _Stub(), str(tmp_path), batch_size=2)
    assert set(out) == set(pn.SPLIT_FILES) | {"overall"}
    assert {k: out[k]["n"] for k in pn.SPLIT_FILES} == sizes
    total = sum(sizes.values())
    assert out["overall"]["n"] == total
    for key in ("clip_score_mean", "sec_per_image"):
        want = sum(out[k][key] * out[k]["n"] for k in pn.SPLIT_FILES) / total
        assert abs(out["overall"][key] - want) <= 1e-12
    assert set(out["overall"]) == {"n", "clip_score_mean", "sec_per_image"}


def _write_pngs(img_dir, examples, size, seed=0):
    rng = np.random.default_rng(seed)
    img_dir.mkdir(exist_ok=True)
    for ex in examples:
        (img_dir / ex["name"]).write_bytes(png_bytes(rng.uniform(size=(size, size, 3))))


def test_load_gt_images_without_pillow(tmp_path, monkeypatch):
    _write_pngs(tmp_path, EXAMPLES[:2], 16)
    with_pil = pn.load_gt_images(EXAMPLES[:2], str(tmp_path), size=16)
    want = jn.load_gt_images(EXAMPLES[:2], str(tmp_path), size=16)
    np.testing.assert_array_equal(with_pil, want)
    # a PNG of another size than the generation's, resized both ways
    other = tmp_path / "other"
    other.mkdir()
    (other / "w.png").write_bytes(png_bytes(
        np.random.default_rng(3).uniform(size=(23, 37, 3))))
    want_resized = jn.load_gt_images([{"name": "w.png"}], str(other), size=16)

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("Pillow blocked")
        return real_import(name, *args, **kw)

    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = pn.load_gt_images(EXAMPLES[:2], str(tmp_path), size=16)
    assert got.dtype == np.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(got, want)
    got = pn.load_gt_images([{"name": "w.png"}], str(other), size=16)
    assert got.shape == (1, 16, 16, 3)
    np.testing.assert_array_equal(got, want_resized)
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0 not read")
    with pytest.raises(RuntimeError, match="x.jpg: .* without Pillow"):
        pn.load_gt_images([{"name": "x.jpg"}], str(tmp_path), size=16)


def _main_json(argv, capsys):
    out = pn.main(argv)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    assert json.loads(lines[0]) == out
    return out


def test_main_small_cpu_prints_one_json_line(tmp_path, capsys, monkeypatch):
    """--data_path with the offline planner and FID from an Inception .pth
    (--data_dir goes through run_all_splits, tested above)."""
    base = ["--small", "--device", "cpu", "--steps", "2", "--batch_size", "2"]
    split = tmp_path / "split.json"
    split.write_text(json.dumps(EXAMPLES[:2]))
    cand_dir = tmp_path / "data"
    cand_dir.mkdir()
    for fname in ("train2014_train_1.json", "train2014_candidate_3.json"):
        (cand_dir / fname).write_text(json.dumps(
            {"id": [c["img_id"] for c in CANDIDATES], "data": CANDIDATES}))
    cache = tmp_path / "layouts.json"
    cache.write_text(json.dumps(LAYOUT_CACHE))
    _write_pngs(tmp_path / "imgs", EXAMPLES[:2], 16)
    torch.save(pfid.random_inception("cpu").state_dict(), tmp_path / "inc.pth")
    # sqrtm of a 2048 x 2048 product takes tens of seconds on one core: the
    # distance here is the real one over the first 16 feature dims, after
    # checking that the full 2048-d statistics arrived
    frechet = pfid.frechet_distance
    seen = []

    def frechet_16(mu1, s1, mu2, s2):
        seen.append((mu1.shape, s1.shape, mu2.shape, s2.shape))
        return frechet(mu1[:16], s1[:16, :16], mu2[:16], s2[:16, :16])

    monkeypatch.setattr(pfid, "frechet_distance", frechet_16)
    out = _main_json(["--data_path", str(split), "--layout", "planner",
                      "--layout_cache", str(cache), "--cand_data_dir",
                      str(cand_dir), "--cand_number", "3", "--fid",
                      "--img_dir", str(tmp_path / "imgs"), "--inception_ckpt",
                      str(tmp_path / "inc.pth")] + base, capsys)
    # JAX's run_bench keys in planner mode, plus FID's
    assert set(out) == {"n", "clip_score_mean", "sec_per_image", "layout_miou",
                        "layout_docsim", "layout_parsed", "fid"}
    assert out["n"] == 2 and out["layout_parsed"] == 2 and np.isfinite(out["fid"])
    assert seen == [((2048,), (2048, 2048)) * 2]


def test_sharded_is_refused_before_any_model(tmp_path, monkeypatch):
    from layoutllm_t2i_torch.pipeline import loaders

    def built(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(loaders, "random_models", built)
    monkeypatch.setattr(loaders, "load_models_from_gligen_ckpt", built)
    # --sharded runs (tests/test_torch_parallel_serve.py); a batch that does
    # not divide over the ranks is refused before any model is built
    from layoutllm_t2i_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "make_mesh", lambda **_: pmesh.Mesh(
        0, 3, torch.device("cpu"), "gloo"))
    with pytest.raises(ValueError, match="must divide over 3 devices"):
        pn.main(["--data_path", str(tmp_path / "none.json"), "--small",
                 "--device", "cpu", "--sharded", "--batch_size", "4"])


@pytest.mark.parametrize("kw", [{}, {"steps": 30}, {"sampler": "ddim"},
                                {"cfg_interval": "0.1,0.5"},
                                {"cache_encoder": 3, "steps": 20}])
def test_fast_preset_resolution_matches_jax(kw):
    def ns():
        base = dict(sampler="plms", steps=50, cfg_interval=None,
                    cache_encoder=0, int8=False)
        base.update(kw)
        return argparse.Namespace(**base)

    assert vars(pn.resolve_fast_preset(ns())) == vars(jn.resolve_fast_preset(ns()))
