"""The generation entry points of the port (cli/txt2img.py,
cli/gligen_inference.py, cli/demo.py) and what they stand on
(pipeline/planner.py, models/policy.py, models/clip_text.py
clip_text_features, utils/boxes.py, utils/images.py) against the JAX
package, on the CPU at the small geometry.

The CLIs draw their noise from a torch.Generator and the JAX ones from
jax.random, so their images are not compared; image parity is held at the
pipeline (tests/test_torch_pipeline.py, test_torch_fast*.py). Held here:
the flags -> pipeline settings, the planned layout and the shots the
planner picks (policy-scored, on pooled or projected CLIP features), the
relation texts and conditioning the CLIs build, the boxes drawn (Pillow's
pixels outside the labels) and the files written (PNG where the JAX CLIs
write JPEG through Pillow). Fixtures (a candidate JSON, a layout cache, a
policy .pt, a tiny CLIP .pth, a COCO-2014-form directory) are written by
the tests. Also here: cli/train_diffusion.py trains from ``--coco_root``.
"""
import base64
import http.client
import inspect
import json
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from layoutllm_t2i_tpu.cli import demo as jdemo
from layoutllm_t2i_tpu.cli import gligen_inference as jgligen
from layoutllm_t2i_tpu.cli import txt2img as jtxt2img
from layoutllm_t2i_tpu.models import clip_text as jclip
from layoutllm_t2i_tpu.models import initializers as jinit
from layoutllm_t2i_tpu.models import policy as jpolicy
from layoutllm_t2i_tpu.models.clip_tokenizer import HashTokenizer as JHashTokenizer
from layoutllm_t2i_tpu.pipeline import inference as jinference
from layoutllm_t2i_tpu.pipeline import loaders as jloaders
from layoutllm_t2i_tpu.pipeline import planner as jplanner
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models
from layoutllm_t2i_tpu.utils import boxes as jboxes
from layoutllm_t2i_tpu.utils import images as jimages

from layoutllm_t2i_torch.checkpoint.convert import load_clip_text_model
from layoutllm_t2i_torch.checkpoint.from_jax import (
    aesthetic_params_from_jax, gligen_models_from_jax, param_tree_from_jax,
    policy_params_from_jax, state_dict_from_jax)
from layoutllm_t2i_torch.cli import demo as pdemo
from layoutllm_t2i_torch.cli import train_diffusion as ptrain
from layoutllm_t2i_torch.cli import gligen_inference as pgligen
from layoutllm_t2i_torch.cli import txt2img as ptxt2img
from layoutllm_t2i_torch.models import clip_text as pclip
from layoutllm_t2i_torch.models import policy as ppolicy
from layoutllm_t2i_torch.models.clip_tokenizer import default_tokenizer
from layoutllm_t2i_torch.pipeline import inference as pinference
from layoutllm_t2i_torch.pipeline import loaders as ploaders
from layoutllm_t2i_torch.pipeline import planner as pplanner
from layoutllm_t2i_torch.utils import boxes as pboxes
from layoutllm_t2i_torch.utils import images as pimages
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(autouse=True)
def no_compile_cache(monkeypatch):
    # the JAX CLIs enable XLA's persistent cache under /tmp; keep it off
    monkeypatch.setenv("LLT2I_COMPILE_CACHE", "")


# ---------------------------------------------------------------------------
# models/policy.py, clip_text_features


def test_policy_scores_match_jax():
    params = jpolicy.init_policy_params(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    emb_p = rng.standard_normal((2, 768)).astype(np.float32)
    emb_c = rng.standard_normal((7, 768)).astype(np.float32)
    want = np.asarray(jpolicy.policy_scores(params, emb_p, emb_c))
    pp = policy_params_from_jax(params)
    got = ppolicy.policy_scores(pp, torch.from_numpy(emb_p), torch.from_numpy(emb_c))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ppolicy.policy_apply(pp, torch.from_numpy(emb_c)).numpy(),
                               np.asarray(jpolicy.policy_apply(params, emb_c)),
                               rtol=1e-5, atol=1e-5)
    # strict: a leaf the port's tree lacks raises
    extra = {"linear": dict(params["linear"], scale=np.ones(128, np.float32))}
    with pytest.raises(RuntimeError, match="scale"):
        policy_params_from_jax(extra)


def test_aesthetic_matches_jax():
    params = jpolicy.init_aesthetic_params(jax.random.PRNGKey(4))
    x = np.random.default_rng(1).standard_normal((5, 768)).astype(np.float32)
    x[2] = 0.0   # a zero norm passes through
    jx = np.asarray(jpolicy.l2_normalize(x))
    px = ppolicy.l2_normalize(torch.from_numpy(x))
    np.testing.assert_allclose(px.numpy(), jx, rtol=1e-6, atol=1e-7)
    want = np.asarray(jpolicy.aesthetic_apply(params, jx))
    got = ppolicy.aesthetic_apply(aesthetic_params_from_jax(params), px)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


TINY_CLIP = dict(num_layers=2, hidden_size=64, num_heads=1,
                 intermediate_size=128)


def _tiny_clip():
    """(JAX config, JAX params with a 64 -> 768 text_projection)."""
    cfg = jclip.CLIPTextConfig(**TINY_CLIP)
    params = jclip.init_clip_text_params(jax.random.PRNGKey(5), cfg)
    params["text_projection"] = jinit.linear_p(jax.random.PRNGKey(6), 64, 768,
                                               bias=False)
    return cfg, params


def _write_clip_model_pth(path, params):
    """A full HF CLIPModel state_dict: the text tower under text_model.,
    text_projection.weight, and vision keys the loader must leave out."""
    sd = {}
    for name, t in state_dict_from_jax(params).items():
        sd[name if name.startswith("text_projection") else "text_model." + name] = t
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    sd["vision_model.embeddings.class_embedding"] = torch.zeros(32)
    sd["visual_projection.weight"] = torch.zeros(768, 32)
    sd["logit_scale"] = torch.tensor(2.6592)
    torch.save(sd, path)


def test_clip_text_features_match_jax(tmp_path):
    cfg, params = _tiny_clip()
    ids = JHashTokenizer()(["a dog chasing a ball", "a cat", ""])
    want = np.asarray(jclip.clip_text_features(params, cfg, ids))
    assert want.shape == (3, 768)
    bridged = param_tree_from_jax(params)
    pcfg = pclip.CLIPTextConfig(**TINY_CLIP)
    tid = torch.from_numpy(ids.astype(np.int64))
    got = pclip.clip_text_features(bridged, pcfg, tid)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    # through a CLIPModel .pth, strictly by name, the config from its shapes
    path = tmp_path / "clip.pth"
    _write_clip_model_pth(path, params)
    loaded, lcfg = load_clip_text_model(str(path), device="cpu")
    assert lcfg == pcfg
    got = pclip.clip_text_features(loaded, lcfg, tid)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)


def test_clip_model_loader_is_strict(tmp_path):
    _, params = _tiny_clip()
    path = tmp_path / "clip.pth"
    _write_clip_model_pth(path, params)
    sd = torch.load(path)
    sd["text_model.encoder.layers.0.mlp.extra"] = torch.zeros(3)
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="extra"):
        load_clip_text_model(str(path), device="cpu")


# ---------------------------------------------------------------------------
# pipeline/planner.py, a copy


PLANNER_NAMES = ("add_prefix", "format_example", "build_prompt",
                 "extract_prediction", "center2lefttop", "select_topk_shots",
                 "sample_shots", "LLMClient", "CachedLayoutLLM", "plan_layouts")


@pytest.mark.parametrize("name", PLANNER_NAMES)
def test_planner_is_a_copy(name):
    assert (inspect.getsource(getattr(pplanner, name))
            == inspect.getsource(getattr(jplanner, name)))


CANDIDATES = [
    {"captions": "a dog running on a beach", "label": ["dog"],
     "bbox": [[0.5, 0.6, 0.4, 0.5]]},
    {"captions": "a cat under a table", "label": ["cat", "dining table"],
     "bbox": [[0.4, 0.7, 0.3, 0.3], [0.5, 0.5, 0.8, 0.6]]},
    {"captions": "a boy throwing a ball", "label": ["boy", "ball"],
     "bbox": [[0.4, 0.5, 0.3, 0.8], [0.8, 0.3, 0.1, 0.1]]},
    {"captions": "two dogs playing with a frisbee",
     "label": ["dog", "dog", "frisbee"],
     "bbox": [[0.3, 0.6, 0.3, 0.4], [0.7, 0.6, 0.3, 0.4], [0.5, 0.2, 0.1, 0.1]]},
    {"captions": "a red car parked by a tree", "label": ["car", "tree"],
     "bbox": [[0.4, 0.7, 0.6, 0.4], [0.8, 0.4, 0.3, 0.8]]},
]
PROMPT = "a dog chasing a red ball on the grass"
CACHE = {PROMPT: [["dog", [0.1, 0.35, 0.45, 0.5]], ["red ball", [0.6, 0.65, 0.2, 0.2]]],
         "a cat on a table": "output:\ncat: [0.20, 0.20, 0.30, 0.30]\n"}


def test_planner_functions_agree(tmp_path):
    for shots, caption in (([], "a cat"), (CANDIDATES[:2], PROMPT),
                           (CANDIDATES, "a cat on a table")):
        assert (pplanner.build_prompt(shots, caption)
                == jplanner.build_prompt(shots, caption))
    for text in ("output:\ndog: [0.10, 0.20, 0.30, 0.40]\nfire hydrant: "
                 "[0.50, 0.60, 0.20, 0.10]\nbad: [1, 2]", "nothing", ""):
        assert pplanner.extract_prediction(text) == jplanner.extract_prediction(text)
    rng = np.random.default_rng(0)
    for _ in range(5):
        scores = rng.standard_normal(9)
        assert (pplanner.select_topk_shots(scores, 3)
                == jplanner.select_topk_shots(scores, 3))
        p = np.exp(scores) / np.exp(scores).sum()
        assert (pplanner.sample_shots(p, 3, np.random.default_rng(11))
                == jplanner.sample_shots(p, 3, np.random.default_rng(11)))
    path = tmp_path / "cache.json"
    path.write_text(json.dumps(CACHE))
    pl, jl = pplanner.CachedLayoutLLM(str(path)), jplanner.CachedLayoutLLM(str(path))
    for caption in (PROMPT, "a cat on a table", "missing"):
        prompt = pplanner.build_prompt(CANDIDATES[:2], caption)
        assert pl(prompt) == jl(prompt)
    assert pplanner.extract_prediction(pl(pplanner.build_prompt([], PROMPT))) == (
        ["dog", "red ball"], [[0.1, 0.35, 0.45, 0.5], [0.6, 0.65, 0.2, 0.2]])
    scores = rng.standard_normal((2, len(CANDIDATES)))
    assert (pplanner.plan_layouts(pl, scores, CANDIDATES, [PROMPT, "a cat on a table"])
            == jplanner.plan_layouts(jl, scores, CANDIDATES,
                                     [PROMPT, "a cat on a table"]))


# ---------------------------------------------------------------------------
# utils/boxes.py, utils/images.py


def _label_mask(h, w, boxes, phrases):
    """Where either package may draw a label: the port's cells and Pillow's
    default font's bounding box at the same place."""
    mask = np.zeros((h, w), dtype=bool)
    draw = ImageDraw.Draw(Image.new("RGB", (w, h)))
    for (x0, y0, _, _), phrase in zip(boxes, phrases):
        x, y = x0 * w, y0 * h - pboxes.LABEL_OFFSET
        for l, t, r, b in (draw.textbbox((x, y), phrase),
                           pboxes.label_rect(int(np.floor(x)), int(np.floor(y)),
                                             phrase)):
            l, t = max(int(np.floor(l)), 0), max(int(np.floor(t)), 0)
            mask[t:max(int(np.ceil(b)), 0), l:max(int(np.ceil(r)), 0)] = True
    return mask


def _random_layout(rng, n):
    boxes = []
    for _ in range(n):
        x0, x1 = np.sort(rng.uniform(0, 1, 2))
        y0, y1 = np.sort(rng.uniform(0, 1, 2))
        if rng.uniform() < 0.3:          # thin boxes, narrower than 2 widths
            x1 = min(x0 + rng.uniform(0, 0.08), 1.0)
        if rng.uniform() < 0.2:
            x1, y1 = 1.0, 1.0
        boxes.append([float(x0), float(y0), float(x1), float(y1)])
    return boxes


@pytest.mark.parametrize("seed", range(4))
def test_draw_boxes_matches_pillow(seed):
    rng = np.random.default_rng(seed)
    h, w = (96, 128) if seed % 2 else (64, 64)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    boxes = _random_layout(rng, 4)
    phrases = ["a dog", "red ball", "x", "fire hydrant"]
    want = np.asarray(jboxes.draw_boxes_ltrb(img, boxes, phrases))
    got = pboxes.draw_boxes_ltrb(img, boxes, phrases)
    assert got.dtype == np.uint8 and got.shape == img.shape
    outside = ~_label_mask(h, w, boxes, phrases)
    np.testing.assert_array_equal(got[outside], want[outside])
    # without labels every pixel is Pillow's
    blank = [""] * len(boxes)
    np.testing.assert_array_equal(pboxes.draw_boxes_ltrb(img, boxes, blank),
                                  np.asarray(jboxes.draw_boxes_ltrb(img, boxes, blank)))
    # the labels' red pixels stay inside their cells
    red = (got != img).any(-1) & (got == pboxes.LABEL_COLOR).all(-1)
    assert not (red & outside).any()


def test_labels_use_the_font():
    img = np.zeros((40, 80, 3), np.uint8)
    pboxes.draw_text(img, 2, 3, "Ab1?", pboxes.LABEL_COLOR)
    red = (img == pboxes.LABEL_COLOR).all(-1)
    assert red.any() and not red[:3].any() and not red[:, :2].any()
    assert not red[3 + pboxes.GLYPH_H:].any()
    # clipped: a label above the image or past its edge draws what fits
    pboxes.draw_text(img, 70, -5, "wide label", pboxes.LABEL_COLOR)
    # every printable character has a glyph, outside ones draw '?'
    assert all(pboxes._glyph(chr(c)).shape == (7, 5) for c in range(0x20, 0x7F))
    np.testing.assert_array_equal(pboxes._glyph("é"), pboxes._glyph("?"))


@pytest.mark.parametrize("n,ncols,pad", [(1, 4, 2), (5, 4, 2), (8, 3, 0), (6, 6, 5)])
def test_make_grid_matches_jax(n, ncols, pad):
    imgs = np.random.default_rng(n).uniform(-0.2, 1.2, (n, 6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(pimages.make_grid(imgs, ncols, pad),
                                  jimages.make_grid(imgs, ncols, pad))


def test_save_image_grid_writes_what_jax_writes(tmp_path):
    imgs = np.random.default_rng(2).uniform(0, 1, (5, 8, 7, 3)).astype(np.float32)
    caps = ["one", "two", "three", "four", "five"]
    pimages.save_image_grid(imgs, str(tmp_path / "p.png"), caps, ncols=2)
    jimages.save_image_grid(imgs, str(tmp_path / "j.png"), caps, ncols=2)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()


def test_png_writer_round_trips():
    arr = np.random.default_rng(3).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    import io

    got = np.asarray(Image.open(io.BytesIO(pimages.png_bytes_uint8(arr))))
    np.testing.assert_array_equal(got, arr)
    f = arr.astype(np.float32) / 255.0
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(pimages.png_bytes(f)))),
        (np.clip(f, 0, 1) * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        pimages.png_bytes_uint8(f)
    with pytest.raises(ValueError, match="RGB"):
        pimages.png_bytes(f[..., :1])


# ---------------------------------------------------------------------------
# flags -> pipeline settings


class _Built(Exception):
    pass


def _recorders(monkeypatch, module, loaders_module, inference_module):
    """Patch ``module``'s model builders and pipeline class with recorders;
    the pipeline raises _Built once it has recorded its settings."""
    rec = {}

    def random_models(**kw):
        rec["random_models"] = kw
        return SimpleNamespace(unet_cfg=None, tag="models")

    def quantize(models):
        rec["int8"] = True
        return models

    def pipeline(models, **kw):
        rec["models"] = models
        rec["pipe"] = kw
        raise _Built

    for mod in {module, loaders_module}:
        if hasattr(mod, "random_models"):
            monkeypatch.setattr(mod, "random_models", random_models)
        if hasattr(mod, "quantize_unet_int8"):
            monkeypatch.setattr(mod, "quantize_unet_int8", quantize)
    for mod in {module, inference_module}:
        if hasattr(mod, "InferencePipeline"):
            monkeypatch.setattr(mod, "InferencePipeline", pipeline)
    return rec


def _settings(rec):
    pipe = dict(rec["pipe"])
    if pipe.get("cfg_interval") is not None:
        pipe["cfg_interval"] = tuple(pipe["cfg_interval"])
    if pipe.get("alpha_type") is not None:
        pipe["alpha_type"] = tuple(pipe["alpha_type"])
    return pipe, rec.get("int8", False), rec["random_models"].get("small")


@pytest.mark.parametrize("argv", [
    [], ["--no_plms"], ["--sampler", "dpm", "--sample_steps", "20"],
    ["--no_plms", "--sample_steps", "30"], ["--guidance_scale", "5"],
    ["--cache_encoder", "2", "--cfg_interval", "0.1,0.85"], ["--int8"],
    ["--small"]])
def test_txt2img_settings_match_jax(monkeypatch, argv):
    argv = argv + ["--prompt", "a dog"]
    jrec = _recorders(monkeypatch, jtxt2img, jloaders, jinference)
    monkeypatch.setattr(jtxt2img, "_PIPE", None)
    with pytest.raises(_Built):
        jtxt2img._get_pipe(jtxt2img.parse_args(argv))
    prec = _recorders(monkeypatch, ptxt2img, ploaders, pinference)
    with pytest.raises(_Built):
        ptxt2img._get_pipe(ptxt2img.parse_args(argv + ["--device", "cpu"]))
    assert _settings(prec) == _settings(jrec)
    assert prec["random_models"]["device"] == "cpu"


@pytest.mark.parametrize("argv", [
    [], ["--no_plms"], ["--small"], ["--small", "--no_plms"],
    ["--alpha", "0.5", "0.1", "0.4"], ["--guidance_scale", "3.5"],
    ["--cache_encoder", "3", "--cfg_interval", "0,0.5"], ["--int8"],
    ["--no_relation"]])
def test_gligen_inference_settings_match_jax(monkeypatch, argv):
    from layoutllm_t2i_tpu.models.unet import UNetConfig as JUNetConfig
    from layoutllm_t2i_torch.models.unet import UNetConfig

    argv = argv + ["--prompt", "a dog", "--layout", "dog:[0.1,0.2,0.3,0.4]"]
    results = []
    for cli, loaders, inference, cfg in (
            (jgligen, jloaders, jinference, JUNetConfig()),
            (pgligen, ploaders, pinference, UNetConfig())):
        rec = _recorders(monkeypatch, cli, loaders, inference)
        real = rec  # the builder returns models with a real config

        def random_models(_rec=real, _cfg=cfg, **kw):
            _rec["random_models"] = kw
            return SimpleNamespace(unet_cfg=_cfg)

        monkeypatch.setattr(cli, "random_models", random_models)
        extra = ["--device", "cpu"] if cli is pgligen else []
        with pytest.raises(_Built):
            cli.main(argv + extra)
        results.append((_settings(rec),
                        rec["models"].unet_cfg.use_relation_attention))
    assert results[0] == results[1]


@pytest.mark.parametrize("argv", [[], ["--steps", "20"], ["--small"],
                                  ["--small", "--steps", "4"]])
def test_demo_settings_match_jax(monkeypatch, argv):
    jrec = _recorders(monkeypatch, jdemo, jloaders, jinference)
    with pytest.raises(_Built):
        jdemo.main(argv)
    prec = _recorders(monkeypatch, pdemo, ploaders, pinference)
    with pytest.raises(_Built):
        pdemo.build_pipeline(pdemo.parse_args(argv + ["--device", "cpu"]))
    assert _settings(prec) == _settings(jrec)
    a = pdemo.parse_args([])
    assert (a.host, a.port, a.device) == ("0.0.0.0", 7860, None)


# ---------------------------------------------------------------------------
# the planner through the CLI, on written fixtures


@pytest.fixture(scope="module")
def bridged():
    """(JAX small bundle, port bundle on the CPU with the same weights)."""
    jm = jax_random_models(seed=0, small=True)
    pm = gligen_models_from_jax(vars(jm), default_tokenizer(), device="cpu")
    return jm, pm


@pytest.fixture
def fixtures(tmp_path):
    cand = tmp_path / "cand.json"
    cand.write_text(json.dumps({"id": list(range(len(CANDIDATES))),
                                "data": CANDIDATES}))
    cache = tmp_path / "cache.json"
    cache.write_text(json.dumps(CACHE))
    lin = torch.nn.Linear(768, 128)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(128, 768, generator=torch.Generator()
                                     .manual_seed(9)) * 0.05)
    policy = tmp_path / "policy.pt"
    torch.save(lin.state_dict(), policy)
    _, clip_params = _tiny_clip()
    clip = tmp_path / "clip.pth"
    _write_clip_model_pth(clip, clip_params)
    return {"cand": str(cand), "cache": str(cache), "policy": str(policy),
            "clip": str(clip)}


def _recording_llm(monkeypatch, module, prompts):
    base = module.CachedLayoutLLM

    class Recording(base):
        def __call__(self, prompt):
            prompts.append(prompt)
            return super().__call__(prompt)

    monkeypatch.setattr(module, "CachedLayoutLLM", Recording)


@pytest.mark.parametrize("case", ["layout", "default_shots", "policy_pooled",
                                  "policy_clip_ckpt"])
def test_plan_layout_matches_jax(monkeypatch, bridged, fixtures, case):
    jm, pm = bridged
    argv = ["--prompt", PROMPT, "--small", "--shot_number", "2"]
    if case == "layout":
        argv += ["--layout", "dog:[0.1,0.2,0.3,0.4];red ball:[0.5,0.6,0.1,0.1]"]
    else:
        argv += ["--cand_path", fixtures["cand"], "--layout_cache", fixtures["cache"]]
    if case.startswith("policy"):
        argv += ["--policy_ckpt_path", fixtures["policy"]]
    if case == "policy_clip_ckpt":
        argv += ["--clip_ckpt", fixtures["clip"]]
        # the JAX CLI reads the CLIPModel at the full ViT-L config; the
        # fixture is the tiny one
        tiny = jclip.CLIPTextConfig(**TINY_CLIP)
        monkeypatch.setattr(jclip, "CLIPTextConfig", lambda: tiny)
    monkeypatch.setattr(jtxt2img, "_PIPE", None)
    monkeypatch.setattr(jtxt2img, "random_models", lambda **kw: jm)
    monkeypatch.setattr(ptxt2img, "random_models", lambda **kw: pm)
    jprompts, pprompts = [], []
    _recording_llm(monkeypatch, jtxt2img, jprompts)
    _recording_llm(monkeypatch, ptxt2img, pprompts)
    want = jtxt2img.plan_layout(jtxt2img.parse_args(argv))
    got = ptxt2img.plan_layout(ptxt2img.parse_args(argv + ["--device", "cpu"]))
    assert got == want
    # the same shots, in the same order, reached the LLM
    assert pprompts == jprompts
    if case != "layout":
        assert got == (["dog", "red ball"],
                       [[0.1, 0.35, 0.45, 0.5], [0.6, 0.65, 0.2, 0.2]])
        # two shots and the query
        assert len(pprompts) == 1 and pprompts[0].count("\ninput: ") == 3


def test_policy_from_a_pickled_jax_tree(tmp_path, bridged):
    import pickle

    params = jpolicy.init_policy_params(jax.random.PRNGKey(8))
    path = tmp_path / "policy.pkl"
    path.write_bytes(pickle.dumps(jax.tree_util.tree_map(np.asarray, params)))
    loaded = ptxt2img.load_policy(str(path), torch.device("cpu"))
    x = np.random.default_rng(4).standard_normal((3, 768)).astype(np.float32)
    np.testing.assert_allclose(
        ppolicy.policy_apply(loaded, torch.from_numpy(x)).numpy(),
        np.asarray(jpolicy.policy_apply(params, x)), rtol=1e-5, atol=1e-5)


def test_txt2img_builds_what_jax_builds(monkeypatch, bridged, tmp_path):
    """The generate calls of both CLIs: prompts, boxes (ltrb), phrases,
    relation texts, seeds; the files, PNG here and JPEG there."""
    jm, pm = bridged
    calls = {"jax": [], "port": []}

    def fake(key):
        def generate(self, prompts, layouts, relation_texts=None, seed=42, **kw):
            calls[key].append((list(prompts), [([list(map(float, b)) for b in bx],
                                                list(ph)) for bx, ph in layouts],
                               relation_texts, seed))
            return np.zeros((len(prompts), 16, 16, 3), np.float32)
        return generate

    monkeypatch.setattr(jinference.InferencePipeline, "generate", fake("jax"))
    monkeypatch.setattr(pinference.InferencePipeline, "generate", fake("port"))
    monkeypatch.setattr(jtxt2img, "_PIPE", None)
    monkeypatch.setattr(jtxt2img, "random_models", lambda **kw: jm)
    monkeypatch.setattr(ptxt2img, "random_models", lambda **kw: pm)
    argv = ["--prompt", "a cat sitting on a chair next to a lamp!", "--small",
            "--layout", "cat:[0.1,0.2,0.3,0.4];chair:[0.5,0.5,0.4,0.4]",
            "--num_per_prompt", "2", "--batch_size", "3", "--seed", "5"]
    jtxt2img.main(argv + ["--folder", str(tmp_path / "j")])
    paths = ptxt2img.main(argv + ["--folder", str(tmp_path / "p"), "--device", "cpu"])
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2
    assert [c[3] for c in calls["port"]] == [5, 6]
    jfiles = sorted(p.name for p in (tmp_path / "j").iterdir())
    pfiles = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert [f.replace(".jpg", ".png") for f in jfiles] == pfiles
    assert len(pfiles) == 6 and paths[0].endswith("next to a lamp_0.png")


def test_gligen_inference_builds_what_jax_builds(monkeypatch, bridged, tmp_path):
    """The conditioning both CLIs sample from (negative prompt included),
    on the same weights."""
    jm, pm = bridged
    conds = {}

    def fake(key, to_np, zeros):
        def sample_latents(self, cond, noise, *a):
            conds[key] = {k: to_np(v) for k, v in cond.items()}
            return zeros((noise.shape[0], 16, 16, 3))
        return sample_latents

    monkeypatch.setattr(jinference.InferencePipeline, "sample_latents",
                        fake("jax", np.asarray, np.zeros))
    monkeypatch.setattr(pinference.InferencePipeline, "sample_latents",
                        fake("port", lambda t: t.detach().numpy(), torch.zeros))
    monkeypatch.setattr(jgligen, "random_models", lambda **kw: jm)
    monkeypatch.setattr(pgligen, "random_models", lambda **kw: pm)
    argv = ["--prompt", "a dog chasing a ball", "--small", "--batch_size", "2",
            "--layout", "dog:[0.1,0.2,0.3,0.4];ball:[0.6,0.6,0.2,0.2]",
            "--negative_prompt", "blurry, low quality"]
    jgligen.main(argv + ["--folder", str(tmp_path / "j")])
    pgligen.main(argv + ["--folder", str(tmp_path / "p"), "--device", "cpu"])
    assert set(conds["port"]) == set(conds["jax"]) == {
        "context", "uc_context", "boxes", "masks", "phrase_embeddings", "relations"}
    for k in conds["jax"]:
        np.testing.assert_allclose(conds["port"][k], conds["jax"][k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    # the negative prompt's context, not the empty prompt's
    assert np.abs(conds["port"]["uc_context"] - conds["port"]["context"]).max() > 0
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == [
        "sample_0.png", "sample_1.png"]


# ---------------------------------------------------------------------------
# the CLIs run on the CPU


def _outlines_blue(png_path, spec):
    from layoutllm_t2i_torch.pipeline.inference import convert_xywh_to_ltrb

    px = np.asarray(Image.open(png_path))
    h, w = px.shape[:2]
    cats, boxes = pplanner.extract_prediction(spec)
    mask = np.zeros((h, w), dtype=bool)
    for x0, y0, x1, y1 in map(convert_xywh_to_ltrb, boxes):
        mask |= pboxes.outline_mask(h, w, (x0 * w, y0 * h, x1 * w, y1 * h))
    return px.shape, bool(mask.any() and (px[mask] == pboxes.BOX_COLOR).all())


def test_txt2img_writes_pngs(tmp_path, fixtures):
    spec = "dog:[0.1,0.2,0.5,0.6];ball:[0.6,0.6,0.2,0.2]"
    paths = ptxt2img.main(["--prompt", "a dog chasing a ball", "--small",
                           "--device", "cpu", "--layout", spec,
                           "--sample_steps", "3", "--num_per_prompt", "2",
                           "--folder", str(tmp_path / "a")])
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "a dog chasing a ball_0.png", "a dog chasing a ball_1.png"]
    for p in paths:
        assert _outlines_blue(p, spec) == ((16, 16, 3), True)
    # through the offline planner, the policy on the pipeline's features
    paths = ptxt2img.main(["--prompt", PROMPT, "--small", "--device", "cpu",
                           "--cand_path", fixtures["cand"],
                           "--layout_cache", fixtures["cache"],
                           "--policy_ckpt_path", fixtures["policy"],
                           "--sampler", "dpm", "--sample_steps", "3",
                           "--num_per_prompt", "1", "--folder", str(tmp_path / "b")])
    assert len(paths) == 1 and Image.open(paths[0]).size == (16, 16)


def test_gligen_inference_writes_pngs(tmp_path):
    spec = "dog:[0.2,0.2,0.5,0.5]"
    paths = pgligen.main(["--prompt", "a dog", "--layout", spec, "--small",
                          "--device", "cpu", "--batch_size", "2", "--no_relation",
                          "--negative_prompt", "blurry", "--folder", str(tmp_path)])
    assert [p.rsplit("/", 1)[1] for p in paths] == ["sample_0.png", "sample_1.png"]
    for p in paths:
        assert _outlines_blue(p, spec) == ((16, 16, 3), True)


@pytest.mark.parametrize("argv,message", [
    (["--modality", "canny"], "--map_path is required for canny"),
    (["--modality", "sem"], "--map_path is required for sem"),
    (["--modality", "text_image"], "--image_refs is required for text_image"),
    (["--modality", "text_image", "--image_refs", "a.png;b.png"],
     "--image_refs has 2 entries for 1 boxes ('-' skips a box)"),
    (["--modality", "keypoint"], "--keypoints is required for keypoint"),
    (["--modality", "keypoint", "--keypoints", "0.5;0.2"],
     "--keypoints: cannot parse '0.5'"),
    (["--inpaint_image", "{big}"],
     "inpaint image: want 16x16 (the generation size), got 32x32")])
def test_gligen_refusals_come_before_any_model(monkeypatch, tmp_path, argv, message):
    """Bad modality input is refused before any model is built, with the
    JAX CLI's own messages (cli/gligen_inference.py:166-185); an inpaint
    source of another size than the generation's (which the JAX CLI
    resizes with Pillow) is refused too."""
    def built(*a, **kw):
        raise AssertionError("a model was built")

    big = str(tmp_path / "big.png")
    pimages.save_png(np.zeros((32, 32, 3), np.uint8), big)
    argv = ["--prompt", "a dog", "--layout", "dog:[0.1,0.1,0.5,0.5]", "--small"] + [
        a.format(big=big) for a in argv]
    for cli in (pgligen, jgligen):
        monkeypatch.setattr(cli, "random_models", built)
        monkeypatch.setattr(cli, "load_models_from_gligen_ckpt", built)
    with pytest.raises(ValueError) as err:
        pgligen.main(argv + ["--device", "cpu"])
    assert str(err.value).startswith(message)
    if "--inpaint_image" not in argv:
        with pytest.raises((AssertionError, SystemExit)) as jerr:
            jgligen.main(argv)
        assert str(jerr.value).startswith(message.split(" — ")[0])


def test_demo_answers_on_the_cpu():
    srv = pdemo.build_server(pdemo.parse_args(
        ["--small", "--device", "cpu", "--host", "127.0.0.1", "--port", "0"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=120)

        def post(path, body):
            conn.request("POST", path, body=json.dumps(body))
            r = conn.getresponse()
            return r.status, json.loads(r.read())

        body = {"prompt": "a dog", "negative": "blurry", "seed": 3,
                "boxes": [{"label": "dog", "x": 0.1, "y": 0.2, "w": 0.5, "h": 0.6}]}
        status, out = post("/api/generate", body)
        assert status == 200 and set(out) == {"image", "layout", "seconds"}
        import io

        px = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image"]))))
        assert px.shape == (16, 16, 3)
        assert out["layout"] == [{"label": "dog", "box_ltrb": [0.1, 0.2, 0.6, 0.8]}]
        # another guidance and alpha: a sibling pipeline, cached
        status, out = post("/api/generate", {**body, "guidance": 3.0,
                                             "alpha": [1.0, 0.0, 0.0]})
        assert status == 200 and "image" in out
        # an uploaded image to inpaint: a PNG data URL at the generation size
        src = pimages.png_bytes_uint8(
            np.random.default_rng(1).integers(0, 256, (16, 16, 3), dtype=np.uint8))
        status, out = post("/api/generate", {
            **body, "inpaint": "data:image/png;base64," + base64.b64encode(src).decode()})
        assert status == 200 and set(out) == {"image", "layout", "seconds"}
        px = np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image"]))))
        assert px.shape == (16, 16, 3)
        # anything else gets the JSON error
        for bad in ("data:,AAAA", "data:image/png;base64,"
                    + base64.b64encode(pimages.png_bytes_uint8(
                        np.zeros((8, 8, 3), np.uint8))).decode()):
            status, out = post("/api/generate", {**body, "inpaint": bad})
            assert status == 200 and set(out) == {"error"}, out
        assert post("/api/other", body)[0] == 404
        conn.request("GET", "/")
        page = conn.getresponse().read().decode()
        assert "/api/generate" in page and "<canvas" in page
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(10)


def test_train_diffusion_from_coco_root(tmp_path):
    """``--coco_root`` trains from COCO-layout data: 4 captioned PNGs of
    assorted sizes (utils/images.py's form) and one without a caption, 2
    iterations at batch 2 with the tiny models; finite losses, a
    checkpoint."""
    rng = np.random.default_rng(0)
    root = tmp_path / "coco"
    (root / "train2014").mkdir(parents=True)
    (root / "annotations").mkdir()
    inst = {"images": [], "annotations": [],
            "categories": [{"id": 1, "name": "dog"}, {"id": 2, "name": "cat"}]}
    caps = {"annotations": []}
    for img_id, (w, h) in enumerate(((40, 30), (30, 40), (24, 24), (50, 20),
                                     (32, 32)), 1):
        name = f"{img_id}.png"
        pimages.save_png(rng.integers(0, 256, (h, w, 3), np.uint8),
                         str(root / "train2014" / name))
        inst["images"].append({"id": img_id, "file_name": name, "width": w,
                               "height": h})
        for k in (1, 2):
            box = [w * 0.1 * k, h * 0.2, w * 0.4, h * 0.5]
            inst["annotations"].append({
                "id": len(inst["annotations"]) + 1, "image_id": img_id,
                "bbox": box, "area": box[2] * box[3], "category_id": k})
        if img_id < 5:
            caps["annotations"].append({"image_id": img_id,
                                        "caption": "a dog next to a cat"})
    for kind, obj in (("instances", inst), ("captions", caps)):
        (root / "annotations" / f"{kind}_train2014.json").write_text(json.dumps(obj))
    ptrain.main(["--small", "--device", "cpu", "--coco_root", str(root),
                 "--batch_size", "2", "--total_iters", "2", "--warmup_steps", "0",
                 "--output_root", str(tmp_path / "out"), "--name", "coco",
                 "--sync_ckpt"])
    run = tmp_path / "out" / "coco" / "tag00"
    losses = [json.loads(line)["loss"]
              for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert losses and all(np.isfinite(losses))  # logged every 10th iteration
    assert (run / "checkpoint_00000002" / "state.pt").exists()
