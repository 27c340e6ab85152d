"""The RL reward of the port against the JAX package, on the CPU in f32.

* K3's f32 form: the port's LayerNorm (its plain version on a CPU tensor)
  against the JAX ``layer_norm_fused``, whose Pallas ``_ln_kernel`` runs in
  interpret mode, at the reward towers' row shapes (vision (8·257, 1024),
  its post-LN (8, 1024), text (8·77, 768)): 1e-5.
* The CLIP vision tower (models/clip_vision.py) on weights bridged from a
  JAX tree, at a tiny config whose every LayerNorm also reaches the Pallas
  kernel in the JAX tower (hidden 128, 56² images in 14² patches, batch 8:
  136 rows): 1e-4. Its preprocessing against ``jax.image.resize``'s
  antialiased bicubic up and down (512² -> 224²): 1e-5; PyTorch's bicubic
  without antialiasing is far off (pinned, a trap).
* ``RewardModel``: every component and the composite against the JAX
  ``RewardModel`` on bridged weights (1e-4), the COCO-80 label embeddings,
  ``nearest_coco_label`` equal, strict ``.pth`` loaders of a full CLIPModel
  and the aesthetic MLP.
* The host-side copies ``eval/metrics.py`` and ``eval/clip_score.py`` equal
  to the JAX package's on random layouts and features.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from layoutllm_t2i_tpu.eval import clip_score as jclip_score
from layoutllm_t2i_tpu.eval import metrics as jmetrics
from layoutllm_t2i_tpu.models import clip_text as jclip
from layoutllm_t2i_tpu.models import clip_vision as jvision
from layoutllm_t2i_tpu.models import initializers as jinit
from layoutllm_t2i_tpu.models import policy as jpolicy
from layoutllm_t2i_tpu.models.clip_tokenizer import HashTokenizer as JHash
from layoutllm_t2i_tpu.ops import nn as jnn
from layoutllm_t2i_tpu.ops.pallas import norms as jnorms
from layoutllm_t2i_tpu.pipeline import reward as jreward

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.checkpoint import convert
from layoutllm_t2i_torch.checkpoint.from_jax import (
    aesthetic_params_from_jax, clip_text_params_from_jax,
    clip_vision_params_from_jax, state_dict_from_jax)
from layoutllm_t2i_torch.eval import clip_score as pclip_score
from layoutllm_t2i_torch.eval import metrics as pmetrics
from layoutllm_t2i_torch.models import clip_text as pclip
from layoutllm_t2i_torch.models import clip_vision as pvision
from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer as PHash
from layoutllm_t2i_torch.models.policy import l2_normalize
from layoutllm_t2i_torch.pipeline import reward as preward
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _fuse_norms(mp, calls):
    """The JAX package's norms through its Pallas kernels on the CPU (in
    interpret mode, as on the TPU's code path); ``calls`` records the row
    shapes of each ``_ln_pallas`` call."""
    real = jnorms._ln_pallas

    def counted(x2, gamma, beta, eps, interpret):
        calls.append(tuple(x2.shape))
        assert interpret
        return real(x2, gamma, beta, eps, interpret)

    mp.setattr(jnn, "_fused_norms_enabled", lambda: True)
    mp.setattr(jnorms, "_ln_pallas", counted)


@pytest.fixture
def pallas_ln_calls(monkeypatch):
    calls = []
    _fuse_norms(monkeypatch, calls)
    return calls


# ---------------------------------------------------------------------------
# K3 in f32


@pytest.mark.parametrize("rows,c", [(2056, 1024), (8, 1024), (616, 768)])
def test_k3_f32_matches_the_pallas_kernel(pallas_ln_calls, rows, c):
    rng = np.random.default_rng(rows + c)
    x = (rng.standard_normal((rows, c)) * 2 + 0.5).astype(np.float32)
    w = (rng.standard_normal(c) * 0.5 + 1).astype(np.float32)
    b = (rng.standard_normal(c) * 0.5).astype(np.float32)
    want = np.asarray(jnorms.layer_norm_fused(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b), 1e-5))
    assert pallas_ln_calls == [(rows, c)]
    K.reset_launches()
    got = K.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), 1e-5)
    assert got.dtype == torch.float32 and K.layer_norm.launches == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the vision tower


TINY_VISION = dict(image_size=56, patch_size=14, hidden_size=128,
                   num_layers=2, num_heads=2, intermediate_size=256,
                   projection_dim=96)


def _vision(seed=0):
    jcfg = jvision.CLIPVisionConfig(**TINY_VISION)
    return (jcfg, jvision.init_clip_vision_params(jax.random.PRNGKey(seed), jcfg),
            pvision.CLIPVisionConfig(**TINY_VISION))


def test_vision_config_fields_match():
    assert ([f.name for f in dataclasses.fields(pvision.CLIPVisionConfig)]
            == [f.name for f in dataclasses.fields(jvision.CLIPVisionConfig)])
    assert pvision.CLIPVisionConfig() == pvision.CLIPVisionConfig(
        **dataclasses.asdict(jvision.CLIPVisionConfig()))


def test_vision_tower_matches_jax(pallas_ln_calls):
    jcfg, params, pcfg = _vision()
    pixels = np.random.default_rng(1).standard_normal((8, 56, 56, 3)).astype(np.float32)
    hidden, pooled = jvision.clip_vision_apply(params, jcfg, jnp.asarray(pixels))
    feats = jvision.clip_image_features(params, jcfg, jnp.asarray(pixels))
    # pre_layrnorm, 2 x layer_norm1/2 at 8 x 17 rows, post_layernorm at 8,
    # twice (apply, then features)
    assert sorted(set(pallas_ln_calls)) == [(8, 128), (136, 128)]
    assert len(pallas_ln_calls) == 12
    bridged = clip_vision_params_from_jax(params, pcfg, device="cpu")
    with torch.no_grad():
        ph, pp = pvision.clip_vision_apply(bridged, pcfg, torch.from_numpy(pixels))
        pf = pvision.clip_image_features(bridged, pcfg, torch.from_numpy(pixels))
    for got, want in ((ph, hidden), (pp, pooled), (pf, feats)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_patch_embedding_is_the_convolution():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 28, 42, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 3, 14, 14)).astype(np.float32))
    conv = F.conv2d(x.permute(0, 3, 1, 2), w, stride=14)     # (2, 16, 2, 3)
    want = conv.permute(0, 2, 3, 1).reshape(2, 6, 16)
    torch.testing.assert_close(pvision.patch_embed(w, x), want, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="patches"):
        pvision.patch_embed(w, x[:, :27])


@pytest.mark.parametrize("side,batch", [(512, 2), (40, 8)])
def test_preprocess_matches_jax_resize(side, batch):
    """The resized pixels to 1e-5, up (the tests' small images) and down
    (the reward's 512² rollouts); the normalized output to 1e-5 on the
    reward's 512² -> 224² path. Normalizing divides by std ~0.26, so the
    upscaled pixels' f32 rounding (2.7e-6 at 40² -> 224²) reads 1.0e-5
    there."""
    cfg = jvision.CLIPVisionConfig()
    imgs = np.random.default_rng(side).uniform(
        size=(batch, side, side, 3)).astype(np.float32)
    resized = np.asarray(jax.image.resize(jnp.asarray(imgs), (batch, 224, 224, 3),
                                          "bicubic"))
    want = np.asarray(jvision.preprocess_images(jnp.asarray(imgs), cfg))
    got = pvision.preprocess_images(torch.from_numpy(imgs),
                                    pvision.CLIPVisionConfig()).numpy()
    assert got.shape == (batch, 224, 224, 3)
    std, mean = np.asarray(pvision.CLIP_IMAGE_STD), np.asarray(pvision.CLIP_IMAGE_MEAN)
    np.testing.assert_allclose(got * std + mean, resized, rtol=0, atol=1e-5)
    if side == 512:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # without antialiasing PyTorch's bicubic is another filter when it
        # shrinks (the pixels differ by ~0.6)
        plain = F.interpolate(torch.from_numpy(imgs).permute(0, 3, 1, 2),
                              size=(224, 224), mode="bicubic",
                              align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(plain - resized).max() > 0.3


# ---------------------------------------------------------------------------
# RewardModel


TINY_TEXT = dict(num_layers=1, hidden_size=128, num_heads=2,
                 intermediate_size=256, vocab_size=512, max_length=16)
CAPTIONS = ["a dog on the grass", "a cat on a couch", "two people with kites",
            "a red car", "a bowl of fruit", "a man on a horse", "a clock tower",
            "a pizza on a table"]
# open-vocabulary predicted labels (mapped to COCO-80 through the towers)
PRED = [([[0.1, 0.1, 0.4, 0.4]], ["puppy"]),
        ([[0.2, 0.2, 0.6, 0.6], [0.0, 0.5, 1.0, 1.0]], ["cat", "sofa"]),
        ([[0.1, 0.2, 0.3, 0.9], [0.5, 0.1, 0.9, 0.4]], ["person", "kite"]),
        ([[0.2, 0.4, 0.8, 0.9]], ["automobile"]),
        ([[0.3, 0.3, 0.7, 0.7], [0.4, 0.4, 0.5, 0.5]], ["bowl", "apple"]),
        ([[0.3, 0.1, 0.6, 0.5], [0.2, 0.3, 0.8, 0.95]], ["man", "horse"]),
        ([[0.4, 0.0, 0.6, 0.9]], ["clock"]),
        ([[0.2, 0.5, 0.6, 0.8], [0.0, 0.6, 1.0, 1.0]], ["pizza", "weird table"])]
GT = [([[0.1, 0.1, 0.5, 0.4]], ["dog"]),
      ([[0.2, 0.25, 0.6, 0.6], [0.0, 0.5, 1.0, 1.0]], ["cat", "couch"]),
      ([[0.1, 0.2, 0.3, 0.8], [0.5, 0.1, 0.8, 0.4], [0.6, 0.6, 0.7, 0.9]],
       ["person", "kite", "person"]),
      ([[0.2, 0.4, 0.8, 0.9]], ["car"]),
      ([[0.3, 0.3, 0.7, 0.7]], ["bowl"]),
      ([[0.3, 0.1, 0.6, 0.5], [0.2, 0.3, 0.8, 0.95]], ["person", "horse"]),
      ([[0.4, 0.0, 0.6, 0.9]], ["clock"]),
      ([[0.2, 0.5, 0.6, 0.8], [0.0, 0.6, 1.0, 1.0]], ["pizza", "dining table"])]


def _jax_reward_params():
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(3), 4)
    text_cfg = jclip.CLIPTextConfig(**TINY_TEXT)
    text = jclip.init_clip_text_params(k1, text_cfg)
    text["text_projection"] = jinit.linear_p(k4, 128, 96, bias=False)
    vcfg, vision, _ = _vision(seed=7)
    return text_cfg, text, vcfg, vision, jpolicy.init_aesthetic_params(k3, 96)


@pytest.fixture(scope="module")
def rewards():
    """(JAX RewardModel, the port's on the same weights, on the CPU, the
    ``_ln_pallas`` row shapes the JAX one reached). The JAX towers' norms
    run the Pallas kernel while the module's tests run: every tower LN
    here has rows % 8 == 0 and C % 128 == 0, so the comparisons hold the
    port's towers, K3's f32 form on the card, to ``_ln_kernel``."""
    text_cfg, text, vcfg, vision, aes = _jax_reward_params()
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _fuse_norms(mp, calls)
        jr = jreward.RewardModel(text_cfg, text, vcfg, vision, aes,
                                 JHash(max_length=16, vocab_size=512))
        ptext_cfg = pclip.CLIPTextConfig(**TINY_TEXT)
        pvcfg = pvision.CLIPVisionConfig(**TINY_VISION)
        pr = preward.RewardModel(
            ptext_cfg, clip_text_params_from_jax(text, ptext_cfg), pvcfg,
            clip_vision_params_from_jax(vision, pvcfg),
            aesthetic_params_from_jax(aes),
            PHash(max_length=16, vocab_size=512), device="cpu")
        yield jr, pr, calls


def _images():
    rng = np.random.default_rng(11)
    return (rng.uniform(size=(8, 64, 64, 3)).astype(np.float32),
            rng.uniform(size=(8, 48, 48, 3)).astype(np.float32))


def _jax_components(jr, pred, gt):
    l2 = jpolicy.l2_normalize
    txt = l2(jr.text_features(CAPTIONS))
    fp = l2(jr.image_features(pred))
    fg = l2(jr.image_features(gt))
    pred_ids = jr._layout_ids(PRED, close_set=True)
    gt_ids = jr._layout_ids(GT, close_set=False)
    return {"clip": np.asarray(jnp.sum(txt * fp, -1) + jnp.sum(fg * fp, -1)),
            "aesthetic": np.asarray(jr._aesthetic(jr.aesthetic_params, l2(fp))),
            "max_iou": jmetrics.compute_maximum_iou(gt_ids, pred_ids),
            "docsim": jmetrics.compute_docsim(gt_ids, pred_ids)}


def test_reward_components_and_composite_match_jax(rewards):
    jr, pr, calls = rewards
    pred, gt = _images()
    want = _jax_components(jr, pred, gt)
    # the 80 labels' and the 8 captions' text rows (x 16 tokens), the
    # vision tower's 8 x 17 and its post-LN's 8
    assert {(1280, 128), (128, 128), (136, 128), (8, 128)} <= set(calls)
    got = pr.components(CAPTIONS, pred, gt, PRED, GT)
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == (8,)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    total = pr(CAPTIONS, pred, gt, PRED, GT)
    np.testing.assert_allclose(total, jr(CAPTIONS, pred, gt, PRED, GT),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        total, got["clip"] + 0.1 * got["aesthetic"] + 10 * got["max_iou"]
        + 10 * got["docsim"], rtol=1e-6)


def test_label_embeddings_and_nearest_labels_match(rewards):
    jr, pr, _ = rewards
    np.testing.assert_allclose(pr.labels_emb, jr.labels_emb, rtol=1e-4, atol=1e-5)
    for label in ("dog", "puppy", "sofa", "automobile", "weird table",
                  "teddy bear", "a thing nobody saw"):
        assert pr.nearest_coco_label(label) == jr.nearest_coco_label(label)
    assert pr._label_cache == {k: v for k, v in jr._label_cache.items()
                               if k in pr._label_cache}
    assert preward.COCO80_LABELS == jreward.COCO80_LABELS


def test_reward_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        preward.RewardModel(None, {}, None, {}, {}, None)


def _clip_model_sd(text, vision):
    """A full HF CLIPModel state_dict from JAX trees."""
    sd = {}
    for name, t in state_dict_from_jax(text).items():
        sd[name if name.startswith("text_projection") else "text_model." + name] = t
    sd.update(state_dict_from_jax(vision))
    sd["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    sd["vision_model.embeddings.position_ids"] = torch.arange(17)[None]
    sd["logit_scale"] = torch.tensor(2.6592)
    return sd


def test_clip_model_and_aesthetic_pth_load_strictly(tmp_path, rewards):
    _, pr, _ = rewards
    text_cfg, text, vcfg, vision, aes = _jax_reward_params()
    torch.save(_clip_model_sd(text, vision), tmp_path / "clip.pth")
    torch.save(state_dict_from_jax(aes), tmp_path / "aes.pth")
    tp, tcfg, vp, vcfg_p = convert.load_clip_model(str(tmp_path / "clip.pth"),
                                                   device="cpu")
    assert vcfg_p == pvision.CLIPVisionConfig(**TINY_VISION)
    assert (tcfg.hidden_size, tcfg.num_layers, tcfg.max_length) == (128, 1, 16)
    ap = convert.load_aesthetic(str(tmp_path / "aes.pth"), device="cpu")
    for module in (tp, vp, ap):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    loaded = preward.RewardModel(pclip.CLIPTextConfig(**TINY_TEXT), tp, vcfg_p,
                                 vp, ap, PHash(max_length=16, vocab_size=512),
                                 device="cpu")
    pred, gt = _images()
    np.testing.assert_array_equal(loaded(CAPTIONS, pred, gt, PRED, GT),
                                  pr(CAPTIONS, pred, gt, PRED, GT))
    sd = torch.load(tmp_path / "clip.pth")
    sd["vision_model.encoder.layers.0.mlp.extra"] = torch.zeros(3)
    torch.save(sd, tmp_path / "clip.pth")
    with pytest.raises(RuntimeError, match="extra"):
        convert.load_clip_model(str(tmp_path / "clip.pth"), device="cpu")


# ---------------------------------------------------------------------------
# host-side copies


def _random_layouts(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 6))
        lt = rng.uniform(0, 0.6, (k, 2))
        boxes = np.concatenate([lt, lt + rng.uniform(0.05, 0.4, (k, 2))], 1)
        out.append((boxes, rng.integers(0, 4, k)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    gt, gen = _random_layouts(rng, 12), _random_layouts(rng, 12)
    for name in ("compute_maximum_iou", "compute_docsim"):
        np.testing.assert_array_equal(getattr(pmetrics, name)(gt, gen),
                                      getattr(jmetrics, name)(gt, gen))
    a, b = rng.uniform(0, 1, (20, 4)), rng.uniform(0, 1, (20, 4))
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    for generalized in (False, True):
        np.testing.assert_array_equal(
            pmetrics.compute_iou(a, b, generalized),
            jmetrics.compute_iou(a, b, generalized))


def test_clip_scores_equal_jax():
    rng = np.random.default_rng(5)
    im, tx = rng.standard_normal((6, 32)), rng.standard_normal((6, 32))
    refs = [rng.standard_normal((int(rng.integers(1, 4)), 32)) for _ in range(6)]
    np.testing.assert_array_equal(pclip_score.clip_score(im, tx),
                                  jclip_score.clip_score(im, tx))
    np.testing.assert_array_equal(pclip_score.ref_clip_score(im, tx, refs),
                                  jclip_score.ref_clip_score(im, tx, refs))


def test_l2_normalize_passes_zero_rows():
    a = torch.tensor([[3.0, 4.0], [0.0, 0.0]])
    torch.testing.assert_close(l2_normalize(a),
                               torch.tensor([[0.6, 0.8], [0.0, 0.0]]))
