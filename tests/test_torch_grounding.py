"""The extra grounding modules of the port against the JAX package, in f32
on the CPU: the text + image, keypoint and map tokenizers, the condition
map downsampler, ConvNeXt-tiny's and ResNet-18/-50's features, the three
gated fusers, the resizes they stand on (against ``jax.image.resize``, up
and down, with a planted ``antialias=False`` shown to fail), and the
weights bridge of every new subtree, strict. The same numpy inputs from a
seed go through both sides; the JAX weights cross with
checkpoint/from_jax.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from layoutllm_t2i_tpu.models import blocks as jblocks
from layoutllm_t2i_tpu.models import convnext as jconvnext
from layoutllm_t2i_tpu.models import grounding_extras as jge
from layoutllm_t2i_tpu.models import position_net as jpn
from layoutllm_t2i_tpu.models import resnet as jresnet
from layoutllm_t2i_tpu.models import unet as junet

from layoutllm_t2i_torch.checkpoint.from_jax import (resnet_params_from_jax,
                                                     state_dict_from_jax,
                                                     unet_params_from_jax)
from layoutllm_t2i_torch.models import blocks as pblocks
from layoutllm_t2i_torch.models import convnext as pconvnext
from layoutllm_t2i_torch.models import grounding_extras as pge
from layoutllm_t2i_torch.models import position_net as ppn
from layoutllm_t2i_torch.models import resnet as presnet
from layoutllm_t2i_torch.models import unet as punet
from layoutllm_t2i_torch.ops import nn as pnn
from layoutllm_t2i_torch.ops import resize as presize
from layoutllm_t2i_torch.utils.trees import unflatten_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = RTOL = 1e-4
# the resizes alone: f32 sums of at most a few dozen taps
RESIZE_TOL = 1e-5


def port_tree(tree):
    """JAX tree -> nested dict of torch tensors in the torch layouts."""
    return unflatten_tree(state_dict_from_jax(tree))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(out, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol,
                               rtol=rtol)


def _randomize(tree, rng, scale=0.5):
    """Non-zero values for the leaves that init leaves at zero (null
    features, person and keypoint embeddings, biases): a zero would hide
    a fault behind its product."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, scale)
        else:
            a = np.asarray(v)
            out[k] = (a + rng.standard_normal(a.shape).astype(np.float32)
                      * scale * 0.02) if a.ndim else a
    return out


# ---------------------------------------------------------------------------
# ops/resize.py against jax.image.resize


RESIZES = [("bilinear", 64, 48), ("bilinear", 512, 448), ("bilinear", 8, 20),
           ("bicubic", 64, 32), ("bicubic", 512, 256), ("bicubic", 2, 4),
           ("bicubic", 14, 64), ("bicubic", 14, 32)]


@pytest.mark.parametrize("method,src,dst", RESIZES)
def test_resize_matches_jax(rng, method, src, dst):
    x = rng.random((2, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method))
    _close(presize.resize_nhwc(_t(x), (dst, dst), method), want,
           atol=RESIZE_TOL, rtol=0)
    # a planted antialias=False: torch's own edge clamping (bilinear) and
    # a = -0.75 (bicubic). It fails every case but the bilinear upsample,
    # where both forms agree with JAX
    planted = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(dst, dst),
                            mode=method, align_corners=False).permute(0, 2, 3, 1)
    err = float(np.abs(planted.numpy() - want).max())
    if method == "bilinear" and dst > src:
        assert err < RESIZE_TOL
    else:
        assert err > 100 * RESIZE_TOL, err


def test_resize_keeps_dtype_and_refuses_other_methods():
    x = torch.rand(1, 4, 4, 2, dtype=torch.bfloat16)
    assert presize.resize_nhwc(x, (8, 8), "bicubic").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="nearest"):
        presize.resize_nhwc(x, (8, 8), "nearest")


# ---------------------------------------------------------------------------
# tokenizers


def test_position_net_text_image(rng):
    p = _randomize(jpn.init_position_net_text_image(jax.random.PRNGKey(1), 768, 768), rng)
    b, n = 2, 30
    boxes = rng.random((b, n, 4)).astype(np.float32)
    masks = (rng.random((b, n)) > 0.3).astype(np.float32)
    tm = (rng.random((b, n)) > 0.5).astype(np.float32)
    im = (rng.random((b, n)) > 0.5).astype(np.float32)
    te = rng.standard_normal((b, n, 768)).astype(np.float32)
    ie = rng.standard_normal((b, n, 768)).astype(np.float32)
    ref = jax.jit(jpn.position_net_text_image)(p, *map(jnp.asarray, (boxes, masks, tm, im, te, ie)))
    out = ppn.position_net_text_image(port_tree(p), *map(_t, (boxes, masks, tm, im, te, ie)))
    assert out.shape == (b, 2 * n, 768)
    _close(out, ref)


def test_position_net_keypoint(rng):
    persons = 3
    p = _randomize(jge.init_position_net_keypoint(jax.random.PRNGKey(2), persons, 768), rng,
                   scale=5.0)
    b = 2
    pts = rng.random((b, persons * 17, 2)).astype(np.float32)
    masks = (rng.random((b, persons * 17)) > 0.4).astype(np.float32)
    ref = jax.jit(jge.position_net_keypoint, static_argnums=(3, 4))(
        p, jnp.asarray(pts), jnp.asarray(masks), persons, 768)
    out = pge.position_net_keypoint(port_tree(p), _t(pts), _t(masks), persons, 768)
    assert out.shape == (b, persons * 17, 768)
    _close(out, ref)


def test_position_net_map_at_resize_64(rng):
    """ConvNeXt-tiny over a 64^2 resize of a 48x40 map: 2^2 tokens, one
    sample masked to the null feature."""
    p = _randomize(jge.init_position_net_map(jax.random.PRNGKey(3), 768, resize_input=64),
                   rng)
    cmap = rng.random((2, 48, 40, 3)).astype(np.float32)
    mask = np.asarray([1.0, 0.0], np.float32)
    ref = jax.jit(jge.position_net_map, static_argnums=3)(
        p, jnp.asarray(cmap), jnp.asarray(mask), 64)
    out = pge.position_net_map(port_tree(p), _t(cmap), _t(mask), resize_input=64)
    assert out.shape == (2, 4, 768)
    _close(out, ref)


@pytest.mark.parametrize("size,resize", [(40, 32), (96, 256)])
def test_grounding_downsampler(rng, size, resize):
    p = jge.init_grounding_downsampler(jax.random.PRNGKey(4), 8)
    cmap = rng.random((2, size, size, 3)).astype(np.float32)
    ref = jax.jit(jge.grounding_downsampler, static_argnums=2)(p, jnp.asarray(cmap), resize)
    out = pge.grounding_downsampler(port_tree(p), _t(cmap), resize_input=resize)
    assert out.shape == (2, resize // 4, resize // 4, 8)
    _close(out, ref)


def test_convnext_tiny_features(rng):
    cfg = jconvnext.ConvNeXtConfig()
    # a real layer scale: at the init's 1e-6 every block is nearly the
    # identity and would hide a fault in its branch
    p = jconvnext.init_convnext_params(jax.random.PRNGKey(5), cfg)
    for stage in p["stages"].values():
        for blk in stage.values():
            blk["gamma"] = rng.uniform(0.2, 0.6, blk["gamma"].shape).astype(np.float32)
    x = rng.random((1, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jconvnext.convnext_features, static_argnums=1)(p, cfg, jnp.asarray(x))
    out = pconvnext.convnext_features(port_tree(p), pconvnext.ConvNeXtConfig(),
                                      pnn.nhwc_to_nchw(_t(x)))
    assert out.shape == (1, 768, 2, 2) and out.is_contiguous(memory_format=torch.channels_last)
    _close(pnn.nchw_to_nhwc(out), ref, atol=1e-3, rtol=1e-3)
    rel = float(np.abs(pnn.nchw_to_nhwc(out).numpy() - np.asarray(ref)).max()
                / np.abs(np.asarray(ref)).max())
    assert rel < 1e-4, rel


def _random_bn(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            if "running_var" in v:
                c = np.shape(v["running_var"])[0]
                v.update(weight=rng.uniform(0.5, 1.5, c).astype(np.float32),
                         bias=rng.uniform(-0.2, 0.2, c).astype(np.float32),
                         running_mean=rng.uniform(-0.2, 0.2, c).astype(np.float32),
                         running_var=rng.uniform(0.5, 2.0, c).astype(np.float32))
            else:
                _random_bn(v, rng)
    return tree


@pytest.mark.parametrize("cfg", [jresnet.ResNetConfig(),
                                 jresnet.ResNetConfig(block="bottleneck",
                                                      layers=(3, 4, 6, 3))],
                         ids=["resnet18", "resnet50"])
def test_resnet_features(rng, cfg):
    p = _random_bn(jresnet.init_resnet_params(jax.random.PRNGKey(6), cfg), rng)
    p = jax.tree_util.tree_map(np.asarray, p)
    x = rng.random((1, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jresnet.resnet_features, static_argnums=1)(p, cfg, jnp.asarray(x))
    pcfg = presnet.ResNetConfig(block=cfg.block, layers=cfg.layers)
    tree = resnet_params_from_jax(p, pcfg)
    out = presnet.resnet_features(tree, pcfg, pnn.nhwc_to_nchw(_t(x)))
    assert out.shape == (1, cfg.out_dim, 2, 2)
    ref = np.asarray(ref)
    rel = float(np.abs(pnn.nchw_to_nhwc(out).numpy() - ref).max() / np.abs(ref).max())
    assert rel < 1e-4, rel


def test_position_net_map_resnet(rng):
    p = jresnet.init_position_net_map_resnet(jax.random.PRNGKey(7), 768, resize_input=64)
    p = _randomize(jax.tree_util.tree_map(np.asarray, p), rng)
    cmap = rng.random((2, 50, 50, 3)).astype(np.float32)
    mask = np.asarray([1.0, 0.0], np.float32)
    ref = jax.jit(jresnet.position_net_map_resnet, static_argnums=3)(
        p, jnp.asarray(cmap), jnp.asarray(mask), 64)
    out = presnet.position_net_map_resnet(port_tree(p), _t(cmap), _t(mask),
                                          resize_input=64)
    _close(out, ref)


# ---------------------------------------------------------------------------
# the gated fusers


def _fuser_params(rng, kind, c=64, heads=2):
    if kind == "gatedCA":
        p = jblocks.init_gated_cross_attention(jax.random.PRNGKey(8), c, 96, 96,
                                               heads, c // heads)
    else:
        p = jblocks.init_gated_self_attention(jax.random.PRNGKey(8), c, 96, heads,
                                              c // heads)
    p["alpha_attn"] = np.asarray(rng.uniform(0.3, 0.9), np.float32)
    p["alpha_dense"] = np.asarray(rng.uniform(0.3, 0.9), np.float32)
    return p


@pytest.mark.parametrize("kind,n_visual,n_ground", [
    ("gatedSA", 64, 30), ("gatedSA2", 16, 4), ("gatedSA2", 64, 16),
    ("gatedCA", 64, 30)])
def test_gated_fusers(rng, kind, n_visual, n_ground):
    """gatedSA2 at a 4^2 grid with 2^2 tokens, as tests/
    test_reference_parity.py:98-99 holds it, and at 8^2 with 4^2."""
    p = _fuser_params(rng, kind)
    x = rng.standard_normal((2, n_visual, 64)).astype(np.float32)
    objs = rng.standard_normal((2, n_ground, 96)).astype(np.float32)
    fj = {"gatedSA": jblocks.gated_self_attention, "gatedSA2": jblocks.gated_self_attention2,
          "gatedCA": jblocks.gated_cross_attention}[kind]
    ref = jax.jit(lambda p, x, o: fj(p, x, o, 2, 0.8))(p, jnp.asarray(x), jnp.asarray(objs))
    out = pblocks._FUSERS[kind](port_tree(p), _t(x), _t(objs), 2, 0.8)
    _close(out, ref)


def test_gated_self_attention2_refuses_non_square_grids(rng):
    p = port_tree(_fuser_params(rng, "gatedSA2"))
    with pytest.raises(ValueError, match="square"):
        pblocks.gated_self_attention2(p, torch.zeros(1, 16, 64),
                                      torch.zeros(1, 30, 96), 2, 1.0)


# ---------------------------------------------------------------------------
# the weights bridge of every new subtree, strict


SMALL_UNET = dict(image_size=8, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(2, 1), channel_mult=(1, 2),
                  num_heads=2)


@pytest.mark.parametrize("extra", [
    dict(grounding_type="text_image"), dict(grounding_type="keypoint",
                                            max_persons_per_image=3),
    dict(grounding_type="map", additional_in_channels=8, fuser_type="gatedSA2",
         use_relation_attention=False),
    dict(fuser_type="gatedCA", inpaint_mode=True)])
def test_unet_bridge_is_strict(extra):
    cfg_j = junet.UNetConfig(**SMALL_UNET, **extra)
    tree = jax.tree_util.tree_map(np.asarray,
                                  junet.init_unet_params(jax.random.PRNGKey(9), cfg_j))
    if cfg_j.grounding_type == "map":
        tree["downsample_net"] = jge.init_grounding_downsampler(
            jax.random.PRNGKey(10), 8)
    cfg_p = punet.UNetConfig(**SMALL_UNET, **extra)
    got = unet_params_from_jax(tree, cfg_p)
    sd = got.state_dict()
    assert set(sd) == set(state_dict_from_jax(tree))
    first = sd["input_blocks.0.0.weight"]
    assert first.shape == (32, cfg_p.first_conv_in_channels, 3, 3)
    if cfg_j.grounding_type == "map":
        pn = "position_net.convnext_tiny_backbone."
        dw = tree["position_net"]["convnext_tiny_backbone"]["stages"]["1"]["0"]["dwconv"]["weight"]
        assert dw.shape == (7, 7, 1, 192)
        np.testing.assert_array_equal(sd[pn + "stages.1.0.dwconv.weight"].numpy(),
                                      dw.transpose(3, 2, 0, 1))
        assert sd["position_net.pos_embedding"].shape == (1, 196, 768)
        assert sd["downsample_net.layers.2.weight"].shape == (8, 4, 4, 4)
    # a missing or an extra leaf is refused
    flat = state_dict_from_jax(tree)
    name = sorted(n for n in flat if n.startswith("position_net."))[0]
    broken = unflatten_tree({k: v.numpy() for k, v in flat.items() if k != name})
    with pytest.raises(RuntimeError, match="Missing"):
        unet_params_from_jax(broken, cfg_p)
    extra_tree = unflatten_tree({**{k: v.numpy() for k, v in flat.items()},
                                 "position_net.unknown": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        unet_params_from_jax(extra_tree, cfg_p)


def test_resnet_bridge_keeps_bn_statistics(rng):
    cfg = jresnet.ResNetConfig()
    p = _random_bn(jax.tree_util.tree_map(
        np.asarray, jresnet.init_resnet_params(jax.random.PRNGKey(11), cfg)), rng)
    tree = resnet_params_from_jax(p, presnet.ResNetConfig())
    np.testing.assert_array_equal(tree["layer2"]["0"]["downsample"]["1"]["running_var"].numpy(),
                                  p["layer2"]["0"]["downsample"]["1"]["running_var"])
    assert tree["conv1"]["weight"].shape == (64, 3, 7, 7)
