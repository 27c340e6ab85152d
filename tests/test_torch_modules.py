"""Module parity: layoutllm_t2i_torch against the JAX package on the CPU.

Weights come from the JAX ``init_*`` functions and cross over through
``checkpoint/from_jax.py``; inputs come from a numpy seed. Both sides run
in f32 (JAX at 'highest' matmul precision, tests/conftest.py), so the
tolerance is 1e-4, as tests/test_reference_parity.py holds. The fuser and
relation alphas are set non-zero first: at their init value 0, tanh(0) = 0
would hide any fault in the gated branches.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.diffusion import samplers as jsamp
from layoutllm_t2i_tpu.models import blocks as jblocks
from layoutllm_t2i_tpu.models import clip_text as jclip
from layoutllm_t2i_tpu.models import position_net as jpn
from layoutllm_t2i_tpu.models import unet as junet
from layoutllm_t2i_tpu.models import vae as jvae
from layoutllm_t2i_tpu.models.clip_tokenizer import HashTokenizer
from layoutllm_t2i_tpu.ops import attention as jattn
from layoutllm_t2i_tpu.ops import nn as jnn
from layoutllm_t2i_tpu.ops import schedules as jsched
from layoutllm_t2i_tpu.pipeline import inference as jinf

from layoutllm_t2i_torch.checkpoint.from_jax import state_dict_from_jax
from layoutllm_t2i_torch.diffusion import samplers as psamp
from layoutllm_t2i_torch.models import blocks as pblocks
from layoutllm_t2i_torch.models import clip_text as pclip
from layoutllm_t2i_torch.models import position_net as ppn
from layoutllm_t2i_torch.models import unet as punet
from layoutllm_t2i_torch.models import vae as pvae
from layoutllm_t2i_torch.ops import attention as pattn
from layoutllm_t2i_torch.ops import nn as pnn
from layoutllm_t2i_torch.ops import schedules as psched
from layoutllm_t2i_torch.pipeline import inference as pinf
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = RTOL = 1e-4

SMALL_UNET = dict(image_size=8, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(2, 1), channel_mult=(1, 2),
                  num_heads=2)
SMALL_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)


def port_tree(tree):
    """JAX tree -> nested dict of torch tensors under the same names."""
    out = {}
    for name, t in state_dict_from_jax(tree).items():
        node = out
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def set_alphas(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            set_alphas(v, rng)
        elif k.startswith("alpha_"):
            tree[k] = np.asarray(rng.uniform(0.3, 0.9), np.float32)
    return tree


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(out, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=atol,
                               rtol=rtol)


def _layout(rng, b, mo=30):
    boxes = np.zeros((b, mo, 4), np.float32)
    masks = np.zeros((b, mo), np.float32)
    boxes[0, :4] = [[0.1, 0.2, 0.5, 0.9], [0.55, 0.1, 0.95, 0.6],
                    [0.3, 0.3, 0.31, 0.31],   # degenerate: stops the loop
                    [0.0, 0.0, 1.0, 1.0]]     # skipped after the break
    masks[0, :4] = 1
    if b > 1:
        boxes[1, :2] = [[0.05, 0.05, 0.7, 0.4], [0.2, 0.5, 0.8, 1.0]]
        masks[1, :2] = 1
    return boxes, masks


def test_schedule_tables_and_embeddings(rng):
    sched_j = jsched.make_ddpm_schedule("linear", 1000, 0.00085, 0.012)
    sched_p = psched.make_ddpm_schedule("linear", 1000, 0.00085, 0.012)
    for steps, alpha in ((50, (0.3, 0.0, 0.7)), (4, (0.5, 0.0, 0.5)),
                         (7, (0.4, 0.3, 0.3))):
        tj = jsamp.make_step_tables(sched_j, steps, alpha_type=alpha)
        tp = psamp.make_step_tables(sched_p, steps, alpha_type=alpha)
        for name in tj._fields:
            np.testing.assert_array_equal(np.asarray(getattr(tj, name)),
                                          np.asarray(getattr(tp, name)), name)
    t = rng.integers(0, 1000, 5)
    for dim in (32, 33):
        _close(psched.timestep_embedding(_t(t), dim),
               jsched.timestep_embedding(jnp.asarray(t), dim), atol=1e-5)
    boxes = rng.uniform(0, 1, (2, 30, 4)).astype(np.float32)
    _close(psched.fourier_embed(_t(boxes)), jsched.fourier_embed(jnp.asarray(boxes)),
           atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 6, 10, 4)])
def test_avg_pool_2x(rng, shape):
    # the JAX function takes NHWC, the port's logical NCHW (channels_last)
    x = rng.normal(size=shape).astype(np.float32)
    out = pnn.avg_pool_2x(pnn.nhwc_to_nchw(_t(x)))
    assert out.is_contiguous(memory_format=torch.channels_last)
    _close(pnn.nchw_to_nhwc(out), jnn.avg_pool_2x(jnp.asarray(x)), atol=1e-6,
           rtol=1e-6)


@pytest.mark.parametrize("n,m,masked", [
    (600, 130, False),   # the port's flash route (K1's plain version here)
    (600, 130, True),    # a key mask keeps it on the plain path
    (64, 77, False),     # short: plain path
])
def test_multi_head_attention(rng, n, m, masked):
    heads, c = 2, 40
    q = rng.standard_normal((2, n, heads * c)).astype(np.float32)
    k = rng.standard_normal((2, m, heads * c)).astype(np.float32)
    v = rng.standard_normal((2, m, heads * c)).astype(np.float32)
    mask = (rng.uniform(size=(2, m)) > 0.3).astype(np.float32) if masked else None
    ref = jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
        mask=None if mask is None else jnp.asarray(mask), impl="xla")
    out = pattn.multi_head_attention(_t(q), _t(k), _t(v), heads,
                                     mask=None if mask is None else _t(mask))
    _close(out, ref)


def test_clip_text(rng):
    cfg_j = jclip.CLIPTextConfig(num_layers=2)
    cfg_p = pclip.CLIPTextConfig(num_layers=2)
    params = jclip.init_clip_text_params(jax.random.PRNGKey(1), cfg_j)
    ids = HashTokenizer()(["a dog on a red sofa", "two cats", ""])
    hj, pj = jclip.clip_text_apply(params, cfg_j, jnp.asarray(ids))
    hp, pp = pclip.clip_text_apply(port_tree(params), cfg_p,
                                   torch.from_numpy(ids.astype(np.int64)))
    _close(hp, hj)
    _close(pp, pj)


def test_position_net(rng):
    params = jpn.init_position_net(jax.random.PRNGKey(2), 768, 768)
    params["null_positive_feature"] = rng.standard_normal(768).astype(np.float32)
    params["null_position_feature"] = rng.standard_normal(64).astype(np.float32)
    boxes, masks = _layout(rng, 2)
    emb = rng.standard_normal((2, 30, 768)).astype(np.float32)
    ref = jpn.position_net(params, jnp.asarray(boxes), jnp.asarray(masks),
                           jnp.asarray(emb))
    out = ppn.position_net(port_tree(params), _t(boxes), _t(masks), _t(emb))
    _close(out, ref)


def test_relation_cross_attention(rng):
    c, heads, h, w = 64, 2, 12, 12
    params = set_alphas(jblocks.init_relation_cross_attention(
        jax.random.PRNGKey(3), c, 768, 768, heads, c // heads), rng)
    boxes, masks = _layout(rng, 2)
    x = rng.standard_normal((2, h * w, c)).astype(np.float32)
    rel = rng.standard_normal((2, 5, 768)).astype(np.float32)
    ref = jblocks.relation_cross_attention(
        params, jnp.asarray(x), jnp.asarray(rel), jnp.asarray(boxes),
        jnp.asarray(masks), h, w, heads)
    out = pblocks.relation_cross_attention(port_tree(params), _t(x), _t(rel),
                                           _t(boxes), _t(masks), h, w, heads)
    _close(out, ref)
    rj, procj = jblocks.rasterize_boxes(jnp.asarray(boxes), jnp.asarray(masks), h, w)
    rp, procp = pblocks.rasterize_boxes(_t(boxes), _t(masks), h, w)
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(procp.numpy(), np.asarray(procj))


@pytest.mark.parametrize("skip_gated", [False, True])
def test_basic_transformer_block(rng, skip_gated):
    # 24x24 tokens: the self-attention (576 rows) and the gated
    # self-attention (576 + 30) take the port's flash route
    c, heads, h, w = 64, 2, 24, 24
    params = set_alphas(jblocks.init_basic_transformer_block(
        jax.random.PRNGKey(4), c, 768, 768, heads, c // heads), rng)
    boxes, masks = _layout(rng, 2)
    x = rng.standard_normal((2, h * w, c)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 768)).astype(np.float32)
    objs = rng.standard_normal((2, 30, 768)).astype(np.float32)
    rel = rng.standard_normal((2, 5, 768)).astype(np.float32)
    ref = jblocks.basic_transformer_block(
        params, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(objs),
        jnp.asarray(rel), jnp.asarray(boxes), jnp.asarray(masks), h, w, heads,
        fuser_scale=0.8, skip_gated=skip_gated)
    out = pblocks.basic_transformer_block(
        port_tree(params), _t(x), _t(ctx), _t(objs), _t(rel), _t(boxes),
        _t(masks), h, w, heads, fuser_scale=0.8, skip_gated=skip_gated)
    _close(out, ref)


@pytest.mark.parametrize("skip_gated", [False, True])
def test_unet_apply(rng, skip_gated):
    _unet_parity(rng, SMALL_UNET, skip_gated)


@pytest.mark.parametrize("relation", [True, False])
def test_unet_apply_transformer_depth_2(rng, relation):
    # transformer_depth, a .pth config field (pipeline/loaders.py): two
    # transformer blocks in every spatial transformer, with and without the
    # relation fuser; 1.5e-6 from the JAX outputs (of about 1) when written
    _unet_parity(rng, dict(SMALL_UNET, transformer_depth=2,
                           use_relation_attention=relation), False)


def _unet_parity(rng, geometry, skip_gated):
    """The port's unet_apply against the JAX one at ``geometry``, from the
    same JAX-initialised weights (alphas set) and numpy inputs."""
    cfg_j = junet.UNetConfig(**geometry)
    cfg_p = punet.UNetConfig(**geometry)
    params = set_alphas(junet.init_unet_params(jax.random.PRNGKey(5), cfg_j), rng)
    b = 2
    x = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    t = np.asarray([901, 41])
    ctx = rng.standard_normal((b, 77, 768)).astype(np.float32)
    boxes, masks = _layout(rng, b)
    emb = rng.standard_normal((b, 30, 768)).astype(np.float32)
    rel = rng.standard_normal((b, 5, 768)).astype(np.float32)
    # jit: one compile instead of op-by-op dispatch (the same XLA ops)
    jax_unet = jax.jit(lambda p, *a: junet.unet_apply(
        p, cfg_j, *a, fuser_scale=0.7, skip_gated=skip_gated))
    ref = jax_unet(params, *(jnp.asarray(a) for a in
                             (x, t, ctx, boxes, masks, emb, rel)))
    out = punet.unet_apply(port_tree(params), cfg_p, pnn.nhwc_to_nchw(_t(x)),
                           _t(t), _t(ctx), _t(boxes), _t(masks), _t(emb),
                           _t(rel), fuser_scale=0.7, skip_gated=skip_gated)
    _close(pnn.nchw_to_nhwc(out), ref)


def test_cfg_denoiser_doubled_batch_and_first_conv_select(rng):
    """make_cfg_denoiser: the [cond; uncond] doubled batch (zeroed boxes,
    masks and phrases, duplicated relations in the uncond half) and the
    alpha == 0 swap to the SD first conv, on both values of use_sd."""
    cfg_j = junet.UNetConfig(**SMALL_UNET)
    params = set_alphas(junet.init_unet_params(jax.random.PRNGKey(8), cfg_j), rng)
    sd_conv = {"weight": rng.standard_normal((3, 3, 4, 32)).astype(np.float32) * 0.2,
               "bias": rng.standard_normal(32).astype(np.float32) * 0.2}
    b = 2
    boxes, masks = _layout(rng, b)
    cond = {"context": rng.standard_normal((b, 77, 768)).astype(np.float32),
            "uc_context": rng.standard_normal((b, 77, 768)).astype(np.float32),
            "boxes": boxes, "masks": masks,
            "phrase_embeddings": rng.standard_normal((b, 30, 768)).astype(np.float32),
            "relations": rng.standard_normal((b, 5, 768)).astype(np.float32)}
    x = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    t = np.asarray([901, 901])
    jax_dn = jax.jit(jinf.make_cfg_denoiser(
        types.SimpleNamespace(unet_cfg=cfg_j, compute_dtype=jnp.float32), 7.5),
        static_argnames=("fuser_scale",))
    port_dn = pinf.make_cfg_denoiser(
        types.SimpleNamespace(unet_cfg=punet.UNetConfig(**SMALL_UNET),
                              compute_dtype=torch.float32), 7.5)
    pparams = port_tree(params)
    psd = state_dict_from_jax(sd_conv)
    pcond = {k: _t(v) for k, v in cond.items()}
    outs = []
    for use_sd in (False, True):
        ref = jax_dn(params, sd_conv, {k: jnp.asarray(v) for k, v in cond.items()},
                     jnp.asarray(x), jnp.asarray(t), fuser_scale=0.6,
                     use_sd=jnp.asarray(use_sd))
        out = port_dn(pparams, psd, pcond, pnn.nhwc_to_nchw(_t(x)), _t(t), 0.6, use_sd)
        _close(pnn.nchw_to_nhwc(out), ref)
        outs.append(out)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3


def test_vae_decode(rng):
    cfg_j = jvae.VAEConfig(**SMALL_VAE)
    cfg_p = pvae.VAEConfig(**SMALL_VAE)
    params = jvae.init_vae_params(jax.random.PRNGKey(6), cfg_j)
    # 24x24 latent: the mid attention (576 tokens, one head of 64) takes
    # the port's flash route
    z = rng.standard_normal((1, 24, 24, 4)).astype(np.float32) * 0.2
    ref = jvae.decode(params, cfg_j, jnp.asarray(z))
    out = pvae.decode(port_tree(params), cfg_p, pnn.nhwc_to_nchw(_t(z)))
    _close(pnn.nchw_to_nhwc(out), ref)
