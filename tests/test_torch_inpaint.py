"""Inpainting in the port against the JAX package on the CPU: the masks
(exact; the stroke masks bit for bit from a seeded random.Random), the
sampler blend (one q-sample, then PLMS, DDIM and DPM-Solver++ with an
InpaintBlend on a closed-form denoiser), and the pipeline with
inpaint_mask / inpaint_z0 and with inpainting_extra on an inpaint_mode
UNet, under tests/parity_setup.py's gates.

The JAX samplers draw the blend's noise from threefry keys, which a torch
generator cannot reproduce; the port takes the JAX side's draws, made here
as the JAX samplers make them: one key a step from
``jax.random.split(rng, steps)``, split again by DDIM (the blend takes the
first half).
"""
import dataclasses
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.diffusion import samplers as jsamp
from layoutllm_t2i_tpu.models import initializers as jinit
from layoutllm_t2i_tpu.ops import schedules as jsched
from layoutllm_t2i_tpu.pipeline import inpaint as jinpaint
from layoutllm_t2i_tpu.pipeline.inference import InferencePipeline as JaxPipeline
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models

from parity_setup import LATENT_GATE, PSNR_GATE_DB, SSIM_GATE, psnr, ssim

from layoutllm_t2i_torch.checkpoint.from_jax import load_from_jax, unet_params_from_jax
from layoutllm_t2i_torch.diffusion import samplers as psamp
from layoutllm_t2i_torch.ops import schedules as psched
from layoutllm_t2i_torch.ops.nn import nchw_to_nhwc, nhwc_to_nchw
from layoutllm_t2i_torch.pipeline import inpaint as pinpaint
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.pipeline.loaders import random_models
from layoutllm_t2i_torch.utils.flops import unet_evaluations
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BOXES = [[[0.1, 0.2, 0.5, 0.9], [0.55, 0.1, 0.95, 0.6], [0.3, 0.3, 0.3, 0.8]],
         [[0.0, 0.0, 1.0, 0.5], [0.2, 0.5, 0.8, 1.0], [0.0, 0.0, 0.0, 0.0]]]


# ---------------------------------------------------------------------------
# masks


@pytest.mark.parametrize("size", [8, 64])
@pytest.mark.parametrize("fg,bg", [(False, False), (True, False), (False, True),
                                   (True, True)])
def test_draw_masks_from_boxes_exact(size, fg, bg):
    boxes = np.asarray(BOXES, np.float32)
    for seed in (0, 3):
        want = jinpaint.draw_masks_from_boxes(boxes, size, fg, bg, seed=seed)
        got = pinpaint.draw_masks_from_boxes(boxes, size, fg, bg, seed=seed)
        assert got.shape == (2, size, size, 1) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    plain = pinpaint.draw_masks_from_boxes(boxes, 8)
    # truncation by astype(int): box 0 covers x in [0, 4), y in [1, 7)
    assert plain[0, 1:7, 0:4].max() == 0 and plain[0, 0, 0, 0] == 1
    # zero-width and padded boxes mask nothing
    assert plain[1, 4:, :].min() == 0 and plain[1, :4, :].max() == 0


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_stroke_masks_bit_for_bit(seed):
    for fn, args in ((lambda m, r: m.generate_stroke_mask(r, 64, 4, 10, 32, 3, 12), ()),
                     (lambda m, r: m.get_fg_mask(r, 24, 40), ()),
                     (lambda m, r: m.get_bg_mask(r, 32), ())):
        want = fn(jinpaint, random.Random(seed))
        got = fn(pinpaint, random.Random(seed))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < got.size


# ---------------------------------------------------------------------------
# the sampler blend


SCHEDULE_J = jsched.make_ddpm_schedule("linear", 1000, 0.00085, 0.012)
SCHEDULE_P = psched.make_ddpm_schedule("linear", 1000, 0.00085, 0.012)


def test_q_sample_matches_jax(rng):
    z0 = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    for t in (981, 501, 1):
        want = jsamp._q_sample(jsamp._schedule_device(SCHEDULE_J), jnp.asarray(z0),
                               jnp.full((2,), t), key)
        noise = np.array(jax.random.normal(key, z0.shape, jnp.float32))
        got = psamp._q_sample(SCHEDULE_P, torch.from_numpy(z0), t, torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def _toy_denoise_j(x, t, fscale, use_sd):
    tt = t.astype(jnp.float32)[:, None, None, None] / 1000.0
    return 0.4 * jnp.tanh(x) * tt + 0.05 * fscale + 0.02 * x


def _toy_denoise_p(x, t, fscale, use_sd):
    tt = t.float()[:, None, None, None] / 1000.0
    return 0.4 * torch.tanh(x) * tt + 0.05 * fscale + 0.02 * x


def blend_noise(kind, rng_key, steps, shape):
    """The JAX samplers' per-step blend noise, (S, *shape)."""
    keys = jax.random.split(rng_key, steps)
    if kind == "ddim":
        keys = [jax.random.split(k)[0] for k in keys]
    return np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                     for k in keys])


@pytest.mark.parametrize("kind", ["plms", "ddim", "dpm"])
def test_samplers_blend_like_jax(rng, kind):
    steps, shape = 6, (2, 8, 8, 4)
    tables_j = jsamp.make_step_tables(SCHEDULE_J, steps, alpha_type=(0.5, 0.0, 0.5))
    tables_p = psamp.make_step_tables(SCHEDULE_P, steps, alpha_type=(0.5, 0.0, 0.5))
    x = rng.standard_normal(shape).astype(np.float32)
    z0 = rng.standard_normal(shape).astype(np.float32)
    mask = np.asarray(pinpaint.draw_masks_from_boxes(np.asarray(BOXES, np.float32), 8))
    key = jax.random.PRNGKey(11)
    fj = {"plms": jsamp.plms_sample, "ddim": jsamp.ddim_sample, "dpm": jsamp.dpm_sample}[kind]
    fp = {"plms": psamp.plms_sample, "ddim": psamp.ddim_sample, "dpm": psamp.dpm_sample}[kind]
    want = fj(_toy_denoise_j, tables_j, jnp.asarray(x), schedule=SCHEDULE_J,
              inpaint=jsamp.InpaintBlend(mask=jnp.asarray(mask), z0=jnp.asarray(z0)),
              rng=key)
    noise = torch.from_numpy(blend_noise(kind, key, len(tables_p.t), shape))
    blend = psamp.InpaintBlend(mask=nhwc_to_nchw(torch.from_numpy(mask)),
                               z0=nhwc_to_nchw(torch.from_numpy(z0)),
                               noise=lambda i: nhwc_to_nchw(noise[i]))
    got = fp(_toy_denoise_p, tables_p, nhwc_to_nchw(torch.from_numpy(x)),
             schedule=SCHEDULE_P, inpaint=blend)
    np.testing.assert_allclose(nchw_to_nhwc(got).numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    # without the blend the result differs: the blend is what was held
    plain = fp(_toy_denoise_p, tables_p, nhwc_to_nchw(torch.from_numpy(x)))
    assert float(np.abs(nchw_to_nhwc(plain).numpy() - np.asarray(want)).max()) > 1e-2
    # a blend without the schedule is refused
    with pytest.raises(ValueError, match="schedule"):
        fp(_toy_denoise_p, tables_p, nhwc_to_nchw(torch.from_numpy(x)), inpaint=blend)


# ---------------------------------------------------------------------------
# the pipeline


PROMPTS = ["a dog chasing a ball on the grass", "a cat sitting on a chair"]
LAYOUTS = [([[0.1, 0.4, 0.5, 0.9], [0.6, 0.6, 0.85, 0.85]], ["a dog", "a ball"]),
           ([[0.2, 0.1, 0.6, 0.6]], ["a cat"])]
RELATIONS = [["dog chasing ball"], ["cat on chair"]]


def _bundles(inpaint_mode=False):
    jm = jax_random_models(seed=0, small=True)
    jm.unet_params["input_blocks"]["1"]["1"]["transformer_blocks"]["0"][
        "fuser"]["alpha_attn"] = np.asarray(0.6, np.float32)
    pm = random_models(small=True, device="cpu", seed=1)
    if inpaint_mode:
        jm.unet_cfg = dataclasses.replace(jm.unet_cfg, inpaint_mode=True)
        jm.unet_params["input_blocks"]["0"]["0"] = jinit.conv_p(
            jax.random.PRNGKey(5), 3, 3, jm.unet_cfg.first_conv_in_channels, 32)
        pm.unet_cfg = dataclasses.replace(pm.unet_cfg, inpaint_mode=True)
        pm.unet_params = unet_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jm.unet_params), pm.unet_cfg)
        names = ("vae_params", "clip_params")
    else:
        names = ("unet_params", "vae_params", "clip_params")
    for name in names:
        load_from_jax(getattr(pm, name), getattr(jm, name))
    return jm, pm


def _latent_j(jp, cond_j, noise, key):
    """The JAX pipeline's final latent and images: its _sample_fn, one
    compiled sampler, then its decode."""
    from layoutllm_t2i_tpu.models.vae import decode as jvae_decode
    from layoutllm_t2i_tpu.pipeline import inference as jinf

    jm = jp.models
    cj = dict(cond_j)
    cj["objs"] = jinf.precompute_grounding_tokens(jm, jm.unet_params, cj, True)
    core = jinf.make_cfg_denoiser(jm, jp.guidance_scale)
    sample = {"plms": jsamp.plms_sample, "ddim": jsamp.ddim_sample,
              "dpm": jsamp.dpm_sample}[jp.sampler]
    inpaint = (jsamp.InpaintBlend(mask=cj["inpaint_mask"], z0=cj["inpaint_z0"])
               if "inpaint_mask" in cj else None)
    z = jax.jit(lambda z: sample(
        lambda x, t, f, u: core(jm.unet_params, None, cj, x, t, f, u),
        jp.tables, z, schedule=jm.schedule, inpaint=inpaint, rng=key,
        denoise_skip_fn=lambda x, t, f, u: core(jm.unet_params, None, cj, x, t,
                                                f, u, skip_gated=True)))(
        jnp.asarray(noise))
    img = jax.jit(lambda z: jnp.clip(jvae_decode(jm.vae_params, jm.vae_cfg, z),
                                     -1.0, 1.0) * 0.5 + 0.5)(z)
    return np.asarray(z), np.asarray(img)


def _gates(jp, pp, cond_j, cond_p, noise, key, kind="plms"):
    """The port's latent and images against the JAX pipeline's, at
    tests/parity_setup.py's gates; the blend noise the JAX sampler's."""
    z_j, img_j = _latent_j(jp, cond_j, noise, key)
    bn = (blend_noise(kind, key, len(pp.tables.t), noise.shape)
          if "inpaint_mask" in cond_p else None)
    z_p = pp.run_sampler(cond_p, noise, blend_noise=bn)
    lat_err = float(np.abs(z_p.numpy() - z_j).max())
    assert lat_err < LATENT_GATE, lat_err
    img_p = pp.decode(z_p).numpy()
    assert img_p.shape == img_j.shape == (2, 16, 16, 3)
    for a, b in zip(img_p, img_j):
        assert psnr(a, b) >= PSNR_GATE_DB
        assert ssim(a, b) >= SSIM_GATE
    return z_p


def test_pipeline_inpaint_matches_jax(rng):
    jm, pm = _bundles()
    sample = dict(steps=4, guidance_scale=7.5, alpha_type=(0.5, 0.0, 0.5))
    jp, pp = JaxPipeline(jm, **sample), InferencePipeline(pm, **sample)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    z0 = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    keep = pinpaint.draw_masks_from_boxes(
        np.asarray([b for b, _ in LAYOUTS[:1]] * 2, np.float32), 8)
    cond_j = jp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    cond_j.update(inpaint_mask=jnp.asarray(keep), inpaint_z0=jnp.asarray(z0))
    cond_p = pp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    cond_p.update(inpaint_mask=torch.from_numpy(keep), inpaint_z0=torch.from_numpy(z0))
    z_p = _gates(jp, pp, cond_j, cond_p, noise, jax.random.PRNGKey(3)).numpy()
    # the kept region stays near z0 (the last blend, then one step's
    # update), the painted region does not
    kept = keep[..., 0] == 1
    assert np.abs(z_p - z0)[kept].mean() < 0.5 * np.abs(z_p - z0)[~kept].mean()


def test_pipeline_inpaint_mode_unet_matches_jax(rng):
    jm, pm = _bundles(inpaint_mode=True)
    assert pm.unet_params["input_blocks"]["0"]["0"]["weight"].shape == (32, 9, 3, 3)
    sample = dict(steps=3, guidance_scale=7.5, alpha_type=(0.5, 0.0, 0.5))
    jp, pp = JaxPipeline(jm, **sample), InferencePipeline(pm, **sample)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    extra = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    cond_j = jp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    cond_j["inpainting_extra"] = jnp.asarray(extra)
    cond_p = pp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    cond_p["inpainting_extra"] = torch.from_numpy(extra)
    _gates(jp, pp, cond_j, cond_p, noise, jax.random.PRNGKey(0))
    # no first-conv restore at alpha 0 over the extra channels
    assert pm.unet_cfg.first_conv_restorable is False


def test_fast_preset_runs_uncached_under_inpainting(rng, monkeypatch):
    """The encoder cache is off under inpainting: every evaluation runs the
    encoder, as utils/flops.py unet_evaluations(..., inpaint=True) lists."""
    from layoutllm_t2i_torch.pipeline import inference as pinf

    pm = random_models(small=True, device="cpu", seed=2)
    pp = InferencePipeline(pm, steps=6, sampler="dpm", alpha_type=(0.5, 0.0, 0.5),
                           cfg_interval=(0.0, 0.6), encoder_cache_interval=2)
    seen = []
    real = pinf.unet_apply

    def spy(params, cfg, x, *a, encoder_cache=None, **kw):
        seen.append((x.shape[0], not kw.get("skip_gated", False), encoder_cache is None))
        return real(params, cfg, x, *a, encoder_cache=encoder_cache, **kw)

    monkeypatch.setattr(pinf, "unet_apply", spy)
    cond = pp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    cond.update(inpaint_mask=torch.ones(2, 8, 8, 1), inpaint_z0=torch.zeros(2, 8, 8, 4))
    pp.run_sampler(cond, noise)
    assert seen == unet_evaluations(pp, 2, inpaint=True)
    assert all(enc for _, _, enc in seen)
    seen.clear()
    del cond["inpaint_mask"], cond["inpaint_z0"]
    pp.run_sampler(cond, noise)
    assert seen == unet_evaluations(pp, 2) and not all(enc for _, _, enc in seen)
