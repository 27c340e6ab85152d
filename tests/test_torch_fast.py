"""The fast path of the port (DPM-Solver++, DDIM, the guidance interval and
the encoder cache) against the JAX package on the CPU, at small geometry
with the JAX weights carried across and numpy noise; gates are
tests/parity_setup.py's (latent max |d| < 5e-3, PSNR >= 35 dB, SSIM >=
0.98). The samplers run over their CFG denoisers as in
tests/test_torch_pipeline.py (set-up: tests/torch_fast_setup.py); PLMS in
the two speed modes is tests/test_torch_fast_plms.py. Also: the step
tables (cfg_on, key steps, segments) equal the JAX package's; the UNet's
encoder cache round trip; parse_cfg_interval's errors; the fast preset.
"""
import argparse

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.diffusion import samplers as jsamplers
from layoutllm_t2i_tpu.models.unet import unet_apply as jax_unet_apply
from layoutllm_t2i_tpu.models.vae import decode as jax_vae_decode
from layoutllm_t2i_tpu.pipeline import inference as jinf
from layoutllm_t2i_tpu.pipeline import presets as jpresets
from layoutllm_t2i_tpu.pipeline.inference import InferencePipeline as JaxPipeline

from parity_setup import LATENT_GATE, PSNR_GATE_DB, SSIM_GATE, psnr, ssim
from torch_fast_setup import (INTERVAL, LAYOUTS, PROMPTS, RELATIONS, SAMPLE,
                              bridged_models, jax_latents, noise, pipelines)

from layoutllm_t2i_torch.diffusion import samplers as psamplers
from layoutllm_t2i_torch.models.unet import input_block_specs, unet_apply
from layoutllm_t2i_torch.ops.nn import nchw_to_nhwc, nhwc_to_nchw
from layoutllm_t2i_torch.pipeline import inference as pinf
from layoutllm_t2i_torch.pipeline import presets
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def models():
    return bridged_models()


@pytest.fixture(scope="module")
def conds(models):
    jp, pp = pipelines(*models)
    return (jp.build_cond(PROMPTS, LAYOUTS, RELATIONS),
            pp.build_cond(PROMPTS, LAYOUTS, RELATIONS))


def _latents_agree(models, conds, **kw):
    jp, pp = pipelines(*models, **kw)
    z = noise()
    want = jax_latents(jp, conds[0], z)
    got = pp.run_sampler(conds[1], z).numpy()
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err < LATENT_GATE, err
    return got


@pytest.mark.parametrize("sampler", ["dpm", "ddim"])
def test_sampler_matches_jax(models, conds, sampler):
    got = _latents_agree(models, conds, sampler=sampler)
    # a different solver from the same noise: not PLMS's latent
    plms = InferencePipeline(models[1], **SAMPLE).run_sampler(conds[1], noise())
    assert float(np.abs(got - plms.numpy()).max()) > 1e-3


@pytest.mark.parametrize("mode", [
    dict(cfg_interval=INTERVAL), dict(encoder_cache_interval=2)],
    ids=["interval", "cache"])
def test_dpm_speed_mode_matches_jax(models, conds, mode):
    _latents_agree(models, conds, sampler="dpm", **mode)


def test_fast_preset_images_match_jax(models, conds):
    """DPM + interval + encoder cache, the fast preset's pieces: latents and
    decoded images."""
    kw = dict(sampler="dpm", cfg_interval=INTERVAL, encoder_cache_interval=2)
    jp, pp = pipelines(*models, **kw)
    z_j = jax_latents(jp, conds[0], noise())
    z_p = pp.run_sampler(conds[1], noise())
    err = float(np.abs(z_p.numpy() - z_j).max())
    assert err < LATENT_GATE, err
    # the JAX pipeline's decode (_sample_fn): VAE, clip to [-1, 1], to [0, 1]
    jm = jp.models
    img_j = np.asarray(jnp.clip(jax.jit(lambda z: jax_vae_decode(
        jm.vae_params, jm.vae_cfg, z))(jnp.asarray(z_j)), -1.0, 1.0) * 0.5 + 0.5)
    img_p = pp.decode(z_p).numpy()
    assert img_p.shape == img_j.shape == (2, 16, 16, 3)
    for a, b in zip(img_p, img_j):
        assert psnr(a, b) >= PSNR_GATE_DB
        assert ssim(a, b) >= SSIM_GATE


def test_unet_evaluations_follow_the_tables(models, conds, monkeypatch):
    """Which UNet body each step runs in the fast configuration: CFG steps
    at batch 2B, cond-only ones at B, propagated steps with a cache and no
    encoder."""
    calls = []
    real = pinf.unet_apply

    def spy(params, cfg, x, *a, encoder_cache=None, return_encoder_cache=False,
            skip_gated=False, **kw):
        calls.append((x.shape[0], encoder_cache is not None, skip_gated))
        return real(params, cfg, x, *a, encoder_cache=encoder_cache,
                    return_encoder_cache=return_encoder_cache,
                    skip_gated=skip_gated, **kw)

    monkeypatch.setattr(pinf, "unet_apply", spy)
    pp = InferencePipeline(models[1], **SAMPLE, sampler="dpm",
                           cfg_interval=INTERVAL, encoder_cache_interval=2)
    pp.run_sampler(conds[1], noise())
    # steps 0-1 | 2-4 | 5-6: (grounded, CFG) | (skip, CFG) | (skip, cond-only)
    assert calls == [(4, False, False), (4, True, False), (4, False, True),
                     (4, True, True), (4, False, True), (2, False, True),
                     (2, True, True)]


@pytest.mark.parametrize("steps,alpha,interval,n", [
    (6, (0.3, 0.0, 0.7), (0.0, 0.75), 2), (15, (0.3, 0.0, 0.7), (0.0, 0.75), 2),
    (10, (0.3, 0.0, 0.7), (0.1, 0.85), 3), (20, (0.5, 0.2, 0.3), (0.0, 0.75), 2),
    (7, None, (0.2, 0.9), 4), (50, (0.3, 0.0, 0.7), None, 2)])
def test_step_tables_match_jax(models, steps, alpha, interval, n):
    kw = dict(steps=steps, alpha_type=alpha, cfg_interval=interval,
              encoder_cache_interval=n, sampler="dpm")
    jp, pp = JaxPipeline(models[0], **kw), InferencePipeline(models[1], **kw)
    np.testing.assert_array_equal(pp._key_steps(), jp._key_steps())
    cfg_on = None
    if interval is not None:
        cfg_on = pp._cfg_on_steps()
        np.testing.assert_array_equal(cfg_on, jp._cfg_on_steps())
    skip = lambda *a: None
    assert (psamplers._alpha_segments(pp.tables, skip, cfg_on)
            == jsamplers._alpha_segments(jp.tables, skip, cfg_on))
    assert (psamplers._alpha_segments(pp.tables, None)
            == jsamplers._alpha_segments(jp.tables, None))


def test_unet_encoder_cache_round_trip(models, rng):
    """A propagated forward on the key forward's own inputs equals the full
    forward to 1e-4; on another latent it reads the cache, as the JAX
    package's does."""
    jm, pm = models
    cfg, b = pm.unet_cfg, 2
    x = rng.standard_normal((b, 8, 8, 4)).astype(np.float32)
    t = np.asarray([5, 9])
    ctx = rng.standard_normal((b, 7, cfg.context_dim)).astype(np.float32)
    boxes, masks = np.zeros((b, 30, 4), np.float32), np.zeros((b, 30), np.float32)
    boxes[:, 0], masks[:, 0] = [0.1, 0.2, 0.6, 0.7], 1.0
    pos = rng.standard_normal((b, 30, cfg.grounding_in_dim)).astype(np.float32)
    rel = rng.standard_normal((b, 5, cfg.context_dim)).astype(np.float32)
    rest = [torch.from_numpy(a) for a in (t, ctx, boxes, masks, pos, rel)]
    run = lambda z, **kw: unet_apply(pm.unet_params, cfg,
                                     nhwc_to_nchw(torch.from_numpy(z)), *rest, **kw)
    with torch.no_grad():
        full = run(x)
        key, cache = run(x, return_encoder_cache=True)
        prop = run(x, encoder_cache=cache)
        other = run(x + 1.0, encoder_cache=cache)
    torch.testing.assert_close(key, full, rtol=0, atol=0)
    assert float((prop - full).abs().max()) <= 1e-4
    assert len(cache["hs"]) == len(input_block_specs(cfg))
    jargs = [jnp.asarray(a) for a in (t, ctx, boxes, masks, pos, rel)]

    @jax.jit
    def jax_propagated(z, z_other):
        _, jcache = jax_unet_apply(jm.unet_params, jm.unet_cfg, z, *jargs,
                                   return_encoder_cache=True)
        return jax_unet_apply(jm.unet_params, jm.unet_cfg, z_other, *jargs,
                              encoder_cache=jcache)

    want = jax_propagated(jnp.asarray(x), jnp.asarray(x + 1.0))
    np.testing.assert_allclose(nchw_to_nhwc(other).numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    # the latent enters through the encoder alone: on another latent the
    # propagated forward is the cached latent's, not its own
    assert float((other - full).abs().max()) <= 1e-4
    with torch.no_grad():
        assert float((other - run(x + 1.0)).abs().max()) > 1e-3


def test_propagated_step_without_its_cache_raises(models, conds):
    pm = models[1]
    dn = pinf.make_cfg_denoiser(pm, 7.5)
    cond = dict(conds[1])
    x = nhwc_to_nchw(torch.from_numpy(noise()))
    t = torch.full((2,), 981)
    with pytest.raises(RuntimeError, match="none"):
        dn(pm.unet_params, None, cond, x, t, 1.0, False, cache=None, is_key=False)
    _, cache = pinf.make_cfg_denoiser(pm, 7.5, cfg_override=False)(
        pm.unet_params, None, cond, x, t, 1.0, False, cache=None, is_key=True)
    with pytest.raises(RuntimeError, match="batch 2"):
        dn(pm.unet_params, None, cond, x, t, 1.0, False, cache=cache, is_key=False)
    with pytest.raises(ValueError, match="eta"):
        InferencePipeline(pm, steps=4, sampler="dpm", eta=0.5).run_sampler(
            conds[1], noise())
    with pytest.raises(ValueError, match="sampler"):
        InferencePipeline(pm, sampler="euler")


@pytest.mark.parametrize("spec", [
    "0.1,0.9", (0.0, 0.75), [0.25, 1.0], None, "", "0.9,0.1", "0.5,0.5",
    "-0.1,0.5", "a,b", "0.1", "0.1,0.2,0.3", (0.3,)])
def test_parse_cfg_interval_matches_jax(spec):
    try:
        want = jinf.parse_cfg_interval(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pinf.parse_cfg_interval(spec)
        assert str(got.value) == str(e)
    else:
        assert pinf.parse_cfg_interval(spec) == want


def _ns(**kw):
    base = dict(sampler="plms", steps=None, cfg_interval=None, cache_encoder=0,
                int8=False)
    base.update(kw)
    return argparse.Namespace(**base)


def test_fast_preset_is_the_jax_packages():
    assert (presets.FAST_SAMPLER, presets.FAST_STEPS, presets.FAST_CFG_INTERVAL,
            presets.FAST_CACHE_ENCODER) == (
        jpresets.FAST_SAMPLER, jpresets.FAST_STEPS, jpresets.FAST_CFG_INTERVAL,
        jpresets.FAST_CACHE_ENCODER)
    assert presets.fast_cfg_interval_str() == jpresets.fast_cfg_interval_str()
    assert (pinf.parse_cfg_interval(presets.fast_cfg_interval_str())
            == presets.FAST_CFG_INTERVAL)


@pytest.mark.parametrize("kw", [
    {}, dict(cache_encoder=3), dict(sampler="ddim"), dict(steps=30),
    dict(cfg_interval="0.2,0.9"),
    dict(sampler="ddim", steps=13, cfg_interval="0.2,0.9", cache_encoder=3)])
def test_apply_fast_preset_semantics(kw):
    """--fast fills in the preset's pieces, never a flag passed explicitly,
    and never int8; the same namespace as the JAX package's function."""
    got = vars(presets.apply_fast_preset(_ns(**kw)))
    assert got == vars(jpresets.apply_fast_preset(_ns(**kw)))
    assert got["int8"] is False
    for key, value in kw.items():
        assert got[key] == value
    if "sampler" not in kw:
        assert got["sampler"] == "dpm"
        assert got["steps"] == kw.get("steps", presets.FAST_STEPS)
