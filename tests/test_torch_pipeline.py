"""The port's generation slice end to end against the JAX InferencePipeline.

Small geometry (random_models(small=True)) with the JAX weights carried
across; the same prompts, layouts, relation texts and numpy noise go into
build_cond and sample_latents on both sides. PLMS with 4 steps and alpha
(0.5, 0, 0.5) runs the Heun warm start, AB2/AB3 and the skip-gated
segment. Gates are tests/parity_setup.py's: latent max |d| < 5e-3,
PSNR >= 35 dB, SSIM >= 0.98. Both tokenizers hash words with Python's
per-process salted ``hash`` when no CLIP merges file is present, so both
pipelines must tokenize in this one process.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.diffusion.samplers import plms_sample as jax_plms
from layoutllm_t2i_tpu.pipeline import inference as jinf
from layoutllm_t2i_tpu.pipeline.inference import (
    InferencePipeline as JaxPipeline, make_cfg_denoiser, precompute_grounding_tokens,
)
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models

from parity_setup import LATENT_GATE, PSNR_GATE_DB, SSIM_GATE, psnr, ssim

from layoutllm_t2i_torch.checkpoint.from_jax import load_from_jax
from layoutllm_t2i_torch.pipeline import inference as pinf
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.pipeline.loaders import random_models
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PROMPTS = ["a dog chasing a ball on the grass", "a cat sitting on a chair"]
LAYOUTS = [([[0.1, 0.4, 0.5, 0.9], [0.6, 0.6, 0.85, 0.85]], ["a dog", "a ball"]),
           ([[0.2, 0.1, 0.6, 0.6], [0.1, 0.4, 0.7, 0.95], [0.7, 0.1, 0.9, 0.7]],
            ["a cat", "a chair", "a lamp"])]
RELATIONS = [["dog chasing ball"], ["cat on chair", "lamp next to chair"]]
SAMPLE = dict(steps=4, guidance_scale=7.5, alpha_type=(0.5, 0.0, 0.5))


@pytest.fixture(scope="module")
def pipelines():
    jm = jax_random_models(seed=0, small=True)
    jm.unet_params["input_blocks"]["1"]["1"]["transformer_blocks"]["0"][
        "fuser"]["alpha_attn"] = np.asarray(0.6, np.float32)
    pm = random_models(small=True, device="cpu", seed=1)
    for name in ("unet_params", "vae_params", "clip_params"):
        load_from_jax(getattr(pm, name), getattr(jm, name))
    return JaxPipeline(jm, **SAMPLE), InferencePipeline(pm, **SAMPLE)


def test_pipeline_matches_jax(pipelines):
    jp, pp = pipelines
    noise = np.random.default_rng(7).standard_normal((2, 8, 8, 4)).astype(np.float32)
    cond_j = jp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    cond_p = pp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    for key in ("context", "uc_context", "phrase_embeddings", "relations"):
        np.testing.assert_allclose(cond_p[key].numpy(), np.asarray(cond_j[key]),
                                   atol=1e-4, rtol=1e-4, err_msg=key)

    # latents: the JAX sampler over its CFG denoiser, as _sample_fn runs it
    jm = jp.models
    core = make_cfg_denoiser(jm, SAMPLE["guidance_scale"])
    cj = dict(cond_j)
    cj["objs"] = precompute_grounding_tokens(jm, jm.unet_params, cj, True)
    z_j = jax.jit(lambda z: jax_plms(
        lambda x, t, f, u: core(jm.unet_params, None, cj, x, t, f, u),
        jp.tables, z, schedule=jm.schedule,
        denoise_skip_fn=lambda x, t, f, u: core(jm.unet_params, None, cj, x,
                                                t, f, u, skip_gated=True)))(
        jnp.asarray(noise))
    z_p = pp.run_sampler(cond_p, noise)
    lat_err = float(np.abs(z_p.numpy() - np.asarray(z_j)).max())
    assert lat_err < LATENT_GATE, lat_err

    img_j = np.asarray(jp.sample_latents(cond_j, jnp.asarray(noise)))
    img_p = pp.sample_latents(cond_p, noise).numpy()
    assert img_p.shape == img_j.shape == (2, 16, 16, 3)
    for a, b in zip(img_p, img_j):
        assert psnr(a, b) >= PSNR_GATE_DB
        assert ssim(a, b) >= SSIM_GATE


def test_generate_shape_and_range(pipelines):
    _, pp = pipelines
    img = pp.generate(PROMPTS, LAYOUTS, RELATIONS, seed=3)
    assert img.shape == (2, 16, 16, 3)
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    # the two requests are different images
    assert np.abs(img[0] - img[1]).max() > 1e-3
    assert torch.equal(torch.as_tensor(pp.tables.use_sd_conv),
                       torch.tensor([False, False, True, True]))


def test_host_helpers_match_jax(rng):
    emb = rng.standard_normal((3, 768)).astype(np.float32)
    boxes = [[0.1, 0.2, 0.5, 0.6], [0.0, 0.0, 1.0, 1.0], [0.3, 0.3, 0.4, 0.9]]
    for max_objs in (30, 2):
        for a, b in zip(pinf.pack_layout(boxes, emb, max_objs),
                        jinf.pack_layout(boxes, emb, max_objs)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pinf.pack_layout([], np.zeros((0, 768), np.float32)),
                    jinf.pack_layout([], np.zeros((0, 768), np.float32))):
        np.testing.assert_array_equal(a, b)
    box = [0.2, 0.3, 0.4, 0.5]
    assert pinf.convert_xywh_to_ltrb(box) == jinf.convert_xywh_to_ltrb(box)
    assert pinf.convert_xcycwh_to_ltrb(box) == jinf.convert_xcycwh_to_ltrb(box)
    img = rng.uniform(-0.2, 1.2, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(pinf.images_to_uint8(img), jinf.images_to_uint8(img))
