"""The port at another latent size and head count than SD-1.4's defaults,
against the JAX package on the CPU.

SD-1.4 at 768^2 (``image_size`` 96) and a ``num_heads`` 5 GLIGEN config
reach head dims the kernels had not taken (160; 64 and 128). Both fields
come from a config: a JAX config dataclass through ``port_config``, a
reference GLIGEN ``.pth``'s config_dict (``model.params``) through
``load_models_from_gligen_ckpt``. Here a small geometry carries them:
16^2 latents (32^2 images through the small f2 VAE) and 4 heads. The
weights do not depend on either (inner = heads x d_head = channels), so
the JAX bundle's weights, written to a ``.pth`` by the JAX exporter, load
into the port's; the same prompts, layouts, relation texts and numpy noise
then go through both pipelines. Gates are tests/parity_setup.py's: latent
max |d| < 5e-3, PSNR >= 35 dB, SSIM >= 0.98.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.checkpoint.export import export_gligen_checkpoint as jax_export
from layoutllm_t2i_tpu.diffusion.samplers import plms_sample as jax_plms
from layoutllm_t2i_tpu.models.unet import UNetConfig as JaxUNetConfig
from layoutllm_t2i_tpu.pipeline import loaders as jloaders
from layoutllm_t2i_tpu.pipeline.inference import (
    InferencePipeline as JaxPipeline, make_cfg_denoiser, precompute_grounding_tokens,
)
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models

from parity_setup import LATENT_GATE, PSNR_GATE_DB, SSIM_GATE, psnr, ssim

from layoutllm_t2i_torch.checkpoint.from_jax import port_config
from layoutllm_t2i_torch.models.unet import UNetConfig
from layoutllm_t2i_torch.pipeline import loaders
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PROMPTS = ["a dog chasing a ball on the grass", "a cat sitting on a chair"]
LAYOUTS = [([[0.1, 0.4, 0.5, 0.9], [0.6, 0.6, 0.85, 0.85]], ["a dog", "a ball"]),
           ([[0.2, 0.1, 0.6, 0.6], [0.1, 0.4, 0.7, 0.95]], ["a cat", "a chair"])]
RELATIONS = [["dog chasing ball"], ["cat on chair"]]
SAMPLE = dict(steps=4, guidance_scale=7.5, alpha_type=(0.5, 0.0, 0.5))
GEOMETRY = dict(image_size=16, num_heads=4)


@pytest.mark.parametrize("geometry", [dict(image_size=96), dict(num_heads=5),
                                      dict(num_heads=1),
                                      dict(image_size=96, num_heads=1), GEOMETRY])
def test_port_config_passes_image_size_and_num_heads(geometry):
    jcfg = dataclasses.replace(JaxUNetConfig(), **geometry)
    cfg = port_config(UNetConfig, jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for key, value in geometry.items():
        assert getattr(cfg, key) == value


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(JAX bundle, port bundle): the JAX package's small random bundle at
    GEOMETRY (a gated alpha set to 0.6, which random init leaves 0),
    written by the JAX exporter to a reference-format .pth whose
    config_dict holds the UNet geometry in model.params, and loaded into
    the port by load_models_from_gligen_ckpt."""
    jm = jax_random_models(seed=0, small=True)
    jm = dataclasses.replace(jm, unet_cfg=dataclasses.replace(jm.unet_cfg, **GEOMETRY))
    jm.unet_params["input_blocks"]["1"]["1"]["transformer_blocks"]["0"][
        "fuser"]["alpha_attn"] = np.asarray(0.6, np.float32)
    u = jm.unet_cfg
    config = {"model": {"params": {
        "image_size": u.image_size, "model_channels": u.model_channels,
        "num_res_blocks": u.num_res_blocks,
        "attention_resolutions": list(u.attention_resolutions),
        "channel_mult": list(u.channel_mult), "num_heads": u.num_heads}},
        "vae_cfg": dataclasses.asdict(jm.vae_cfg),
        "clip_cfg": dataclasses.asdict(jm.clip_cfg)}
    path = str(tmp_path_factory.mktemp("geometry") / "gligen.pth")
    jax_export(path, jm.unet_params, jm.vae_params, jm.clip_params, jm.schedule,
               config, iters=0)
    pm = loaders.load_models_from_gligen_ckpt(path, device="cpu",
                                              dtype=torch.float32)
    jloaded = jloaders.load_models_from_gligen_ckpt(path)
    return jm, pm, jloaded


def test_gligen_config_dict_passes_image_size_and_num_heads(bundles):
    jm, pm, jloaded = bundles
    assert pm.unet_cfg.image_size == 16 and pm.unet_cfg.num_heads == 4
    assert dataclasses.asdict(pm.unet_cfg) == dataclasses.asdict(jloaded.unet_cfg)
    assert dataclasses.asdict(pm.unet_cfg) == dataclasses.asdict(jm.unet_cfg)


def test_pipeline_at_another_geometry_matches_jax(bundles):
    jm, pm, _ = bundles
    jp, pp = JaxPipeline(jm, **SAMPLE), InferencePipeline(pm, **SAMPLE)
    noise = np.random.default_rng(7).standard_normal((2, 16, 16, 4)).astype(np.float32)
    cond_j = jp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    cond_p = pp.build_cond(PROMPTS, LAYOUTS, RELATIONS)

    # latents: the JAX sampler over its CFG denoiser, as _sample_fn runs it
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
    assert z_p.shape == (2, 16, 16, 4)
    lat_err = float(np.abs(z_p.numpy() - np.asarray(z_j)).max())
    assert lat_err < LATENT_GATE, lat_err

    img_j = np.asarray(jp.sample_latents(cond_j, jnp.asarray(noise)))
    img_p = pp.sample_latents(cond_p, noise).numpy()
    assert img_p.shape == img_j.shape == (2, 32, 32, 3)
    for a, b in zip(img_p, img_j):
        assert psnr(a, b) >= PSNR_GATE_DB
        assert ssim(a, b) >= SSIM_GATE
    # generate samples at the config's latent size
    assert pp.generate(PROMPTS, LAYOUTS, RELATIONS, seed=3).shape == (2, 32, 32, 3)


@pytest.mark.parametrize("num_heads", [1, 2, 4])
def test_gligen_config_dict_num_heads_reaches_the_trainer(tmp_path, monkeypatch,
                                                          num_heads):
    """train_diffusion --ckpt_path on a reference-format .pth whose
    config_dict says num_heads 2 (model.params): the trainer's step runs
    the UNet at 2 heads, as chip_smoke.py's train-ckpt does at full width
    (K5 at d 160 and 320). Here the small bundle through --small, one step
    on the CPU; 4 heads too, since the small config's own count is 2 (and
    a config_dict without the field gives the reference's 8)."""
    from layoutllm_t2i_torch.checkpoint.export import export_gligen_checkpoint
    from layoutllm_t2i_torch.cli import train_diffusion

    pm = loaders.random_models(small=True, device="cpu", dtype=torch.float32,
                               seed=0)
    u = pm.unet_cfg
    config = {"model": {"params": {
        "image_size": u.image_size, "model_channels": u.model_channels,
        "num_res_blocks": u.num_res_blocks,
        "attention_resolutions": list(u.attention_resolutions),
        "channel_mult": list(u.channel_mult), "num_heads": num_heads}},
        "vae_cfg": dataclasses.asdict(pm.vae_cfg),
        "clip_cfg": dataclasses.asdict(pm.clip_cfg)}
    path = str(tmp_path / f"gligen_heads{num_heads}.pth")
    export_gligen_checkpoint(path, pm.unet_params.state_dict(),
                             pm.vae_params.state_dict(),
                             pm.clip_params.state_dict(), pm.schedule, config)
    seen = []

    class Recording(train_diffusion.DiffusionTrainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self.step_cfg.unet_cfg)

    monkeypatch.setattr(train_diffusion, "DiffusionTrainer", Recording)
    train_diffusion.main(["--small", "--synthetic", "--device", "cpu",
                          "--ckpt_path", path, "--batch_size", "2",
                          "--total_iters", "1", "--warmup_steps", "0",
                          "--output_root", str(tmp_path), "--name", "run"])
    assert len(seen) == 1
    assert dataclasses.asdict(seen[0]) == dataclasses.asdict(
        dataclasses.replace(u, num_heads=num_heads))
    del config["model"]["params"]["num_heads"]
    assert loaders._unet_cfg_from_config_dict(config).num_heads == 8
