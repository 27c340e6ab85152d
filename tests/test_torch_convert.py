"""The port's ``.pth`` loaders against the JAX package's on the CPU.

Tiny reference-format GLIGEN checkpoints are written by the port's
exporter (checkpoint/export.py) and by the JAX package's; each is read by
both loaders, and the port's parameters must equal the JAX tree carried
through ``state_dict_from_jax`` exactly. Also: the official SD format's
prefix split, the SD first-conv and bare-linear files, ``grow_first_conv``,
the configs read from a checkpoint's config_dict, the strict name check,
and a DiffusionTrainer started from ``ckpt_path``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from layoutllm_t2i_tpu.checkpoint import convert as jconvert
from layoutllm_t2i_tpu.checkpoint import tools as jtools
from layoutllm_t2i_tpu.checkpoint.export import export_gligen_checkpoint as jax_export
from layoutllm_t2i_tpu.pipeline import loaders as jloaders
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models

from layoutllm_t2i_torch.checkpoint import convert, tools
from layoutllm_t2i_torch.checkpoint.export import export_gligen_checkpoint
from layoutllm_t2i_torch.checkpoint.from_jax import load_from_jax, state_dict_from_jax
from layoutllm_t2i_torch.pipeline import loaders
from layoutllm_t2i_torch.pipeline.loaders import random_models
from layoutllm_t2i_torch.training.diffusion_trainer import DiffusionTrainer, TrainerConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MODULES = (("unet", "unet_params"), ("vae", "vae_params"),
           ("clip_text", "clip_params"))


@pytest.fixture(scope="module")
def jm():
    return jax_random_models(seed=0, small=True)


def _config_dict(m):
    return {"name": "tiny", **{key: dataclasses.asdict(getattr(m, key))
                               for key in ("unet_cfg", "vae_cfg", "clip_cfg")}}


@pytest.fixture(scope="module")
def files(jm, tmp_path_factory):
    """{'jax': path, 'port': path}: the same weights written by each
    exporter."""
    d = tmp_path_factory.mktemp("ckpt")
    pm = random_models(small=True, device="cpu", seed=3)
    for module, attr in MODULES:
        load_from_jax(getattr(pm, attr), getattr(jm, attr))
    jax_export(str(d / "jax.pth"), jm.unet_params, jm.vae_params, jm.clip_params,
               jm.schedule, _config_dict(jm), iters=7)
    export_gligen_checkpoint(str(d / "port.pth"), pm.unet_params.state_dict(),
                             pm.vae_params.state_dict(),
                             pm.clip_params.state_dict(), pm.schedule,
                             _config_dict(jm), iters=7)
    return {"jax": str(d / "jax.pth"), "port": str(d / "port.pth")}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k].float(), v.float(), rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gligen_checkpoint_loads_like_the_jax_package(jm, files, writer):
    sds, config, extras = convert.load_gligen_checkpoint(files[writer])
    jparams, jconfig, jextras = jconvert.load_gligen_checkpoint(files[writer])
    assert config == jconfig and extras == jextras == {"iters": 7}
    for module, attr in MODULES:
        want = state_dict_from_jax(getattr(jm, attr))
        _assert_same(sds[module], want)
        _assert_same(state_dict_from_jax(jparams[module]), want)

    models = loaders.load_models_from_gligen_ckpt(files[writer], device="cpu")
    jmodels = jloaders.load_models_from_gligen_ckpt(files[writer])
    for module, attr in MODULES:
        _assert_same(getattr(models, attr).state_dict(),
                     state_dict_from_jax(getattr(jmodels, attr)))
    for key in ("unet_cfg", "vae_cfg", "clip_cfg"):
        assert (dataclasses.asdict(getattr(models, key)).items()
                <= dataclasses.asdict(getattr(jmodels, key)).items()), key
    for a, b in zip(models.schedule, jmodels.schedule):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert models.device == torch.device("cpu")
    assert models.compute_dtype == torch.float32
    assert not any(p.requires_grad for p in models.unet_params.parameters())


def test_loader_casts_and_checks_names(files, tmp_path):
    models = loaders.load_models_from_gligen_ckpt(files["port"], device="cpu",
                                                  dtype=torch.bfloat16)
    assert {p.dtype for p in models.unet_params.parameters()} == {torch.bfloat16}
    saved = torch.load(files["port"], weights_only=False)
    for broken in ("missing", "extra", "shape"):
        ckpt = dict(saved, model=dict(saved["model"]))
        name = "input_blocks.1.0.in_layers.2.weight"
        if broken == "missing":
            del ckpt["model"][name]
        elif broken == "extra":
            ckpt["model"]["input_blocks.1.0.unknown.weight"] = torch.zeros(3)
        else:
            ckpt["model"][name] = ckpt["model"][name][:, :-1]
        torch.save(ckpt, tmp_path / "broken.pth")
        with pytest.raises(RuntimeError, match="state_dict"):
            loaders.load_models_from_gligen_ckpt(str(tmp_path / "broken.pth"),
                                                 device="cpu")


@pytest.mark.parametrize("config", [
    None, {}, {"model": {"params": {"model_channels": 64, "num_heads": 4,
                                    "channel_mult": [1, 2],
                                    "attention_resolutions": [2]}},
               "diffusion": {"params": {"timesteps": 500,
                                        "linear_start": 0.001,
                                        "linear_end": 0.02}}},
    {"unet_cfg": {"model_channels": 32, "channel_mult": [1, 2],
                  "grounding_type": "box"}}])
def test_configs_from_config_dict_match_jax(config):
    got = dataclasses.asdict(loaders._unet_cfg_from_config_dict(config))
    want = dataclasses.asdict(jloaders._unet_cfg_from_config_dict(config))
    assert got.items() <= want.items()
    for a, b in zip(loaders._schedule_from_config_dict(config),
                    jloaders._schedule_from_config_dict(config)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # an inpainting checkpoint's config loads with inpaint_mode, as the JAX
    # loader reads it, and so does its fuser_type
    inpaint = {"model": {"params": {"inpaint_mode": True, "fuser_type": "gatedCA"}}}
    got = loaders._unet_cfg_from_config_dict(inpaint)
    assert got.inpaint_mode is True and got.fuser_type == "gatedCA"
    assert got.first_conv_in_channels == 9 and not got.first_conv_restorable
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jloaders._unet_cfg_from_config_dict(inpaint))


def test_official_sd_checkpoint_split(jm, tmp_path):
    flat = lambda tree, prefix: {prefix + k: v for k, v in tree.items()}
    unet = {k: v.float() for k, v in state_dict_from_jax(jm.unet_params).items()}
    vae = {k: v.float() for k, v in state_dict_from_jax(jm.vae_params).items()}
    clip = {k: v.float() for k, v in state_dict_from_jax(jm.clip_params).items()}
    sd = {**flat(unet, "model.diffusion_model."),
          **flat(vae, "first_stage_model."),
          **flat(clip, "cond_stage_model.transformer.text_model."),
          "cond_stage_model.transformer.text_model.embeddings.position_ids":
              torch.arange(77)[None],
          "model_ema.decay": torch.tensor(0.999), "betas": torch.ones(4)}
    torch.save({"state_dict": sd}, tmp_path / "sd.ckpt")
    raw = convert.read_official_sd_ckpt(str(tmp_path / "sd.ckpt"))
    jraw = jconvert.read_official_sd_ckpt(str(tmp_path / "sd.ckpt"))
    for key in jraw:
        assert set(raw[key]) == set(jraw[key]), key
    assert set(raw["diffusion"]) == {"betas"}
    got = convert.load_official_sd(str(tmp_path / "sd.ckpt"))
    want = jconvert.load_official_sd(str(tmp_path / "sd.ckpt"))
    for module, attr in MODULES:
        _assert_same(got[module], state_dict_from_jax(want[module]))
        _assert_same(got[module], state_dict_from_jax(getattr(jm, attr)))


def test_first_conv_and_linear_files(rng, tmp_path):
    conv = {"weight": torch.from_numpy(rng.standard_normal((32, 4, 3, 3)).astype(np.float32)),
            "bias": torch.from_numpy(rng.standard_normal(32).astype(np.float32))}
    lin = {"weight": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32)),
           "bias": torch.from_numpy(rng.standard_normal(7).astype(np.float32))}
    torch.save(conv, tmp_path / "conv.pth")
    torch.save(lin, tmp_path / "linear.pt")
    _assert_same(convert.load_sd_first_conv(str(tmp_path / "conv.pth")),
                 state_dict_from_jax(jconvert.load_sd_first_conv(str(tmp_path / "conv.pth"))))
    _assert_same(convert.load_torch_linear(str(tmp_path / "linear.pt")),
                 state_dict_from_jax(jconvert.load_torch_linear(str(tmp_path / "linear.pt"))))
    _assert_same(convert.load_torch_linear(str(tmp_path / "linear.pt")), lin)


def test_grow_first_conv_matches_jax(jm):
    got = tools.grow_first_conv(state_dict_from_jax(jm.unet_params), 5)
    want = state_dict_from_jax(jtools.grow_first_conv(jm.unet_params, 5))
    _assert_same(got, want)
    w = got["input_blocks.0.0.weight"]
    assert w.shape == (32, 9, 3, 3) and not w[:, 4:].any()


def test_trainer_starts_from_ckpt_path(files, tmp_path):
    cfg = TrainerConfig(output_root=str(tmp_path), name="ckpt", batch_size=2,
                        total_iters=1, warmup_steps=0, ckpt_path=files["port"])
    trainer = DiffusionTrainer(cfg, iter(()), device="cpu")
    try:
        want = loaders.load_models_from_gligen_ckpt(files["port"], device="cpu",
                                                    dtype=torch.float32)
        _assert_same(trainer.models.unet_params.state_dict(),
                     want.unet_params.state_dict())
        assert trainer.models.unet_cfg == want.unet_cfg
    finally:
        trainer.close()
