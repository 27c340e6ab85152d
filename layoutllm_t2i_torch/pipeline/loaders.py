"""Model-bundle loaders (layoutllm_t2i_tpu/pipeline/loaders.py).

``load_models_from_gligen_ckpt`` builds the bundle from a reference GLIGEN
``.pth`` (interface.py:366-374), its embedded config the source of truth;
``random_models`` builds it with random weights from a seed, at the full
SD-1.4 geometry or the small smoke geometry, directly on the target device
in the compute dtype. Weights from the JAX package's trees cross over
through checkpoint/from_jax.py. ``quantize_unet_int8`` makes a bundle's UNet
weight-only int8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import DeviceLike, default_dtype, resolve_device
from ..models.clip_text import CLIPTextConfig, init_clip_text_params
from ..models.clip_tokenizer import default_tokenizer
from ..models.initializers import Init
from ..models.unet import UNetConfig, init_unet_params
from ..models.vae import VAEConfig, init_vae_params
from ..ops.quant import quantize_params
from ..ops.schedules import make_ddpm_schedule
from ..utils.trees import ParamTree
from .inference import GligenModels

META = torch.device("meta")


def model_configs(small: bool = False):
    """(unet, vae, clip) configs: SD-1.4 geometry, or the small smoke
    geometry of the JAX package's random_models(small=True)."""
    if small:
        return (UNetConfig(image_size=8, model_channels=32, num_res_blocks=1,
                           attention_resolutions=(2, 1), channel_mult=(1, 2),
                           num_heads=2),
                VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
                CLIPTextConfig(num_layers=2))
    return UNetConfig(), VAEConfig(), CLIPTextConfig()


def _dataclass_from_dict(cls, d: dict):
    """``cls`` from a dict, keeping only its fields (configs written by the
    JAX package's trainer carry more) and re-tupling lists."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in fields})


def _unet_cfg_from_config_dict(config: Optional[dict]) -> UNetConfig:
    # the trainers embed the whole dataclass (diffusion_trainer.save_ckpt)
    if isinstance(config, dict) and isinstance(config.get("unet_cfg"), dict):
        return _dataclass_from_dict(UNetConfig, config["unet_cfg"])
    try:
        p = config["model"]["params"]
    except (KeyError, TypeError):
        return UNetConfig()
    if p.get("inpaint_mode", False):
        raise NotImplementedError("inpainting checkpoints are not ported "
                                  "(ROADMAP.md Queue 1)")
    return UNetConfig(
        image_size=p.get("image_size", 64),
        in_channels=p.get("in_channels", 4),
        model_channels=p.get("model_channels", 320),
        out_channels=p.get("out_channels", 4),
        num_res_blocks=p.get("num_res_blocks", 2),
        attention_resolutions=tuple(p.get("attention_resolutions", (4, 2, 1))),
        channel_mult=tuple(p.get("channel_mult", (1, 2, 4, 4))),
        num_heads=p.get("num_heads", 8),
        transformer_depth=p.get("transformer_depth", 1),
        context_dim=p.get("context_dim", 768),
        fuser_type=p.get("fuser_type", "gatedSA"),
    )


def _schedule_from_config_dict(config: Optional[dict]):
    try:
        p = config["diffusion"]["params"]
        return make_ddpm_schedule(
            "linear", p.get("timesteps", 1000),
            p.get("linear_start", 0.00085), p.get("linear_end", 0.012))
    except (KeyError, TypeError):
        return make_ddpm_schedule("linear", 1000, 0.00085, 0.012)


def _load_strict(init_fn, cfg, sd, device: torch.device,
                 dtype: torch.dtype) -> ParamTree:
    """A ParamTree of ``cfg``'s geometry holding ``sd``: every reference
    name must be there and nothing else (``strict=True``), at its shape."""
    tree = ParamTree(init_fn(Init(None, META), cfg))
    tree.load_state_dict(sd, strict=True, assign=True)
    return tree.to(device=device, dtype=dtype)


def load_models_from_gligen_ckpt(ckpt_path: str,
                                 sd_first_conv_path: Optional[str] = None,
                                 device: DeviceLike = None,
                                 dtype: Optional[torch.dtype] = None,
                                 tokenizer=None) -> GligenModels:
    """A reference GLIGEN dict checkpoint as a bundle on ``device`` (None:
    the card) in ``dtype`` (None: the device's default). Reference
    checkpoints pair SD's full-size CLIP and VAE (the default configs); the
    trainers' exports embed their module configs, so other geometries
    round-trip too."""
    from ..checkpoint.convert import load_gligen_checkpoint, load_sd_first_conv

    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    sds, config, _ = load_gligen_checkpoint(ckpt_path)
    cfg_of = lambda key, cls: (_dataclass_from_dict(cls, config[key])
                               if isinstance(config, dict)
                               and isinstance(config.get(key), dict) else cls())
    unet_cfg = _unet_cfg_from_config_dict(config)
    vae_cfg = cfg_of("vae_cfg", VAEConfig)
    clip_cfg = cfg_of("clip_cfg", CLIPTextConfig)
    sd_conv = None
    if sd_first_conv_path:
        sd_conv = {k: v.to(dev) for k, v in
                   load_sd_first_conv(sd_first_conv_path).items()}
    return GligenModels(
        unet_cfg=unet_cfg,
        unet_params=_load_strict(init_unet_params, unet_cfg, sds["unet"], dev, dtype),
        vae_cfg=vae_cfg,
        vae_params=_load_strict(init_vae_params, vae_cfg, sds["vae"], dev, dtype),
        clip_cfg=clip_cfg,
        clip_params=_load_strict(init_clip_text_params, clip_cfg,
                                 sds["clip_text"], dev, dtype),
        schedule=_schedule_from_config_dict(config),
        tokenizer=tokenizer or default_tokenizer(),
        sd_first_conv=sd_conv,
        compute_dtype=dtype,
        device=dev,
    )


def random_models(small: bool = False, device: DeviceLike = None,
                  dtype: Optional[torch.dtype] = None,
                  seed: int = 0) -> GligenModels:
    """Random-weight bundle for smoke and bench runs (torch generator)."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ini = Init(gen, dev, dtype)
    unet_cfg, vae_cfg, clip_cfg = model_configs(small)
    return GligenModels(
        unet_cfg=unet_cfg,
        unet_params=ParamTree(init_unet_params(ini, unet_cfg)),
        vae_cfg=vae_cfg,
        vae_params=ParamTree(init_vae_params(ini, vae_cfg)),
        clip_cfg=clip_cfg,
        clip_params=ParamTree(init_clip_text_params(ini, clip_cfg)),
        schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012),
        tokenizer=default_tokenizer(),
        compute_dtype=dtype,
        device=dev,
    )


def quantize_unet_int8(models: GligenModels,
                       min_size: int = 1 << 16) -> GligenModels:
    """The bundle with a weight-only int8 UNet (ops/quant.py), as the JAX
    package's ``--int8`` entry points build it (loaders.py:193): every UNet
    weight of ndim >= 2 and at least ``min_size`` elements; the VAE and
    CLIP stay dense. Opt-in; LLT2I_FFN_INT8=1 then routes its LN + FF
    sites to K7."""
    return dataclasses.replace(
        models, unet_params=quantize_params(models.unet_params, min_size))
