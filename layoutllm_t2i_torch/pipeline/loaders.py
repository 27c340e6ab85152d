"""Model-bundle loaders (layoutllm_t2i_tpu/pipeline/loaders.py).

``load_models_from_gligen_ckpt`` builds the bundle from a reference GLIGEN
``.pth`` (interface.py:366-374), its embedded config the source of truth;
``random_models`` builds it with random weights from a seed, at the full
SD-1.4 geometry or the small smoke geometry, directly on the target device
in the compute dtype. Weights from the JAX package's trees cross over
through checkpoint/from_jax.py. ``quantize_unet_int8`` makes a bundle's UNet
weight-only int8; ``adapt_models_for_modality`` re-shapes a box + text
bundle for another GLIGEN modality.
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
from ..utils.trees import ParamTree, replace_subtree
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
        inpaint_mode=p.get("inpaint_mode", False),
    )


def _schedule_from_config_dict(config: Optional[dict]):
    try:
        p = config["diffusion"]["params"]
        return make_ddpm_schedule(
            "linear", p.get("timesteps", 1000),
            p.get("linear_start", 0.00085), p.get("linear_end", 0.012))
    except (KeyError, TypeError):
        return make_ddpm_schedule("linear", 1000, 0.00085, 0.012)


def unet_init_tree(ini: Init, cfg: UNetConfig, downsampler: bool = False):
    """``init_unet_params``'s tree, with a map modality's grounding
    downsampler (``downsample_net``, ``cfg.additional_in_channels`` out)
    where ``downsampler``: adapt_models_for_modality adds it beside the
    UNet's own parameters, as the JAX package does."""
    from ..models.grounding_extras import init_grounding_downsampler

    tree = init_unet_params(ini, cfg)
    if downsampler:
        tree["downsample_net"] = init_grounding_downsampler(
            ini, cfg.additional_in_channels)
    return tree


def _load_strict(init_fn, cfg, sd, device: torch.device,
                 dtype: torch.dtype) -> ParamTree:
    """A ParamTree of ``cfg``'s geometry holding ``sd``: every reference
    name must be there and nothing else (``strict=True``), at its shape.
    A UNet's ``downsample_net`` is taken where ``sd`` has one."""
    if init_fn is init_unet_params:
        downsampler = any(k.startswith("downsample_net.") for k in sd)
        init_fn = lambda ini, c: unet_init_tree(ini, c, downsampler)
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


MAP_MODALITIES = ("canny", "hed", "depth", "normal", "sem")


def adapt_models_for_modality(models: GligenModels, modality: str,
                              seed: int = 0, downsampler_out: int = 8,
                              max_persons: int = 8) -> GligenModels:
    """A box + text bundle re-shaped for another GLIGEN modality
    (layoutllm_t2i_tpu/pipeline/loaders.py:140-190; reference
    gligen_inference.py:199-342 loads one checkpoint a modality): the
    grounding tokenizer, the first conv and the map modalities' grounding
    downsampler are initialised afresh (torch generator seeded with
    ``seed``, on the bundle's device and dtype) where the bundle does not
    carry them, the relation layer is turned off (upstream GLIGEN
    checkpoints have no rela_fuse) and the SD first-conv restore is
    dropped, as it cannot apply over extra input channels.

    Map modalities (canny/hed/depth/normal/sem): the ConvNeXt tokenizer and
    ``downsampler_out`` extra input channels; keypoint: the 17-point person
    tokenizer for ``max_persons``; text_image: the text + image tokenizer.
    box_text returns the bundle as it is."""
    from ..models.grounding_extras import init_grounding_downsampler
    from ..models.initializers import conv_p
    from ..models.unet import init_position_net_for

    if modality in MAP_MODALITIES:
        new_cfg = dataclasses.replace(
            models.unet_cfg, grounding_type="map",
            additional_in_channels=downsampler_out,
            use_relation_attention=False)
    elif modality == "keypoint":
        new_cfg = dataclasses.replace(
            models.unet_cfg, grounding_type="keypoint",
            max_persons_per_image=max_persons, use_relation_attention=False)
    elif modality == "text_image":
        new_cfg = dataclasses.replace(
            models.unet_cfg, grounding_type="text_image",
            use_relation_attention=False)
    else:
        return models

    gen = torch.Generator(device=models.device)
    gen.manual_seed(seed)
    ini = Init(gen, models.device, models.compute_dtype)
    params = models.unet_params
    old_cfg = models.unet_cfg
    if old_cfg.grounding_type != new_cfg.grounding_type:
        params = replace_subtree(params, ("position_net",),
                                 init_position_net_for(ini, new_cfg))
    if new_cfg.first_conv_in_channels != old_cfg.first_conv_in_channels:
        params = replace_subtree(
            params, ("input_blocks", "0", "0"),
            conv_p(ini, 3, 3, new_cfg.first_conv_in_channels,
                   new_cfg.model_channels))
    if modality in MAP_MODALITIES and "downsample_net" not in params:
        params = replace_subtree(params, ("downsample_net",),
                                 init_grounding_downsampler(ini, downsampler_out))
    return dataclasses.replace(models, unet_cfg=new_cfg, unet_params=params,
                               sd_first_conv=None)
