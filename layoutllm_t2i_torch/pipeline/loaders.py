"""Model-bundle loaders (layoutllm_t2i_tpu/pipeline/loaders.py).

``random_models`` builds the bundle with random weights from a seed, at the
full SD-1.4 geometry or the small smoke geometry, directly on the target
device in the compute dtype. No GLIGEN checkpoint is in the repository;
weights from the JAX package cross over through checkpoint/from_jax.py.
``quantize_unet_int8`` makes a bundle's UNet weight-only int8.
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
