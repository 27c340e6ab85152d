"""Reference ``.pth`` checkpoints -> the port's state dicts
(layoutllm_t2i_tpu/checkpoint/convert.py, the ``.pth`` side).

Both reference formats:
  (a) the official SD single state_dict, split by key prefix
      (model.diffusion_model / cond_stage_model / first_stage_model,
      trainer.py:62-83);
  (b) the GLIGEN dict checkpoint {model, text_encoder, autoencoder,
      diffusion, opt, scheduler, iters, config_dict}, whose embedded config
      is the source of truth (trainer_combined_layout.py:523-535,
      interface.py:79).

The port's parameters carry the reference names and torch layouts, so
nothing is transposed: the state dicts load into the port's ParamTrees by
name with ``strict=True`` (pipeline/loaders.py). The text encoder's keys
lose the ``transformer.text_model.`` prefix of the reference's
FrozenCLIPEmbedder and its ``position_ids`` buffer. The files are read
with ``weights_only=False``: reference checkpoints pickle their config.
Load only files you trust.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

StateDict = Dict[str, torch.Tensor]
CLIP_PREFIX = "transformer.text_model."


def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def select(sd: Mapping[str, Any], strip_prefix: str = "") -> StateDict:
    """The entries of ``sd`` under ``strip_prefix``, without it, and without
    the non-parameter ``position_ids`` buffer of the HF text encoder."""
    out = {}
    for name, tensor in sd.items():
        if strip_prefix:
            if not name.startswith(strip_prefix):
                continue
            name = name[len(strip_prefix):]
        if not name.endswith("position_ids"):
            out[name] = tensor
    return out


def read_official_sd_ckpt(path: str) -> Dict[str, StateDict]:
    """Official SD ckpt -> {'model', 'text_encoder', 'autoencoder',
    'diffusion'} flat state dicts (prefix split as trainer.py:62-83)."""
    state_dict = _torch_load(path)["state_dict"]
    out = {"model": {}, "text_encoder": {}, "autoencoder": {}, "diffusion": {}}
    for k, v in state_dict.items():
        if k.startswith("model.diffusion_model"):
            out["model"][k.replace("model.diffusion_model.", "")] = v
        elif k.startswith("cond_stage_model"):
            out["text_encoder"][k.replace("cond_stage_model.", "")] = v
        elif k.startswith("first_stage_model"):
            out["autoencoder"][k.replace("first_stage_model.", "")] = v
        elif k in ("model_ema.decay", "model_ema.num_updates"):
            pass
        else:
            out["diffusion"][k] = v
    return out


def _modules(saved) -> Dict[str, StateDict]:
    return {
        "unet": select(saved["model"]),
        "vae": select(saved["autoencoder"]),
        "clip_text": select(saved["text_encoder"], strip_prefix=CLIP_PREFIX),
    }


def load_gligen_checkpoint(path: str):
    """GLIGEN dict ckpt -> (state dicts {'unet', 'vae', 'clip_text'},
    config_dict, extras {'iters'}). The embedded config_dict drives the
    model configs (pipeline/loaders.py)."""
    saved = _torch_load(path)
    config = saved.get("config_dict")
    if isinstance(config, dict) and "_content" in config:
        config = config["_content"]
    extras = {k: saved[k] for k in ("iters",) if k in saved}
    return _modules(saved), config, extras


def load_official_sd(path: str) -> Dict[str, StateDict]:
    """Official SD ckpt -> state dicts {'unet', 'vae', 'clip_text'}."""
    return _modules(read_official_sd_ckpt(path))


def load_sd_first_conv(path: str) -> StateDict:
    """SD_input_conv_weight_bias.pth -> {'weight' (OIHW), 'bias'}, the
    alpha == 0 first-conv restore (openaimodel.py:397-403)."""
    return dict(_torch_load(path))


def load_torch_linear(path: str) -> StateDict:
    """A bare nn.Linear state_dict (policy ckpt_E.pt files, train_rl.py:219):
    {'weight' (out, in), 'bias'}."""
    return dict(_torch_load(path))
