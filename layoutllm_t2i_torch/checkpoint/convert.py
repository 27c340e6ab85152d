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
# a full HF CLIPModel's text tower and its projection
CLIP_MODEL_PREFIX = "text_model."
CLIP_PROJECTION = "text_projection.weight"
# the width of a CLIP text head (ViT-L/14: 768 wide, 12 heads)
CLIP_HEAD_DIM = 64


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


def clip_text_model_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """A full HF CLIPModel state_dict -> its text tower (``text_model.*``,
    the prefix stripped) and ``text_projection.weight``; the vision tower,
    ``logit_scale`` and the ``position_ids`` buffer are left out."""
    out = select(sd, strip_prefix=CLIP_MODEL_PREFIX)
    out[CLIP_PROJECTION] = sd[CLIP_PROJECTION]
    return out


def clip_text_config_of(sd: Mapping[str, Any]):
    """The CLIPTextConfig whose tree has the shapes of ``sd`` (a
    clip_text_model_state_dict): width, vocabulary, context length, layers
    and MLP width from the tensors, heads of CLIP_HEAD_DIM channels."""
    from ..models.clip_text import CLIPTextConfig

    vocab, c = sd["embeddings.token_embedding.weight"].shape
    layers = {int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers.")}
    return CLIPTextConfig(
        vocab_size=vocab, hidden_size=c, num_layers=len(layers),
        num_heads=max(c // CLIP_HEAD_DIM, 1),
        intermediate_size=sd["encoder.layers.0.mlp.fc1.weight"].shape[0],
        max_length=sd["embeddings.position_embedding.weight"].shape[0])


def load_clip_text_model(path: str, device=None, dtype=None):
    """A full HF CLIPModel ``.pth`` as (ParamTree of the text tower with
    ``text_projection``, CLIPTextConfig), loaded strictly by name, for
    models/clip_text.py clip_text_features (the projected
    get_text_features, reference txt2img.py:454-457)."""
    from ..device import default_dtype, resolve_device
    from ..models.clip_text import init_clip_text_params
    from ..models.initializers import Init, linear_p
    from ..utils.trees import ParamTree

    sd = clip_text_model_state_dict(_torch_load(path))
    cfg = clip_text_config_of(sd)
    proj_out, proj_in = sd[CLIP_PROJECTION].shape
    meta = Init(None, torch.device("meta"))
    tree = init_clip_text_params(meta, cfg)
    tree["text_projection"] = linear_p(meta, proj_in, proj_out, bias=False)
    dev = resolve_device(device)
    module = ParamTree(tree)
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device=dev, dtype=dtype or default_dtype(dev)), cfg
