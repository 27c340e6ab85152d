"""Reference ``.pth`` checkpoints -> the port's state dicts
(layoutllm_t2i_tpu/checkpoint/convert.py, the ``.pth`` side): GLIGEN and SD
checkpoints, a full CLIPModel's two towers, the aesthetic predictor, and
the RL policy's ``ckpt_E.pt`` / ``state_E.pt``.

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


def _clip_text_parts(sd: Mapping[str, Any]):
    """A full HF CLIPModel state_dict -> (its text tower's state dict with
    ``text_projection``, the CLIPTextConfig of its shapes, the port's tree
    of those names and shapes as meta tensors)."""
    from ..models.clip_text import init_clip_text_params
    from ..models.initializers import Init, linear_p

    text_sd = clip_text_model_state_dict(sd)
    cfg = clip_text_config_of(text_sd)
    proj_out, proj_in = text_sd[CLIP_PROJECTION].shape
    meta = Init(None, torch.device("meta"))
    tree = init_clip_text_params(meta, cfg)
    tree["text_projection"] = linear_p(meta, proj_in, proj_out, bias=False)
    return text_sd, cfg, tree


def _strict_module(tree, sd: Mapping[str, Any], device, dtype):
    """A ParamTree of ``tree``'s names and shapes (meta tensors) holding
    ``sd``: a missing, extra or misshapen tensor raises."""
    from ..utils.trees import ParamTree

    module = ParamTree(tree)
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device=device, dtype=dtype)


def load_clip_text_model(path: str, device=None, dtype=None):
    """A full HF CLIPModel ``.pth`` as (ParamTree of the text tower with
    ``text_projection``, CLIPTextConfig), loaded strictly by name, for
    models/clip_text.py clip_text_features (the projected
    get_text_features, reference txt2img.py:454-457)."""
    from ..device import default_dtype, resolve_device

    text_sd, cfg, tree = _clip_text_parts(_torch_load(path))
    dev = resolve_device(device)
    return _strict_module(tree, text_sd, dev, dtype or default_dtype(dev)), cfg


# a full HF CLIPModel's vision tower and its projection
CLIP_VISION_PREFIX = "vision_model."
CLIP_VISUAL_PROJECTION = "visual_projection.weight"


def clip_vision_model_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """A full HF CLIPModel state_dict -> its vision tower (``vision_model.*``,
    prefix kept, as models/clip_vision.py names it) and
    ``visual_projection.weight``, without the ``position_ids`` buffer."""
    out = {CLIP_VISION_PREFIX + k: v
           for k, v in select(sd, strip_prefix=CLIP_VISION_PREFIX).items()}
    out[CLIP_VISUAL_PROJECTION] = sd[CLIP_VISUAL_PROJECTION]
    return out


def clip_vision_config_of(sd: Mapping[str, Any]):
    """The CLIPVisionConfig whose tree has the shapes of ``sd`` (a
    clip_vision_model_state_dict): width and patch from the patch conv,
    image side from the position table, layers, MLP width and projection
    from the tensors, heads of CLIP_HEAD_DIM channels."""
    from ..models.clip_vision import CLIPVisionConfig

    emb = CLIP_VISION_PREFIX + "embeddings."
    c, _, patch, _ = sd[emb + "patch_embedding.weight"].shape
    positions = sd[emb + "position_embedding.weight"].shape[0]
    side = int(round((positions - 1) ** 0.5))
    layers_key = CLIP_VISION_PREFIX + "encoder.layers."
    layers = {int(k[len(layers_key):].split(".")[0]) for k in sd
              if k.startswith(layers_key)}
    return CLIPVisionConfig(
        image_size=side * patch, patch_size=patch, hidden_size=c,
        num_layers=len(layers), num_heads=max(c // CLIP_HEAD_DIM, 1),
        intermediate_size=sd[layers_key + "0.mlp.fc1.weight"].shape[0],
        projection_dim=sd[CLIP_VISUAL_PROJECTION].shape[0])


def load_clip_model(path: str, device=None, dtype=torch.float32):
    """A full HF CLIPModel ``.pth`` (the reward's ``--clip_ckpt``, JAX
    cli/train_rl.py:88-97) as (text ParamTree with ``text_projection``,
    CLIPTextConfig, vision ParamTree with ``visual_projection``,
    CLIPVisionConfig), each tower loaded strictly by name, in f32 by
    default, as the reward runs them."""
    from ..device import resolve_device
    from ..models.clip_vision import init_clip_vision_params
    from ..models.initializers import Init

    sd = _torch_load(path)
    dev = resolve_device(device)
    text_sd, text_cfg, text_tree = _clip_text_parts(sd)
    vision_sd = clip_vision_model_state_dict(sd)
    vision_cfg = clip_vision_config_of(vision_sd)
    vision_tree = init_clip_vision_params(Init(None, torch.device("meta")),
                                          vision_cfg)
    return (_strict_module(text_tree, text_sd, dev, dtype), text_cfg,
            _strict_module(vision_tree, vision_sd, dev, dtype), vision_cfg)


def load_aesthetic(path: str, device=None, dtype=torch.float32):
    """The LAION aesthetic predictor's ``.pth`` (``layers.{0,2,4,6,8}``,
    tools/aesthetic.py; the reward's ``--aesthetic_ckpt``) as a ParamTree,
    strictly by name."""
    from ..device import resolve_device
    from ..models.initializers import Init
    from ..models.policy import init_aesthetic_params

    sd = _torch_load(path)
    meta = Init(None, torch.device("meta"))
    tree = init_aesthetic_params(meta, sd["layers.0.weight"].shape[1])
    return _strict_module(tree, sd, resolve_device(device), dtype)


def load_policy(path: str) -> Dict[str, StateDict]:
    """Reference ``ckpt_E.pt`` (train_rl.py:218-219, a bare nn.Linear
    state_dict) -> the policy tree ``{'linear': {'weight' (out, in),
    'bias' (out,)}}`` of models/policy.py, on the CPU."""
    return {"linear": load_torch_linear(path)}


def load_policy_state(path: str) -> Dict[str, Any]:
    """Reference ``state_E.pt`` (train_rl.py:220-222: {'optimizer': torch
    Adam's state_dict, 'lr_scheduler': StepLR's}) -> ``{'step': int, 'mu':
    tree, 'nu': tree, 'last_epoch': int}``, mu and nu (Adam's uncorrected
    first and second moments) in the policy tree's torch layout. Param ids
    follow nn.Linear.parameters() order: 0 = weight, 1 = bias."""
    saved = _torch_load(path)
    st = saved["optimizer"]["state"]
    mu = {"linear": {"weight": st[0]["exp_avg"], "bias": st[1]["exp_avg"]}}
    nu = {"linear": {"weight": st[0]["exp_avg_sq"],
                     "bias": st[1]["exp_avg_sq"]}}
    return {
        "step": int(float(st[0]["step"])),
        "mu": mu,
        "nu": nu,
        "last_epoch": int(saved.get("lr_scheduler", {}).get("last_epoch", -1)),
    }
