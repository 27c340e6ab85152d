"""Weights bridge: the JAX package's parameter trees -> torch state_dicts.

The JAX trees are nested dicts keyed by the reference torch names, with
NumPy leaves in the TPU layouts (conv HWIO, linear (in, out)); this undoes
layoutllm_t2i_tpu/checkpoint/convert.py:34-41. It takes NumPy arrays only,
so the port never imports JAX. An int8 leaf of the JAX package's
``quantize_params`` (its ``QuantTensor`` after a NumPy ``tree_map``: an
object with ``.q``, ``.scale`` and ``.dtype``) crosses as the port's
``QuantTensor``: q transposed as the dense weight would be, the scale, per
output channel in both layouts, as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..ops.quant import QuantTensor, place
from ..utils.trees import ParamTree, flatten_tree, unflatten_tree

# names whose 2-D weights are lookup tables, not nn.Linear kernels
_EMBEDDING_SUFFIXES = (
    "token_embedding.weight",
    "position_embedding.weight",
)


def torch_layout(name: str, a) -> np.ndarray:
    """The JAX leaf ``name`` as a NumPy view in the torch layout (no copy)."""
    a = np.asarray(a)
    if a.ndim == 4:  # conv HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if (a.ndim == 2 and name.split(".")[-1] == "weight"
            and not name.endswith(_EMBEDDING_SUFFIXES)):
        return a.T  # linear (in, out) -> (out, in)
    return a  # 0-D and 1-D tensors and embedding tables stay as they are


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _is_jax_quantized(a) -> bool:
    return hasattr(a, "q") and hasattr(a, "scale")


def tensor_from_jax(name: str, a):
    """A JAX leaf as a torch tensor in the torch layout, or an int8 leaf as
    a QuantTensor."""
    if _is_jax_quantized(a):
        q = np.asarray(a.q)
        if q.ndim not in (2, 4) or name.endswith(_EMBEDDING_SUFFIXES):
            raise ValueError(f"{name}: an int8 leaf must be a linear or conv "
                             "kernel, whose output channel the layout moves "
                             "to axis 0")
        return QuantTensor(tensor_from_jax(name, q),
                           torch.from_numpy(np.array(a.scale, np.float32)),
                           _TORCH_DTYPES[np.dtype(a.dtype).name])
    # np.array keeps a 0-D leaf 0-D (np.ascontiguousarray would make it 1-D)
    return torch.from_numpy(np.array(torch_layout(name, a), order="C"))


def state_dict_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested JAX parameter tree -> flat torch state_dict (reference names;
    an int8 leaf becomes a QuantTensor, which ``param_tree_from_jax`` takes
    and ``load_state_dict`` does not)."""
    return {name: tensor_from_jax(name, a)
            for name, a in flatten_tree(tree).items()}


def load_from_jax(module: ParamTree, tree: Dict[str, Any]) -> ParamTree:
    """Copy a JAX tree into ``module`` (strict: every name must match)."""
    module.load_state_dict(state_dict_from_jax(tree), strict=True)
    return module


def port_config(cls, cfg):
    """A JAX package config dataclass -> the port's ``cls`` with the same
    field values. A field the port lacks must sit at its JAX default: the
    port does not run what it would switch on."""
    values = dataclasses.asdict(cfg)
    names = {f.name for f in dataclasses.fields(cls)}
    defaults = dataclasses.asdict(type(cfg)())
    extra = {k: v for k, v in values.items()
             if k not in names and v != defaults[k]}
    if extra:
        raise NotImplementedError(f"{type(cfg).__name__} options not ported: {extra}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in values.items() if k in names})


def gligen_models_from_jax(m: Dict[str, Any], tokenizer, device=None,
                           dtype: torch.dtype = torch.float32):
    """The JAX package's model dict (unet_cfg, unet_params, vae_cfg,
    vae_params, clip_cfg, clip_params, schedule; the DiffusionTrainer's
    ``models`` argument) -> a port GligenModels on ``device``. The
    schedule's arrays are copied as they are; ``tokenizer`` is the port's
    own."""
    from ..models.clip_text import CLIPTextConfig
    from ..models.unet import UNetConfig
    from ..models.vae import VAEConfig
    from ..ops.schedules import DDPMSchedule
    from ..pipeline.inference import GligenModels

    sched = m["schedule"]
    return GligenModels(
        unet_cfg=port_config(UNetConfig, m["unet_cfg"]),
        unet_params=param_tree_from_jax(m["unet_params"], device, dtype),
        vae_cfg=port_config(VAEConfig, m["vae_cfg"]),
        vae_params=param_tree_from_jax(m["vae_params"], device, dtype),
        clip_cfg=port_config(CLIPTextConfig, m["clip_cfg"]),
        clip_params=param_tree_from_jax(m["clip_params"], device, dtype),
        schedule=DDPMSchedule(*(np.asarray(a, np.float32) for a in sched)),
        tokenizer=tokenizer, compute_dtype=dtype, device=device)


def param_tree_from_jax(tree: Dict[str, Any], device=None,
                        dtype: torch.dtype = torch.float32) -> ParamTree:
    """A ParamTree holding a JAX tree's weights in the torch layouts; an
    int8 leaf keeps its int8 values and f32 scales, with ``dtype`` as its
    logical dtype."""
    return ParamTree(unflatten_tree(
        {name: place(t, device, dtype)
         for name, t in state_dict_from_jax(tree).items()}))


def _strict_tree(init_tree, tree: Dict[str, Any], device, dtype) -> ParamTree:
    """A ParamTree of ``init_tree``'s names and shapes (meta tensors)
    holding the JAX ``tree``: a missing, extra or misshapen leaf raises."""
    module = ParamTree(init_tree)
    module.load_state_dict(state_dict_from_jax(tree), strict=True, assign=True)
    return module.to(device=device, dtype=dtype)


def policy_params_from_jax(tree: Dict[str, Any], device=None,
                           dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX package's policy tree (models/policy.py init_policy_params:
    ``{"linear": {"weight" (in, out), "bias"}}``) as the port's, strictly."""
    from ..models.initializers import Init
    from ..models.policy import init_policy_params

    din, dout = np.shape(tree["linear"]["weight"])
    meta = Init(None, torch.device("meta"))
    return _strict_tree(init_policy_params(meta, din, dout), tree, device, dtype)


def aesthetic_params_from_jax(tree: Dict[str, Any], device=None,
                              dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX package's aesthetic predictor tree (``layers.{0,2,4,6,8}``)
    as the port's, strictly."""
    from ..models.initializers import Init
    from ..models.policy import init_aesthetic_params

    din = np.shape(tree["layers"]["0"]["weight"])[0]
    meta = Init(None, torch.device("meta"))
    return _strict_tree(init_aesthetic_params(meta, din), tree, device, dtype)


def clip_vision_params_from_jax(tree: Dict[str, Any], cfg, device=None,
                                dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX package's CLIP vision tree (models/clip_vision.py
    init_clip_vision_params, with ``visual_projection``) as the port's for
    ``cfg`` (models/clip_vision.py CLIPVisionConfig), strictly: the patch
    conv HWIO -> OIHW, the linears (in, out) -> (out, in)."""
    from ..models.clip_vision import init_clip_vision_params
    from ..models.initializers import Init

    meta = Init(None, torch.device("meta"))
    return _strict_tree(init_clip_vision_params(meta, cfg), tree, device, dtype)


def clip_text_params_from_jax(tree: Dict[str, Any], cfg, device=None,
                              dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX package's CLIP text tree with its ``text_projection`` (the
    reward's and txt2img's projected get_text_features) as the port's for
    ``cfg`` (models/clip_text.py CLIPTextConfig), strictly."""
    from ..models.clip_text import init_clip_text_params
    from ..models.initializers import Init, linear_p

    din, dout = np.shape(tree["text_projection"]["weight"])
    meta = Init(None, torch.device("meta"))
    init_tree = init_clip_text_params(meta, cfg)
    init_tree["text_projection"] = linear_p(meta, din, dout, bias=False)
    return _strict_tree(init_tree, tree, device, dtype)


def inception_params_from_jax(tree: Dict[str, Any], device=None,
                              dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX package's InceptionV3 tree (eval/fid.py
    init_inception_params, or load_inception_checkpoint's: convs HWIO, BN
    leaves 1-D) as the port's eval/fid.py tree, strictly: convs OIHW under
    the same torchvision names."""
    from ..eval.fid import init_inception_params
    from ..models.initializers import Init

    meta = Init(None, torch.device("meta"))
    return _strict_tree(init_inception_params(meta), tree, device, dtype)


def unet_params_from_jax(tree: Dict[str, Any], cfg, device=None,
                         dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX package's UNet tree for the port's ``cfg`` (models/unet.py
    UNetConfig), strictly: every grounding tokenizer's subtree (ConvNeXt's
    depthwise (7, 7, 1, C) kernels as (C, 1, 7, 7), ``pos_embedding`` as it
    is), the gatedSA2 and gatedCA fusers, and a ``downsample_net`` where
    the tree has one."""
    from ..models.initializers import Init
    from ..pipeline.loaders import unet_init_tree

    meta = Init(None, torch.device("meta"))
    init_tree = unet_init_tree(meta, cfg, "downsample_net" in tree)
    return _strict_tree(init_tree, tree, device, dtype)


def resnet_params_from_jax(tree: Dict[str, Any], cfg, device=None,
                           dtype: torch.dtype = torch.float32) -> ParamTree:
    """The JAX package's ResNet tree (models/resnet.py init_resnet_params)
    for ``cfg``, strictly: convs OIHW, the BatchNorms' running statistics
    as the parameters beside them."""
    from ..models.initializers import Init
    from ..models.resnet import init_resnet_params

    meta = Init(None, torch.device("meta"))
    return _strict_tree(init_resnet_params(meta, cfg), tree, device, dtype)
