"""CLIP ViT image encoder (layoutllm_t2i_tpu/models/clip_vision.py), for the
RL reward and CLIPScore.

Mirrors HF CLIPVisionModel (+ visual_projection): patch embedding, class
token, learned position embeddings, pre-LN ViT (no causal mask), post-
layernorm on the class token, linear projection to the shared space.
Parameters follow the HF ``vision_model.*`` state_dict names in the torch
layouts (the patch conv OIHW, linear weights (out, in)); images keep the
JAX package's NHWC layout at the public functions.

The reward runs this tower in f32: every LayerNorm goes through K3's f32
form (ops/nn.py layer_norm), the products through ``F.linear`` and
``torch.matmul`` in full f32 (PyTorch's default; no global flag is
changed here). The patch embedding is a reshape into patches plus one
product, not a convolution: cuDNN may run an f32 convolution in TF32.
Attention is a plain unmasked softmax over 257 tokens, as the JAX tower's
einsums are (its sites never reach the flash kernel).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops import nn
from . import initializers as init
from .clip_text import quick_gelu


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_images(images: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] -> normalized (B, S, S, 3), S =
    cfg.image_size. ``jax.image.resize(..., "bicubic")`` is antialiased
    (Keys' cubic, a = -0.5, stretched when it shrinks); PyTorch's bicubic
    matches it only with ``antialias=True``."""
    s = cfg.image_size
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(s, s), mode="bicubic",
                      antialias=True, align_corners=False).permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _attn(p, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    hd = c // num_heads
    q = nn.linear(p["q_proj"], x) * (hd ** -0.5)
    k = nn.linear(p["k_proj"], x)
    v = nn.linear(p["v_proj"], x)
    qh = q.reshape(b, n, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, n, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, n, num_heads, hd).transpose(1, 2)
    sim = torch.matmul(qh.float(), kh.float().transpose(-1, -2))  # f32 scores
    attn = torch.softmax(sim, dim=-1).to(x.dtype)
    out = torch.matmul(attn, vh)
    return nn.linear(p["out_proj"], out.transpose(1, 2).reshape(b, n, c))


def patch_embed(weight: torch.Tensor, pixel_values: torch.Tensor) -> torch.Tensor:
    """The stride-P, P x P, bias-free patch convolution as one product:
    (B, H, W, 3) NHWC pixels, an OIHW (C, 3, P, P) weight -> (B, (H/P)·(W/P),
    C) tokens in row-major patch order, as the JAX tower's conv output
    (B, H/P, W/P, C) flattens."""
    b, h, w, ci = pixel_values.shape
    c, _, p, _ = weight.shape
    if h % p or w % p:
        raise ValueError(f"patch_embed: {h}x{w} pixels are not whole "
                         f"{p}x{p} patches")
    gh, gw = h // p, w // p
    patches = (pixel_values.reshape(b, gh, p, gw, p, ci)
               .permute(0, 1, 3, 5, 2, 4)           # (B, gh, gw, ci, P, P)
               .reshape(b, gh * gw, ci * p * p))
    return torch.matmul(patches, weight.reshape(c, ci * p * p).t())


def clip_vision_apply(params, cfg: CLIPVisionConfig, pixel_values: torch.Tensor):
    """pixel_values: (B, S, S, 3) normalized NHWC. Returns (hidden (B, 1 +
    patches, C), pooled (B, C))."""
    vm = params["vision_model"]
    emb = vm["embeddings"]
    b = pixel_values.shape[0]
    dtype = pixel_values.dtype
    patches = patch_embed(nn.weight(emb["patch_embedding"], dtype), pixel_values)
    cls = emb["class_embedding"].to(dtype).reshape(1, 1, -1).expand(
        b, 1, cfg.hidden_size)
    x = torch.cat([cls, patches], dim=1)
    x = x + emb["position_embedding"]["weight"].to(dtype)[None, : x.shape[1]]
    x = nn.layer_norm(vm["pre_layrnorm"], x, cfg.layer_norm_eps)
    for i in range(cfg.num_layers):
        lyr = vm["encoder"]["layers"][str(i)]
        x = x + _attn(lyr["self_attn"],
                      nn.layer_norm(lyr["layer_norm1"], x, cfg.layer_norm_eps),
                      cfg.num_heads)
        h = nn.layer_norm(lyr["layer_norm2"], x, cfg.layer_norm_eps)
        h = nn.linear(lyr["mlp"]["fc2"], quick_gelu(nn.linear(lyr["mlp"]["fc1"], h)))
        x = x + h
    pooled = nn.layer_norm(vm["post_layernorm"], x[:, 0], cfg.layer_norm_eps)
    return x, pooled


def clip_image_features(params, cfg: CLIPVisionConfig,
                        pixel_values: torch.Tensor) -> torch.Tensor:
    """CLIPModel.get_image_features: projection of the pooled class token."""
    _, pooled = clip_vision_apply(params, cfg, pixel_values)
    return nn.linear(params["visual_projection"], pooled)


def init_clip_vision_params(ini: init.Init, cfg: CLIPVisionConfig):
    c, inter = cfg.hidden_size, cfg.intermediate_size
    layers = {}
    for i in range(cfg.num_layers):
        layers[str(i)] = {
            "self_attn": {
                "q_proj": init.linear_p(ini, c, c),
                "k_proj": init.linear_p(ini, c, c),
                "v_proj": init.linear_p(ini, c, c),
                "out_proj": init.linear_p(ini, c, c),
            },
            "layer_norm1": init.norm_p(ini, c),
            "layer_norm2": init.norm_p(ini, c),
            "mlp": {
                "fc1": init.linear_p(ini, c, inter),
                "fc2": init.linear_p(ini, inter, c),
            },
        }
    p = cfg.patch_size
    return {
        "vision_model": {
            "embeddings": {
                "class_embedding": init.normal_p(ini, (c,), 0.02),
                "patch_embedding": {
                    "weight": init.normal_p(ini, (c, 3, p, p), 0.02)},
                "position_embedding": {
                    "weight": init.normal_p(ini, (cfg.num_patches + 1, c), 0.02)},
            },
            "pre_layrnorm": init.norm_p(ini, c),
            "encoder": {"layers": layers},
            "post_layernorm": init.norm_p(ini, c),
        },
        "visual_projection": init.linear_p(ini, c, cfg.projection_dim, bias=False),
    }
