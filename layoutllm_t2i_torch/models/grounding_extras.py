"""The GLIGEN grounding tokenizers and downsampler beyond box + text
(layoutllm_t2i_tpu/models/grounding_extras.py; reference GLIGEN
keypoint_grounding_net.py, canny_grounding_net.py and
canny_grounding_downsampler.py, with the hed/depth/normal/sem variants).

Person keypoints (17 COCO points a person) and condition maps
(canny/hed/depth/normal/sem): a map gives 196 ConvNeXt tokens to the gated
fusers and, through the downsampler, extra UNet input channels
(UNetConfig.additional_in_channels). The tokenizers compute in f32, as the
JAX package's do on its f32 inputs; the caller casts the tokens to the
UNet's dtype.
"""
from __future__ import annotations

import torch

from ..ops import nn
from ..ops.resize import resize_nhwc
from ..ops.schedules import fourier_embed
from . import initializers as init
from .convnext import ConvNeXtConfig, convnext_features, init_convnext_params


def _mlp(p, h: torch.Tensor) -> torch.Tensor:
    h = nn.silu(nn.linear(p["0"], h))
    h = nn.silu(nn.linear(p["2"], h))
    return nn.linear(p["4"], h)


# ---------------------------------------------------------------------------
# keypoint grounding tokenizer (17 COCO keypoints a person)


def position_net_keypoint(p, points: torch.Tensor, masks: torch.Tensor,
                          max_persons: int, out_dim: int,
                          fourier_freqs: int = 8) -> torch.Tensor:
    """points: (B, max_persons*17, 2) normalized xy; masks: (B, max_persons*17)."""
    b = points.shape[0]
    m = masks[..., None].float()
    person = p["person_embeddings"].float().repeat_interleave(17, dim=0)  # (P*17, C)
    keypoint = p["keypoint_embeddings"].float().repeat(max_persons, 1)
    person = (person + keypoint)[None].expand(b, -1, -1)
    xy = fourier_embed(points, num_freqs=fourier_freqs)
    person = person * m + (1 - m) * p["null_person_feature"].float().reshape(1, 1, -1)
    xy = xy * m + (1 - m) * p["null_xy_feature"].float().reshape(1, 1, -1)
    return _mlp(p["linears"], torch.cat([person, xy], dim=-1))


def init_position_net_keypoint(ini: init.Init, max_persons: int, out_dim: int,
                               fourier_freqs: int = 8):
    position_dim = fourier_freqs * 2 * 2
    return {
        "person_embeddings": init.zeros_p(ini, (max_persons, out_dim)),
        "keypoint_embeddings": init.zeros_p(ini, (17, out_dim)),
        "linears": {
            "0": init.linear_p(ini, out_dim + position_dim, 512),
            "2": init.linear_p(ini, 512, 512),
            "4": init.linear_p(ini, 512, out_dim),
        },
        "null_person_feature": init.zeros_p(ini, (out_dim,)),
        "null_xy_feature": init.zeros_p(ini, (position_dim,)),
    }


# ---------------------------------------------------------------------------
# condition-map grounding tokenizer (canny/hed/depth/normal/sem): ConvNeXt-
# tiny over the map -> (resize/32)^2 spatial tokens plus a learned position
# embedding (canny_grounding_net.py:12-62)


def position_net_map(p, cond_map: torch.Tensor, mask: torch.Tensor,
                     resize_input: int = 448) -> torch.Tensor:
    """cond_map: (B, H, W, 3) in [0, 1]; mask: (B,) 0/1 validity a sample.
    The map is resized (bilinear, antialiased as jax.image.resize) to
    resize_input^2 and run through ConvNeXt in its own dtype."""
    b = cond_map.shape[0]
    x = resize_nhwc(cond_map, (resize_input, resize_input), "bilinear")
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=nn.CL)
    feats = convnext_features(p["convnext_tiny_backbone"], ConvNeXtConfig(), x)
    objs = nn.to_rows(feats)                                  # (B, T, 768)
    m = mask.reshape(-1, 1, 1).to(objs.dtype)
    null = p["null_feature"].reshape(1, 1, -1).to(objs.dtype)
    objs = objs * m + null * (1 - m)
    objs = objs + p["pos_embedding"].to(objs.dtype)
    return _mlp(p["linears"], objs)


def init_position_net_map(ini: init.Init, out_dim: int = 768,
                          resize_input: int = 448):
    num_tokens = (resize_input // 32) ** 2
    feat_dim = 768
    return {
        "convnext_tiny_backbone": init_convnext_params(ini, ConvNeXtConfig()),
        "pos_embedding": init.normal_p(ini, (1, num_tokens, feat_dim), 0.02),
        "linears": {
            "0": init.linear_p(ini, feat_dim, 512),
            "2": init.linear_p(ini, 512, 512),
            "4": init.linear_p(ini, 512, out_dim),
        },
        "null_feature": init.zeros_p(ini, (feat_dim,)),
    }


# ---------------------------------------------------------------------------
# condition-map downsampler: the map -> extra UNet input channels


def grounding_downsampler(p, cond_map: torch.Tensor,
                          resize_input: int = 256) -> torch.Tensor:
    """cond_map: (B, H, W, C >= 1) in [0, 1]; channel 0 only (the datasets
    replicate grayscale maps to RGB), resized (bicubic, antialiased as
    jax.image.resize) to resize_input^2, then two stride-2 4x4 convs.
    Returns (B, resize/4, resize/4, out) NHWC, in cond_map's dtype."""
    x = resize_nhwc(cond_map[..., :1], (resize_input, resize_input), "bicubic")
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=nn.CL)
    x = nn.silu(nn.conv2d(p["layers"]["0"], x, stride=2, padding=1))
    x = nn.conv2d(p["layers"]["2"], x, stride=2, padding=1)
    return nn.nchw_to_nhwc(x)


def init_grounding_downsampler(ini: init.Init, out_dim: int = 8):
    return {"layers": {"0": init.conv_p(ini, 4, 4, 1, 4),
                       "2": init.conv_p(ini, 4, 4, 4, out_dim)}}
