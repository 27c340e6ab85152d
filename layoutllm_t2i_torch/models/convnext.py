"""ConvNeXt backbone, tiny by default (layoutllm_t2i_tpu/models/convnext.py;
reference GLIGEN convnext.py): the map-grounding PositionNet's feature
extractor (canny_grounding_net.py:20,44), whose last stage gives the
(B, 768, H/32, W/32) features.

Parameters under the reference names (downsample_layers.{i}.{0,1},
stages.{i}.{j}.dwconv/norm/pwconv1/pwconv2/gamma), convs OIHW: the
depthwise 7x7 conv is (C, 1, 7, 7) with ``groups=C``. Activations are
NCHW in channels_last memory; every LayerNorm runs over the channels of
NHWC rows (K3) at eps 1e-6, and the block's pointwise convs are linears
on those rows.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops import nn
from . import initializers as init


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    in_chans: int = 3
    layer_scale_init: float = 1e-6


def _depthwise_conv7(p, x: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x, nn.weight(p, x.dtype), p["bias"].to(x.dtype), padding=3,
                 groups=x.shape[1])
    return y.contiguous(memory_format=nn.CL)


def _channel_norm(p, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW channels_last map, eps 1e-6."""
    h, w = x.shape[2:]
    return nn.from_rows(nn.layer_norm(p, nn.to_rows(x), eps=1e-6), h, w)


def _block(p, x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[2:]
    r = nn.to_rows(_depthwise_conv7(p["dwconv"], x))
    r = nn.layer_norm(p["norm"], r, eps=1e-6)
    r = nn.linear(p["pwconv2"], nn.gelu(nn.linear(p["pwconv1"], r)))
    if "gamma" in p:
        r = p["gamma"].to(r.dtype) * r
    return x + nn.from_rows(r, h, w)


def convnext_features(params, cfg: ConvNeXtConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 3, H, W) channels_last -> the last stage's features
    (B, dims[-1], H/32, W/32), channels_last."""
    for i in range(4):
        ds = params["downsample_layers"][str(i)]
        if i == 0:
            x = _channel_norm(ds["1"], nn.conv2d(ds["0"], x, stride=4, padding=0))
        else:
            x = nn.conv2d(ds["1"], _channel_norm(ds["0"], x), stride=2, padding=0)
        for j in range(cfg.depths[i]):
            x = _block(params["stages"][str(i)][str(j)], x)
    return x


def init_convnext_params(ini: init.Init, cfg: ConvNeXtConfig):
    downs = {"0": {"0": init.conv_p(ini, 4, 4, cfg.in_chans, cfg.dims[0]),
                   "1": init.norm_p(ini, cfg.dims[0])}}
    for i in range(1, 4):
        downs[str(i)] = {"0": init.norm_p(ini, cfg.dims[i - 1]),
                         "1": init.conv_p(ini, 2, 2, cfg.dims[i - 1], cfg.dims[i])}
    stages = {}
    for i, dim in enumerate(cfg.dims):
        stages[str(i)] = {
            str(j): {
                # depthwise: one input channel a group, fan-in 7 * 7
                "dwconv": init.conv_p(ini, 7, 7, 1, dim),
                "norm": init.norm_p(ini, dim),
                "pwconv1": init.linear_p(ini, dim, 4 * dim),
                "pwconv2": init.linear_p(ini, 4 * dim, dim),
                "gamma": ini.full((dim,), cfg.layer_scale_init),
            }
            for j in range(cfg.depths[i])}
    return {"downsample_layers": downs, "stages": stages}
