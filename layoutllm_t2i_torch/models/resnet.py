"""ResNet feature backbone for map grounding (layoutllm_t2i_tpu/models/
resnet.py; reference GLIGEN resnet.py): a torchvision-style ResNet whose
forward returns the layer4 feature map, the alternative to ConvNeXt-tiny
in the map grounding tokenizer.

Parameters under torchvision's names (conv1, bn1, layer{1-4}.{i}.conv{1-3}/
bn{1-3}/downsample), convs OIHW. BatchNorm runs in inference mode on the
running statistics, in f32. Activations are NCHW in channels_last memory.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.resize import resize_nhwc
from . import initializers as init


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block: str = "basic"              # basic (18/34) | bottleneck (50/101/152)
    layers: Tuple[int, ...] = (2, 2, 2, 2)   # resnet18
    width: int = 64

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4

    @property
    def out_dim(self) -> int:
        return self.width * 8 * self.expansion


def _bn(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    shape = (1, -1, 1, 1)
    mean = p["running_mean"].float().reshape(shape)
    var = p["running_var"].float().reshape(shape)
    y = (x.float() - mean) * torch.rsqrt(var + eps)
    y = y * p["weight"].float().reshape(shape) + p["bias"].float().reshape(shape)
    return y.to(x.dtype)


def _conv(p, x, stride=1, padding=0):
    return nn.conv2d(p, x, stride=stride, padding=padding)


def _basic_block(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = torch.relu(_bn(p["bn1"], _conv(p["conv1"], x, stride, 1)))
    out = _bn(p["bn2"], _conv(p["conv2"], out, 1, 1))
    identity = x
    if "downsample" in p:
        identity = _bn(p["downsample"]["1"], _conv(p["downsample"]["0"], x, stride))
    return torch.relu(out + identity)


def _bottleneck(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    out = torch.relu(_bn(p["bn1"], _conv(p["conv1"], x)))
    out = torch.relu(_bn(p["bn2"], _conv(p["conv2"], out, stride, 1)))
    out = _bn(p["bn3"], _conv(p["conv3"], out))
    identity = x
    if "downsample" in p:
        identity = _bn(p["downsample"]["1"], _conv(p["downsample"]["0"], x, stride))
    return torch.relu(out + identity)


def resnet_features(params, cfg: ResNetConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 3, H, W) channels_last -> layer4 features (B, out_dim, H/32,
    W/32), channels_last."""
    block = _basic_block if cfg.block == "basic" else _bottleneck
    h = torch.relu(_bn(params["bn1"], _conv(params["conv1"], x, 2, 3)))
    # max pool 3x3 / 2 with -inf padding, as reduce_window pads
    h = F.max_pool2d(h, 3, stride=2, padding=1).contiguous(memory_format=nn.CL)
    for li, n_blocks in enumerate(cfg.layers):
        layer = params[f"layer{li + 1}"]
        for bi in range(n_blocks):
            h = block(layer[str(bi)], h, 2 if (li > 0 and bi == 0) else 1)
    return h


def _init_bn(ini: init.Init, c: int):
    return {"weight": ini.full((c,), 1.0), "bias": ini.full((c,), 0.0),
            "running_mean": ini.full((c,), 0.0),
            "running_var": ini.full((c,), 1.0)}


def _init_conv(ini: init.Init, kh, kw, cin, cout):
    return {"weight": init.conv_p(ini, kh, kw, cin, cout, bias=False)["weight"]}


def init_resnet_params(ini: init.Init, cfg: ResNetConfig):
    params = {"conv1": _init_conv(ini, 7, 7, 3, cfg.width),
              "bn1": _init_bn(ini, cfg.width)}
    in_ch = cfg.width
    for li, n_blocks in enumerate(cfg.layers):
        planes = cfg.width * (2 ** li)
        out_ch = planes * cfg.expansion
        layer = {}
        for bi in range(n_blocks):
            stride = 2 if (li > 0 and bi == 0) else 1
            if cfg.block == "basic":
                blk = {"conv1": _init_conv(ini, 3, 3, in_ch, planes),
                       "bn1": _init_bn(ini, planes),
                       "conv2": _init_conv(ini, 3, 3, planes, planes),
                       "bn2": _init_bn(ini, planes)}
            else:
                blk = {"conv1": _init_conv(ini, 1, 1, in_ch, planes),
                       "bn1": _init_bn(ini, planes),
                       "conv2": _init_conv(ini, 3, 3, planes, planes),
                       "bn2": _init_bn(ini, planes),
                       "conv3": _init_conv(ini, 1, 1, planes, out_ch),
                       "bn3": _init_bn(ini, out_ch)}
            if stride != 1 or in_ch != out_ch:
                blk["downsample"] = {"0": _init_conv(ini, 1, 1, in_ch, out_ch),
                                     "1": _init_bn(ini, out_ch)}
            layer[str(bi)] = blk
            in_ch = out_ch
        params[f"layer{li + 1}"] = layer
    return params


# -- map grounding tokenizer over the ResNet backbone ------------------------


def position_net_map_resnet(p, cond_map: torch.Tensor, mask: torch.Tensor,
                            resize_input: int = 448,
                            cfg: ResNetConfig = ResNetConfig()) -> torch.Tensor:
    """The ResNet form of grounding_extras.position_net_map: layer4 tokens
    (+ position embedding) -> the 3-layer MLP's grounding tokens."""
    x = resize_nhwc(cond_map, (resize_input, resize_input), "bilinear")
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=nn.CL)
    objs = nn.to_rows(resnet_features(p["resnet_backbone"], cfg, x))
    m = mask.reshape(-1, 1, 1).to(objs.dtype)
    null = p["null_feature"].reshape(1, 1, -1).to(objs.dtype)
    objs = objs * m + null * (1 - m)
    objs = objs + p["pos_embedding"].to(objs.dtype)
    h = nn.silu(nn.linear(p["linears"]["0"], objs))
    h = nn.silu(nn.linear(p["linears"]["2"], h))
    return nn.linear(p["linears"]["4"], h)


def init_position_net_map_resnet(ini: init.Init, out_dim: int = 768,
                                 resize_input: int = 448,
                                 cfg: ResNetConfig = ResNetConfig()):
    num_tokens = (resize_input // 32) ** 2
    feat_dim = cfg.out_dim
    return {
        "resnet_backbone": init_resnet_params(ini, cfg),
        "pos_embedding": init.normal_p(ini, (1, num_tokens, feat_dim), 0.02),
        "linears": {
            "0": init.linear_p(ini, feat_dim, 512),
            "2": init.linear_p(ini, 512, 512),
            "4": init.linear_p(ini, 512, out_dim),
        },
        "null_feature": init.zeros_p(ini, (feat_dim,)),
    }
