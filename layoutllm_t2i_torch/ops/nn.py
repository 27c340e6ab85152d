"""Primitive NN ops as functions over parameter dicts (torch state_dict
names and layouts: conv weights OIHW, linear weights (out, in)).

Activations of the conv/norm layers are logical NCHW tensors in
``torch.channels_last`` memory, so that ``F.conv2d`` runs NHWC and the
GroupNorm kernel sees contiguous (N, H*W, C) rows through a free view.

Every GroupNorm runs through K2, every LayerNorm through K3 and every
LN + GEGLU feed-forward + residual site through K4; a CPU tensor takes each
kernel's plain version. Eps is per site: 1e-5 for the UNet ResBlock
GroupNorms and every LayerNorm, 1e-6 for the spatial-transformer and VAE
GroupNorms (layoutllm_t2i_tpu/ops/nn.py:12-18).
"""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from ..kernels import ffn_ln_geglu
from ..kernels import group_norm as _group_norm_rows
from ..kernels import layer_norm as _layer_norm_rows

CL = torch.channels_last


def to_rows(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels_last -> (N, H*W, C) view."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def from_rows(r: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> (N, C, H, W) in channels_last memory (a view)."""
    n, _, c = r.shape
    return r.reshape(n, h, w, c).permute(0, 3, 1, 2)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=CL)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def linear(p, x: torch.Tensor) -> torch.Tensor:
    w = p["weight"].to(x.dtype)
    b = p["bias"].to(x.dtype) if "bias" in p else None
    return F.linear(x, w, b)


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    b = p["bias"].to(x.dtype) if "bias" in p else None
    y = F.conv2d(x, p["weight"].to(x.dtype), b, stride=stride, padding=padding)
    return y.contiguous(memory_format=CL)


def group_norm(p, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over NCHW channels_last, f32 statistics (K2)."""
    h, w = x.shape[2:]
    y = _group_norm_rows(to_rows(x).contiguous(), p["weight"], p["bias"],
                         num_groups, eps, silu)
    return from_rows(y, h, w)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics (K3)."""
    c = x.shape[-1]
    y = _layer_norm_rows(x.reshape(-1, c).contiguous(), p["weight"], p["bias"],
                         eps)
    return y.reshape(x.shape)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form, as the reference's GEGLU


def geglu_ff(p, x: torch.Tensor) -> torch.Tensor:
    """FeedForward(glu=True): Linear(d->8d) -> a*gelu(gate) -> Linear(4d->d)."""
    a, gate = linear(p["net"]["0"]["proj"], x).chunk(2, dim=-1)
    return linear(p["net"]["2"], a * gelu(gate))


def ln_geglu_ff_scaled_res(p_ff, p_norm, x: torch.Tensor,
                           s: Union[float, torch.Tensor]) -> torch.Tensor:
    """x + s * geglu_ff(p_ff, layer_norm(p_norm, x)) in one K4 call."""
    proj, out = p_ff["net"]["0"]["proj"], p_ff["net"]["2"]
    c = x.shape[-1]
    y = ffn_ln_geglu(x.reshape(-1, c).contiguous(), p_norm["weight"],
                     p_norm["bias"], proj["weight"], proj["bias"],
                     out["weight"], out["bias"], s)
    return y.reshape(x.shape)


def ln_geglu_ff_res(p_ff, p_norm, x: torch.Tensor) -> torch.Tensor:
    """geglu_ff(p_ff, layer_norm(p_norm, x)) + x: the norm3 site (s = 1)."""
    return ln_geglu_ff_scaled_res(p_ff, p_norm, x, 1.0)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest").contiguous(
        memory_format=CL)
