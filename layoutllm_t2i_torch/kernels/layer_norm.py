"""K3: row LayerNorm + affine (csrc/layer_norm.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/norms.py`` ``_ln_pallas`` /
``_ln_kernel``. Differentiable through ``LayerNorm``, whose backward is the
plain version's VJP, as ``_ln_bwd`` (norms.py:384) recomputes it.
"""
from __future__ import annotations

import torch

from .build import check, lib
from .dispatch import (check_operand, needs_grad, plain_vjp, require,
                       stream_handle, use_kernel)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """x: (rows, C) -> (rows, C), f32 statistics."""
    if needs_grad(x, weight, bias):
        return LayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps)


class LayerNorm(torch.autograd.Function):
    """K3 forward; the backward recomputes through ``layer_norm_plain``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, grad):
        args = (*ctx.saved_tensors, ctx.eps)
        return plain_vjp(layer_norm_plain, args, ctx.needs_input_grad, grad)


def _forward(x, weight, bias, eps):
    if not use_kernel(x):
        return layer_norm_plain(x, weight, bias, eps)
    rows, c = x.shape
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        check_operand(t, f"layer_norm: {name}", x.device)
    require(weight.shape == (c,) and bias.shape == (c,),
            "layer_norm: affine params must be (C,)")
    require(c % 8 == 0 and c <= 2048, f"layer_norm: C={c} is unsupported")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    check(lib("layer_norm").llt2i_layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows, c, float(eps), stream_handle(x.device)), "layer_norm")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
