"""K3: row LayerNorm + affine (csrc/layer_norm.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/norms.py`` ``_ln_pallas`` /
``_ln_kernel``, which takes any float type. The port's kernel has a bf16
and an f32 instantiation, picked from ``x.dtype`` (the reward's CLIP towers
run in f32); weight and bias come in the same type. Differentiable through
``LayerNorm``, whose backward is the plain version's VJP, as ``_ln_bwd``
(norms.py:384) recomputes it.
"""
from __future__ import annotations

import torch

from .build import check, lib
from .dispatch import (check_operand, needs_grad, operand_dtype, plain_vjp,
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


# the instantiations: dtype -> (C entry point, elements a 16-byte vector)
_ENTRY = {torch.bfloat16: ("llt2i_layer_norm", 8),
          torch.float32: ("llt2i_layer_norm_f32", 4)}
# the widest row the kernel keeps (csrc/layer_norm.cu), and where the rows
# past it are listed as still to port (the Pallas kernel takes any C)
MAX_C = 2048
NOT_PORTED = "ROADMAP.md Queue 2: K3 past C 2048"


def _forward(x, weight, bias, eps):
    if not use_kernel(x):
        return layer_norm_plain(x, weight, bias, eps)
    rows, c = x.shape
    dev = x.get_device()
    dtype = operand_dtype(x)  # any other dtype is held to bf16's, and raises
    check_operand(x, "layer_norm: x", dev, dtype)
    check_operand(weight, "layer_norm: weight", dev, dtype)
    check_operand(bias, "layer_norm: bias", dev, dtype)
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("layer_norm: affine params must be (C,)")
    entry, per_vec = _ENTRY[dtype]
    if c > MAX_C:
        raise ValueError(f"layer_norm: C={c} is past the widest kernel "
                         f"({MAX_C}); not ported ({NOT_PORTED})")
    if c % per_vec:
        raise ValueError(f"layer_norm: C={c} is unsupported for {dtype}")
    xp, wp, bp = x.data_ptr(), weight.data_ptr(), bias.data_ptr()
    if (xp | wp | bp) & 15:  # rows and params move as 16-byte vectors
        raise ValueError("layer_norm: x, weight and bias must be 16-byte "
                         "aligned")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    check(getattr(lib("layer_norm"), entry)(
        xp, wp, bp, out.data_ptr(), rows, c, float(eps), stream_handle(dev)),
        "layer_norm")
    layer_norm.launches += 1
    if dtype is torch.float32:
        layer_norm.f32_launches += 1
    return out


layer_norm.launches = 0
layer_norm.f32_launches = 0  # the f32 form's share of ``launches``
