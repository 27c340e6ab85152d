"""K3: row LayerNorm + affine (csrc/layer_norm.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/norms.py`` ``_ln_pallas`` /
``_ln_kernel``, which takes any float type. The port's kernel has a bf16
and an f32 instantiation, picked from ``x.dtype`` (the reward's CLIP towers
run in f32); weight and bias come in the same type. Rows up to 2048 wide run
one warp a row; wider rows (the middle block of a ``channel_mult`` (1, 2,
4, 8) UNet, C 2560) one block a row, as ``entry_point`` picks. The Pallas
kernel takes any C, and so does the port. Differentiable through
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


# the instantiations: dtype -> (one-warp C entry, block-a-row C entry,
# elements a 16-byte vector)
_ENTRY = {torch.bfloat16: ("llt2i_layer_norm", "llt2i_layer_norm_wide", 8),
          torch.float32: ("llt2i_layer_norm_f32", "llt2i_layer_norm_wide_f32", 4)}
# the widest row one warp holds in registers (csrc/layer_norm.cu); wider
# rows run one block a row
WARP_MAX_C = 2048


def entry_point(c: int, dtype: torch.dtype) -> str:
    """The C entry that a row of width ``c`` in ``dtype`` launches."""
    warp, wide, _ = _ENTRY[dtype]
    return wide if c > WARP_MAX_C else warp


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
    if c % _ENTRY[dtype][2]:
        raise ValueError(f"layer_norm: C={c} is unsupported for {dtype}")
    xp, wp, bp = x.data_ptr(), weight.data_ptr(), bias.data_ptr()
    if (xp | wp | bp) & 15:  # rows and params move as 16-byte vectors
        raise ValueError("layer_norm: x, weight and bias must be 16-byte "
                         "aligned")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    check(getattr(lib("layer_norm"), entry_point(c, dtype))(
        xp, wp, bp, out.data_ptr(), rows, c, float(eps), stream_handle(dev)),
        "layer_norm")
    layer_norm.launches += 1
    if dtype is torch.float32:
        layer_norm.f32_launches += 1
    return out


layer_norm.launches = 0
layer_norm.f32_launches = 0  # the f32 form's share of ``launches``
