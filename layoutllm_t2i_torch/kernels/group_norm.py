"""K2: GroupNorm + affine (+SiLU) over channels-last rows (csrc/group_norm.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/norms.py`` ``_gn_pallas`` and
``_gn_pallas_rows`` (their ``_gn_kernel``, ``_gn_stats_kernel`` and
``_gn_apply_kernel``). Differentiable through ``GroupNorm``, whose backward
is the plain version's VJP, as ``_gn_bwd`` (norms.py:294) recomputes it.
"""
from __future__ import annotations

import torch

from .build import check, lib
from .dispatch import (check_operand, needs_grad, plain_vjp, require,
                       stream_handle, use_kernel)

# statistics blocks to aim for: a few per SM of the H100's 132
_STATS_BLOCKS = 528
_APPLY_BLOCKS_MAX = 132 * 16


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    n, hw, c = x.shape
    xf = x.float().reshape(n, hw, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, hw, c)
    y = y * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """x: (N, HW, C) channels-last rows -> same shape, f32 statistics."""
    if needs_grad(x, weight, bias):
        return GroupNorm.apply(x, weight, bias, num_groups, eps, silu)
    return _forward(x, weight, bias, num_groups, eps, silu)


class GroupNorm(torch.autograd.Function):
    """K2 forward; the backward recomputes through ``group_norm_plain``."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.static = (num_groups, eps, silu)
        return _forward(x, weight, bias, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, grad):
        args = (*ctx.saved_tensors, *ctx.static)
        return plain_vjp(group_norm_plain, args, ctx.needs_input_grad, grad)


def _forward(x, weight, bias, num_groups, eps, silu):
    if not use_kernel(x):
        return group_norm_plain(x, weight, bias, num_groups, eps, silu)
    n, hw, c = x.shape
    dev = x.get_device()
    check_operand(x, "group_norm: x", dev)
    check_operand(weight, "group_norm: weight", dev)
    check_operand(bias, "group_norm: bias", dev)
    require(weight.shape == (c,) and bias.shape == (c,),
            "group_norm: affine params must be (C,)")
    if not (c % num_groups == 0 and c % 8 == 0 and num_groups <= 128):
        raise ValueError(
            f"group_norm: C={c} with {num_groups} groups is unsupported")
    chunks = min(hw, max(1, -(-_STATS_BLOCKS // n)))
    rows = -(-hw // chunks)
    chunks = -(-hw // rows)
    part = torch.empty(n * chunks * num_groups * 3, dtype=torch.float32,
                       device=x.device)
    ss = torch.empty(n * 2 * c, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    apply_blocks = max(1, min(_APPLY_BLOCKS_MAX, -(-x.numel() // (8 * 256))))
    check(lib("group_norm").llt2i_group_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        part.data_ptr(), ss.data_ptr(), n, hw, c, num_groups, rows,
        float(eps), int(silu), apply_blocks, stream_handle(dev)),
        "group_norm")
    group_norm.launches += 1
    return out


group_norm.launches = 0
