"""K8a, K8b: the blocked GEMMs of the opt-in matmul route (csrc/matmul.cu).

Replace ``layoutllm_t2i_tpu/ops/pallas/matmul.py`` ``_mm_call`` /
``_mm_kernel`` (``linear_fused``) and ``_geglu_call`` / ``_geglu_kernel``
(``geglu_fused``). Weights stay in the torch layout: ``linear_fused`` takes
``w`` as (N, K), ``geglu_fused`` takes ``w`` = [Wa; Wg] as (2N, K), as
``net.0.proj.weight`` holds them. Both are differentiable through
Functions whose backward is the plain version's VJP, as ``_linear_bwd``
(matmul.py:228) and ``_geglu_bwd`` (matmul.py:264) compute it with plain
dots.

``_pick_block`` and ``_eligible`` are copies of the JAX package's
(matmul.py:34, :192): ``ops/nn.py`` routes a site to these kernels exactly
where the JAX package routes it to its Pallas kernels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .build import check, lib
from .dispatch import (check_operand, needs_grad, plain_vjp, require,
                       require_aligned, stream_handle, use_kernel)

# the Pallas kernels' block sizes (matmul.py:109): they decide eligibility
_BM, _BN, _BK = 512, 512, 512


def _pick_block(dim: int, want: int) -> int:
    """Largest power-of-two block <= want that divides dim (dim itself if
    smaller than want)."""
    if dim <= want:
        return dim
    b = want
    while dim % b:
        b //= 2
    return b


def _eligible(m: int, k: int, n: int) -> bool:
    """The JAX package's test for routing an (m, k) x (k, n) product to its
    Pallas GEMM: big enough, and decomposable into its blocks."""
    return (
        m >= 1024 and k >= 128 and n >= 128
        and m % 8 == 0
        and _pick_block(m, _BM) >= 256
        and _pick_block(k, _BK) >= 128
        and _pick_block(n, _BN) >= 128
    )


def _refuse_f32(x: torch.Tensor, name: str) -> None:
    """K8a and K8b take bf16 only: an f32 operand (the reward's f32 CLIP
    towers reach K8a under LLT2I_PALLAS_MATMUL=1) raises, naming the
    ROADMAP item that ports their f32 forms."""
    if x.dtype is torch.float32:
        raise ValueError(f"{name}: f32 operands are not ported to this "
                         "kernel (ROADMAP Queue 2, 'f32 operands of K6, K7, "
                         "K8a and K8b'); unset LLT2I_PALLAS_MATMUL for f32 "
                         "models")


def linear_plain(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x W^T + b + r summed in f32 and rounded once to x.dtype, as the
    kernel's epilogue does."""
    y = x.float() @ w.float().t()
    if b is not None:
        y = y + b.float()
    if r is not None:
        y = y + r.float()
    return y.to(x.dtype)


def linear_fused(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K), w: (N, K) -> (M, N) = x W^T (+ b) (+ r)."""
    if needs_grad(x, w, b, r):
        return LinearFused.apply(x, w, b, r)
    return _linear_forward(x, w, b, r)


class LinearFused(torch.autograd.Function):
    """K8a forward; the backward recomputes through ``linear_plain``."""

    @staticmethod
    def forward(ctx, x, w, b, r):
        ctx.save_for_backward(x, w, b, r)
        return _linear_forward(x, w, b, r)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(linear_plain, ctx.saved_tensors, ctx.needs_input_grad,
                         grad)


def _linear_forward(x, w, b, r):
    if not use_kernel(x):
        return linear_plain(x, w, b, r)
    _refuse_f32(x, "linear_fused")
    m, k = x.shape
    n = w.shape[0]
    dev = x.get_device()
    for name, t in (("linear_fused: x", x), ("linear_fused: w", w),
                    ("linear_fused: b", b), ("linear_fused: r", r)):
        if t is not None:
            check_operand(t, name, dev, torch.bfloat16)
    require(w.shape == (n, k) and (b is None or b.shape == (n,))
            and (r is None or r.shape == (m, n)), "linear_fused: shapes")
    if not (k % 8 == 0 and n % 8 == 0):
        raise ValueError(f"linear_fused: K={k}, N={n} must be multiples of 8")
    # x and w through TMA, b and r in bf16 pairs
    for name, t, nbytes in (("linear_fused: x", x, 16), ("linear_fused: w", w, 16),
                            ("linear_fused: b", b, 4), ("linear_fused: r", r, 4)):
        if t is not None:
            require_aligned(t, name, nbytes)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()
    check(lib("matmul").llt2i_linear(
        x.data_ptr(), w.data_ptr(), ptr(b), ptr(r), out.data_ptr(), m, k, n,
        stream_handle(dev)), "linear_fused")
    linear_fused.launches += 1
    return out


linear_fused.launches = 0


def geglu_plain(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x Wa^T + ba) * gelu_erf(x Wg^T + bg) in f32, rounded once to
    x.dtype; w = [Wa; Wg] is (2N, K)."""
    n = w.shape[0] // 2
    y = x.float() @ w.float().t()
    if b is not None:
        y = y + b.float()
    return (y[:, :n] * F.gelu(y[:, n:])).to(x.dtype)


def geglu_fused(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K), w: (2N, K), b: (2N,) or None -> (M, N)."""
    if needs_grad(x, w, b):
        return GegluFused.apply(x, w, b)
    return _geglu_forward(x, w, b)


class GegluFused(torch.autograd.Function):
    """K8b forward; the backward recomputes through ``geglu_plain``."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return _geglu_forward(x, w, b)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(geglu_plain, ctx.saved_tensors, ctx.needs_input_grad,
                         grad)


def _geglu_forward(x, w, b):
    if not use_kernel(x):
        return geglu_plain(x, w, b)
    _refuse_f32(x, "geglu_fused")
    m, k = x.shape
    n = w.shape[0] // 2
    dev = x.get_device()
    for name, t in (("geglu_fused: x", x), ("geglu_fused: w", w),
                    ("geglu_fused: b", b)):
        if t is not None:
            check_operand(t, name, dev, torch.bfloat16)
    require(w.shape == (2 * n, k) and (b is None or b.shape == (2 * n,)),
            "geglu_fused: shapes")
    if not (k % 8 == 0 and n % 8 == 0):
        raise ValueError(f"geglu_fused: K={k}, N={n} must be multiples of 8")
    # x and w through TMA, b in bf16 pairs
    for name, t, nbytes in (("geglu_fused: x", x, 16), ("geglu_fused: w", w, 16),
                            ("geglu_fused: b", b, 4)):
        if t is not None:
            require_aligned(t, name, nbytes)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    check(lib("matmul").llt2i_geglu(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), m, k, n, stream_handle(dev)), "geglu_fused")
    geglu_fused.launches += 1
    return out


geglu_fused.launches = 0
