"""The GEGLU feed-forward kernels K4, K6 and K7 (csrc/ffn.cu).

* K4 ``ffn_ln_geglu``: LayerNorm + GEGLU FF + scaled residual. Replaces
  ``layoutllm_t2i_tpu/ops/pallas/ffn.py`` ``_ffn_ln_call`` /
  ``_ffn_ln_kernel`` (``ffn_ln_geglu_fused``, s = 1, and
  ``ffn_ln_geglu_scaled``). bf16 or f32 (``llt2i_ffn_ln_geglu_f32``,
  3xTF32 products on TF32 wgmma, LN(x) and h kept in f32), picked from
  ``x.dtype``.
* K6 ``ffn_geglu``: the FF without the LN, its residual passed in.
  Replaces ``_ffn_call`` / ``_ffn_kernel`` (``ffn_geglu_fused``). bf16 or
  f32 (``llt2i_ffn_geglu_f32``: K4/f32's up and down kernels, h in f32).
* K7 ``ffn_ln_geglu_q``: K4 with int8 weights and per-output-channel f32
  scales applied after each dot. Replaces ``_ffn_ln_q_call`` /
  ``_ffn_ln_q_kernel`` (``ffn_ln_geglu_scaled_q``). bf16 or f32
  activations (``llt2i_ffn_ln_geglu_q_f32``: K4/f32's TF32 wgmma GEMMs
  with the int8 weight tiles converted to f32 in shared memory, two TF32
  products against the int8 values, which TF32 holds exactly); its LN
  parameters and biases in x's type, its int8 values and f32 scales as
  they are.

Each wrapper picks its C entry from ``operand_dtype(x)`` and counts the f32
form's launches in ``f32_launches`` beside ``launches``.

Weights stay in the reference torch layout: ``w1`` is ``net.0.proj.weight``
(2*inner, K) = [Wa; Wg] and ``w2`` is ``net.2.weight`` (K, inner); K7 takes
their int8 values and scales (``ops/quant.py``, per output channel: ``s1``
(2*inner,), ``s2`` (K,)). K4 and K6 are differentiable through Functions
whose backward is the plain version's VJP, as ``_ffn_ln_bwd`` (ffn.py:287),
``_ffn_ln_s_bwd`` (ffn.py:315) and ``_ffn_bwd`` (ffn.py:241) recompute it;
K4's gradient reaches every tensor input, the scale ``s`` included. K7 is
inference only, as the JAX package's (no VJP).

``_blocks`` and ``ffn_eligible`` are copies of the JAX package's
(ffn.py:111, :216), with its ``LLT2I_FFN_BM`` / ``LLT2I_FFN_BN`` overrides:
the CUDA kernels pick their own tiles whatever they say, but they decide
where ``ops/nn.py`` takes K4, K6 or K7, exactly where the JAX package takes
its Pallas kernel.
"""
from __future__ import annotations

import os
from typing import Union

import torch
import torch.nn.functional as F

from .build import check, lib
from .dispatch import (check_operand, needs_grad, operand_dtype, plain_vjp,
                       require, require_aligned, stream_handle, use_kernel,
                       vector_elems)
from .matmul import _pick_block

LN_EPS = 1e-5  # torch nn.LayerNorm default, every reference norm3/norm2 site

Scale = Union[float, torch.Tensor]


def _blocks(m: int, k: int, n: int, itemsize: int = 2):
    """The Pallas FF kernels' row and inner block sizes (ffn.py:111)."""
    bn_want = int(os.environ.get("LLT2I_FFN_BN", "0")) or \
        (512 if k <= 640 else (256 if k <= 1024 else 128))
    bm_want = int(os.environ.get("LLT2I_FFN_BM", "0")) or \
        (1024 if k <= 768 else 512)
    if itemsize > 2:
        bm_want = max(256, bm_want // 2)
    return _pick_block(m, bm_want), _pick_block(n, bn_want)


def ffn_eligible(m: int, k: int, n: int, itemsize: int = 2) -> bool:
    """The JAX package's test for routing an FF site of m rows, width k
    and inner width n to its Pallas kernels."""
    bm, bn = _blocks(m, k, n, itemsize)
    return m >= 1024 and k >= 128 and n >= 256 and m % 8 == 0 \
        and bm >= 256 and bn >= 128


def _scale_operand(s: Scale, x: torch.Tensor, what: str):
    """(device pointer or None, host value, tensor the pointer reads) of
    the scale ``s``: a 0-d tensor is read by the kernel, never synced to
    the host; the caller holds the third item until the launch."""
    if not isinstance(s, torch.Tensor):
        return None, float(s), None
    if not (s.numel() == 1 and s.is_cuda and s.get_device() == x.get_device()):
        raise ValueError(f"{what}: s must be a scalar on x's device")
    s = s.reshape(()).to(torch.float32)
    return s.data_ptr(), 1.0, s


def _ln_rounded(x, ln_w, ln_b, eps):
    """LayerNorm(x) in f32, rounded to x.dtype as the kernels round it."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * ln_w.float()
            + ln_b.float()).to(x.dtype).float()


def _scale_value(s: Scale):
    return s.float() if isinstance(s, torch.Tensor) else float(s)


def ffn_ln_geglu_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, s: Scale = 1.0,
                       eps: float = LN_EPS) -> torch.Tensor:
    """x + s * (GEGLU(LN(x)) W2 + b2) with the kernel's rounding points:
    LN(x) and the GEGLU product rounded to x.dtype, products in f32."""
    inner = w1.shape[0] // 2
    xn = _ln_rounded(x, ln_w, ln_b, eps)
    w1f = w1.float()
    a = xn @ w1f[:inner].t() + b1[:inner].float()
    g = xn @ w1f[inner:].t() + b1[inner:].float()
    h = (a * F.gelu(g)).to(x.dtype).float()
    y = (h @ w2.float().t() + b2.float()) * _scale_value(s)
    return y.to(x.dtype) + x


def ffn_ln_geglu(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, s: Scale = 1.0,
                 eps: float = LN_EPS) -> torch.Tensor:
    """x: (M, K) -> x + s * FF(LN(x)), (M, K). ``s`` is a float or a 0-d
    tensor on x's device (read by the kernel, never synced to the host)."""
    if needs_grad(x, ln_w, ln_b, w1, b1, w2, b2, s):
        return FfnLnGeglu.apply(x, ln_w, ln_b, w1, b1, w2, b2, s, eps)
    return _forward(x, ln_w, ln_b, w1, b1, w2, b2, s, eps)


class FfnLnGeglu(torch.autograd.Function):
    """K4 forward; the backward recomputes through ``ffn_ln_geglu_plain``."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, s, eps):
        args = (x, ln_w, ln_b, w1, b1, w2, b2, s)
        ctx.save_for_backward(*(a for a in args if isinstance(a, torch.Tensor)))
        ctx.s_value = None if isinstance(s, torch.Tensor) else s
        ctx.eps = eps
        return _forward(x, ln_w, ln_b, w1, b1, w2, b2, s, eps)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        s = saved[7] if ctx.s_value is None else ctx.s_value
        args = (*saved[:7], s, ctx.eps)
        return plain_vjp(ffn_ln_geglu_plain, args, ctx.needs_input_grad, grad)


# the instantiations: dtype -> C entry point
_ENTRY = {torch.bfloat16: "llt2i_ffn_ln_geglu",
          torch.float32: "llt2i_ffn_ln_geglu_f32"}


def _forward(x, ln_w, ln_b, w1, b1, w2, b2, s, eps):
    if not use_kernel(x):
        return ffn_ln_geglu_plain(x, ln_w, ln_b, w1, b1, w2, b2, s, eps)
    m, k = x.shape
    inner = w1.shape[0] // 2
    dev = x.get_device()
    dtype = operand_dtype(x)
    for name, t in (("ffn_ln_geglu: x", x), ("ffn_ln_geglu: ln_w", ln_w),
                    ("ffn_ln_geglu: ln_b", ln_b), ("ffn_ln_geglu: w1", w1),
                    ("ffn_ln_geglu: b1", b1), ("ffn_ln_geglu: w2", w2),
                    ("ffn_ln_geglu: b2", b2)):
        check_operand(t, name, dev, dtype)
    require(ln_w.shape == (k,) and ln_b.shape == (k,) and b2.shape == (k,)
            and w1.shape == (2 * inner, k) and b1.shape == (2 * inner,)
            and w2.shape == (k, inner), "ffn_ln_geglu: weight shapes")
    if not (k % 8 == 0 and inner % 8 == 0):
        raise ValueError(
            f"ffn_ln_geglu: K={k}, inner={inner} must be multiples of 8")
    # x, ln_w and ln_b in 16-byte vectors, w1 and w2 through TMA, the
    # biases in pairs of values
    pair = 2 * x.element_size()
    for name, t, nbytes in (
            ("ffn_ln_geglu: x", x, 16), ("ffn_ln_geglu: ln_w", ln_w, 16),
            ("ffn_ln_geglu: ln_b", ln_b, 16), ("ffn_ln_geglu: w1", w1, 16),
            ("ffn_ln_geglu: w2", w2, 16), ("ffn_ln_geglu: b1", b1, pair),
            ("ffn_ln_geglu: b2", b2, pair)):
        require_aligned(t, name, nbytes)
    # s_keep holds the f32 copy of a tensor s alive until the launch
    s_ptr, s_val, s_keep = _scale_operand(s, x, "ffn_ln_geglu")
    out = torch.empty_like(x)
    if m == 0:
        return out
    # one scratch allocation: h (m, inner), then LN(x) (m, k), in x's type
    hbuf = torch.empty((m * (inner + k),), dtype=x.dtype, device=x.device)
    check(getattr(lib("ffn"), _ENTRY[dtype])(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), hbuf.data_ptr(),
        out.data_ptr(), s_ptr, s_val, m, k, inner, float(eps),
        stream_handle(dev)), "ffn_ln_geglu")
    ffn_ln_geglu.launches += 1
    if dtype is torch.float32:
        ffn_ln_geglu.f32_launches += 1
    return out


ffn_ln_geglu.launches = 0
ffn_ln_geglu.f32_launches = 0  # the f32 form's share of ``launches``


# ---------------------------------------------------------------------------
# K6: the FF without the LN, its residual passed in


def ffn_geglu_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """(GEGLU(x Wa + ba, x Wg + bg) W2 + b2).to(x.dtype) + r with the
    kernel's rounding points: products in f32, the GEGLU product and the FF
    output rounded to x.dtype, the residual added in x.dtype."""
    inner = w1.shape[0] // 2
    y1 = x.float() @ w1.float().t() + b1.float()
    h = (y1[:, :inner] * F.gelu(y1[:, inner:])).to(x.dtype).float()
    return (h @ w2.float().t() + b2.float()).to(x.dtype) + r


def ffn_geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              r: torch.Tensor) -> torch.Tensor:
    """x, r: (M, K) -> FF(x) + r, (M, K)."""
    if needs_grad(x, w1, b1, w2, b2, r):
        return FfnGeglu.apply(x, w1, b1, w2, b2, r)
    return _forward_res(x, w1, b1, w2, b2, r)


class FfnGeglu(torch.autograd.Function):
    """K6 forward; the backward recomputes through ``ffn_geglu_plain``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, r):
        ctx.save_for_backward(x, w1, b1, w2, b2, r)
        return _forward_res(x, w1, b1, w2, b2, r)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(ffn_geglu_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad)


_RES_ENTRY = {torch.bfloat16: "llt2i_ffn_geglu",
              torch.float32: "llt2i_ffn_geglu_f32"}


def _forward_res(x, w1, b1, w2, b2, r):
    if not use_kernel(x):
        return ffn_geglu_plain(x, w1, b1, w2, b2, r)
    m, k = x.shape
    inner = w1.shape[0] // 2
    dev = x.get_device()
    dtype = operand_dtype(x)
    for name, t in (("ffn_geglu: x", x), ("ffn_geglu: w1", w1),
                    ("ffn_geglu: b1", b1), ("ffn_geglu: w2", w2),
                    ("ffn_geglu: b2", b2), ("ffn_geglu: r", r)):
        check_operand(t, name, dev, dtype)
    require(w1.shape == (2 * inner, k) and b1.shape == (2 * inner,)
            and w2.shape == (k, inner) and b2.shape == (k,)
            and r.shape == (m, k), "ffn_geglu: shapes")
    # rows of x, w1, h and w2 in whole 16-byte vectors (TMA)
    v = vector_elems(dtype)
    if not (k % v == 0 and inner % v == 0):
        raise ValueError(
            f"ffn_geglu: K={k}, inner={inner} must be multiples of {v}")
    # x, w1 and w2 through TMA, the biases in bf16 pairs or f32 values, r
    # in pairs of values
    for name, t, nbytes in (
            ("ffn_geglu: x", x, 16), ("ffn_geglu: w1", w1, 16),
            ("ffn_geglu: w2", w2, 16), ("ffn_geglu: b1", b1, 4),
            ("ffn_geglu: b2", b2, 4), ("ffn_geglu: r", r, 2 * x.element_size())):
        require_aligned(t, name, nbytes)
    out = torch.empty_like(x)
    if m == 0:
        return out
    hbuf = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    check(getattr(lib("ffn"), _RES_ENTRY[dtype])(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), r.data_ptr(), hbuf.data_ptr(), out.data_ptr(), m, k,
        inner, stream_handle(dev)), "ffn_geglu")
    ffn_geglu.launches += 1
    if dtype is torch.float32:
        ffn_geglu.f32_launches += 1
    return out


ffn_geglu.launches = 0
ffn_geglu.f32_launches = 0  # the f32 form's share of ``launches``


# ---------------------------------------------------------------------------
# K7: K4 on int8 weights


def ffn_ln_geglu_q_plain(x: torch.Tensor, ln_w: torch.Tensor,
                         ln_b: torch.Tensor, q1: torch.Tensor,
                         s1: torch.Tensor, b1: torch.Tensor, q2: torch.Tensor,
                         s2: torch.Tensor, b2: torch.Tensor, s: Scale = 1.0,
                         eps: float = LN_EPS) -> torch.Tensor:
    """x + s * FF(LN(x)) on int8 weights with each scale applied after its
    dot, as ``_ffn_ln_q_ref`` (ffn.py:433) mirrors the kernel: a = (LN(x)
    Qa) * sa + ba, y = (h Q2) * s2 + b2, out = (y * s).to(x.dtype) + x. The
    dots stay in f32 (the kernels' accumulators; the JAX reference rounds
    them to x.dtype, which in f32 is the same)."""
    inner = q1.shape[0] // 2
    y1 = _ln_rounded(x, ln_w, ln_b, eps) @ q1.float().t()
    a = y1[:, :inner] * s1[:inner].float() + b1[:inner].float()
    g = y1[:, inner:] * s1[inner:].float() + b1[inner:].float()
    h = (a * F.gelu(g)).to(x.dtype).float()
    y = (h @ q2.float().t()) * s2.float() + b2.float()
    return (y * _scale_value(s)).to(x.dtype) + x


_Q_ENTRY = {torch.bfloat16: "llt2i_ffn_ln_geglu_q",
            torch.float32: "llt2i_ffn_ln_geglu_q_f32"}


def ffn_ln_geglu_q(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                   q1: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                   q2: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor,
                   s: Scale = 1.0, eps: float = LN_EPS) -> torch.Tensor:
    """x: (M, K) bf16 or f32 -> x + s * FF(LN(x)) with q1 (2*inner, K) and
    q2 (K, inner) int8, s1 (2*inner,) and s2 (K,) f32. Inference only:
    raises where autograd would record the call."""
    require(not needs_grad(x, ln_w, ln_b, s1, b1, s2, b2, s),
            "ffn_ln_geglu_q: inference only (no VJP, as the JAX package's)")
    if not use_kernel(x):
        return ffn_ln_geglu_q_plain(x, ln_w, ln_b, q1, s1, b1, q2, s2, b2, s,
                                    eps)
    m, k = x.shape
    inner = q1.shape[0] // 2
    dev = x.get_device()
    # x, its LN parameters and biases in x's type; int8 values, f32 scales
    dt, i8, f32 = operand_dtype(x), torch.int8, torch.float32
    for name, t, dtype in (
            ("ffn_ln_geglu_q: x", x, dt), ("ffn_ln_geglu_q: ln_w", ln_w, dt),
            ("ffn_ln_geglu_q: ln_b", ln_b, dt), ("ffn_ln_geglu_q: q1", q1, i8),
            ("ffn_ln_geglu_q: s1", s1, f32), ("ffn_ln_geglu_q: b1", b1, dt),
            ("ffn_ln_geglu_q: q2", q2, i8), ("ffn_ln_geglu_q: s2", s2, f32),
            ("ffn_ln_geglu_q: b2", b2, dt)):
        check_operand(t, name, dev, dtype)
    require(ln_w.shape == (k,) and ln_b.shape == (k,)
            and q1.shape == (2 * inner, k) and s1.shape == (2 * inner,)
            and b1.shape == (2 * inner,) and q2.shape == (k, inner)
            and s2.shape == (k,) and b2.shape == (k,),
            "ffn_ln_geglu_q: weight shapes")
    if not (k % 16 == 0 and inner % 16 == 0):
        raise ValueError(
            f"ffn_ln_geglu_q: K={k}, inner={inner} must be multiples of 16")
    # x, ln_w and ln_b in 16-byte vectors, q1 and q2 through TMA (f32:
    # 16-byte cp.async), the scales in f32 pairs, the biases in bf16 pairs
    # or f32 values
    for name, t, nbytes in (
            ("ffn_ln_geglu_q: x", x, 16), ("ffn_ln_geglu_q: ln_w", ln_w, 16),
            ("ffn_ln_geglu_q: ln_b", ln_b, 16), ("ffn_ln_geglu_q: q1", q1, 16),
            ("ffn_ln_geglu_q: q2", q2, 16), ("ffn_ln_geglu_q: s1", s1, 8),
            ("ffn_ln_geglu_q: s2", s2, 8), ("ffn_ln_geglu_q: b1", b1, 4),
            ("ffn_ln_geglu_q: b2", b2, 4)):
        require_aligned(t, name, nbytes)
    s_ptr, s_val, s_keep = _scale_operand(s, x, "ffn_ln_geglu_q")
    out = torch.empty_like(x)
    if m == 0:
        return out
    # one scratch allocation, as K4's: h (m, inner), then LN(x) (m, k), in
    # x's type
    hbuf = torch.empty((m * (inner + k),), dtype=x.dtype, device=x.device)
    check(getattr(lib("ffn"), _Q_ENTRY[dt])(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), q1.data_ptr(),
        s1.data_ptr(), b1.data_ptr(), q2.data_ptr(), s2.data_ptr(),
        b2.data_ptr(), hbuf.data_ptr(), out.data_ptr(), s_ptr, s_val, m, k,
        inner, float(eps), stream_handle(dev)), "ffn_ln_geglu_q")
    ffn_ln_geglu_q.launches += 1
    if dt is torch.float32:
        ffn_ln_geglu_q.f32_launches += 1
    return out


ffn_ln_geglu_q.launches = 0
ffn_ln_geglu_q.f32_launches = 0  # the f32 form's share of ``launches``
