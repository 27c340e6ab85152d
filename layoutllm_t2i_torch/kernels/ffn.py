"""K4: LayerNorm + GEGLU feed-forward + scaled residual (csrc/ffn.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/ffn.py`` ``_ffn_ln_call`` /
``_ffn_ln_kernel`` (``ffn_ln_geglu_fused``, s = 1, and
``ffn_ln_geglu_scaled``). Weights stay in the reference torch layout:
``w1`` is ``net.0.proj.weight`` (2*inner, K) = [Wa; Wg] and ``w2`` is
``net.2.weight`` (K, inner).
"""
from __future__ import annotations

from typing import Union

import torch

from .build import check, lib
from .dispatch import check_operand, require, stream_handle, use_kernel

LN_EPS = 1e-5  # torch nn.LayerNorm default, every reference norm3/norm2 site

Scale = Union[float, torch.Tensor]


def ffn_ln_geglu_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, s: Scale = 1.0,
                       eps: float = LN_EPS) -> torch.Tensor:
    """x + s * (GEGLU(LN(x)) W2 + b2) with the kernel's rounding points:
    LN(x) and the GEGLU product rounded to x.dtype, products in f32."""
    inner = w1.shape[0] // 2
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps) * ln_w.float()
          + ln_b.float()).to(x.dtype).float()
    w1f = w1.float()
    a = xn @ w1f[:inner].t() + b1[:inner].float()
    g = xn @ w1f[inner:].t() + b1[inner:].float()
    h = (a * torch.nn.functional.gelu(g)).to(x.dtype).float()
    y = (h @ w2.float().t() + b2.float()) * (
        s.float() if isinstance(s, torch.Tensor) else float(s))
    return y.to(x.dtype) + x


def ffn_ln_geglu(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, s: Scale = 1.0,
                 eps: float = LN_EPS) -> torch.Tensor:
    """x: (M, K) -> x + s * FF(LN(x)), (M, K). ``s`` is a float or a 0-d
    tensor on x's device (read by the kernel, never synced to the host)."""
    if not use_kernel(x):
        return ffn_ln_geglu_plain(x, ln_w, ln_b, w1, b1, w2, b2, s, eps)
    m, k = x.shape
    inner = w1.shape[0] // 2
    for name, t in (("x", x), ("ln_w", ln_w), ("ln_b", ln_b), ("w1", w1),
                    ("b1", b1), ("w2", w2), ("b2", b2)):
        check_operand(t, f"ffn_ln_geglu: {name}", x.device)
    require(ln_w.shape == (k,) and ln_b.shape == (k,) and b2.shape == (k,)
            and w1.shape == (2 * inner, k) and b1.shape == (2 * inner,)
            and w2.shape == (k, inner), "ffn_ln_geglu: weight shapes")
    require(k % 8 == 0 and inner % 8 == 0,
            f"ffn_ln_geglu: K={k}, inner={inner} must be multiples of 8")
    s_ptr, s_val = None, 1.0
    if isinstance(s, torch.Tensor):
        require(s.numel() == 1 and s.device == x.device,
                "ffn_ln_geglu: s must be a scalar on x's device")
        s = s.reshape(()).to(torch.float32)
        s_ptr = s.data_ptr()
    else:
        s_val = float(s)
    out = torch.empty_like(x)
    if m == 0:
        return out
    hbuf = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    check(lib("ffn").llt2i_ffn_ln_geglu(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), hbuf.data_ptr(),
        out.data_ptr(), s_ptr, s_val, m, k, inner, float(eps),
        stream_handle(x.device)), "ffn_ln_geglu")
    ffn_ln_geglu.launches += 1
    return out


ffn_ln_geglu.launches = 0
