"""K1: non-causal flash-attention forward (csrc/flash_attention.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/flash_attention.py`` ``_flash_bh``
and its four forward kernels. Operands use the packed-head layout the
projections produce, (B, N, H*d), so no transposed copy is made.
"""
from __future__ import annotations

import torch

from .build import check, lib
from .dispatch import require, stream_handle, use_kernel


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head, computed in f32."""
    b, n, hc = q.shape
    m = k.shape[1]
    c = hc // heads
    qh = q.reshape(b, n, heads, c).float()
    kh = k.reshape(b, m, heads, c).float()
    vh = v.reshape(b, m, heads, c).float()
    sim = torch.einsum("bnhc,bmhc->bhnm", qh, kh) * scale
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhnm,bmhc->bnhc", attn, vh)
    return out.reshape(b, n, hc).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """q: (B, N, H*d); k, v: (B, M, H*d) -> (B, N, H*d)."""
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, heads, scale)
    b, n, hc = q.shape
    m = k.shape[1]
    d = hc // heads
    lib_ = lib("flash_attention")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.device == q.device and t.dtype == torch.bfloat16,
                f"flash_attention: {name} must be bf16 on {q.device}")
        require(t.dim() == 3 and t.shape[0] == b and t.shape[2] == hc,
                f"flash_attention: {name} shape {tuple(t.shape)}")
        require(t.stride(2) == 1 and t.stride(1) % 8 == 0
                and t.stride(0) % 8 == 0 and t.data_ptr() % 16 == 0,
                f"flash_attention: {name} rows must be 16-byte aligned")
    require(v.shape[1] == m, "flash_attention: k and v lengths differ")
    require(hc % heads == 0 and d % 8 == 0,
            f"flash_attention: head dim {hc}/{heads} must be a multiple of 8")
    out = torch.empty((b, n, hc), dtype=q.dtype, device=q.device)
    check(lib_.llt2i_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, heads, n, m, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        float(scale), stream_handle(q.device)), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
