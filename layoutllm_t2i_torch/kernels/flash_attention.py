"""K1: non-causal flash-attention forward, and K5a/K5b: its backward
(csrc/flash_attention.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/flash_attention.py``: ``_flash_bh``
and its four forward kernels (K1), and the custom VJP's ``_bwd_dq_kernel``
(K5a) and ``_bwd_dkv_kernel`` (K5b). Operands use the packed-head layout
the projections produce, (B, N, H*d), so no transposed copy is made.

``flash_attention`` is differentiable. Where a gradient is needed it runs
``FlashAttention``, an ``autograd.Function`` whose forward also writes the
row log-sum-exp (the JAX forward's ``need_lse``) and saves q, k, v, the
output and the lse: no N x M matrix. Its backward takes
delta = rowsum(dO * O) as one plain reduction, as the JAX package takes it
in XLA, then K5a (dQ) and K5b (dK, dV) recompute the softmax from the lse.
Where no gradient is needed, K1 launches exactly as for inference.

Each kernel comes in bf16 and in f32 (``llt2i_flash_*_f32``: 3xTF32
products on mma.sync, P and dS kept in f32, as the Pallas kernels keep
them in the operands' type), picked from q's dtype; q, k, v and dO share
it. The f32 forms take d 40 and 80 (K1 also 512), the training path's
head dims.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .build import check, lib
from .dispatch import (needs_grad, operand_dtype, require, stream_handle,
                       use_kernel, vector_elems)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H*d) -> (B, H, N, d) f32."""
    b, n, hc = t.shape
    return t.reshape(b, n, heads, hc // heads).transpose(1, 2).float()


def _packed(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, N, d) -> (B, N, H*d) in ``dtype``."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d).to(dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, heads: int, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax(q k^T * scale) v per head, lse (B, H, N) f32), in f32."""
    sim = torch.einsum("bhnc,bhmc->bhnm", _heads(q, heads), _heads(k, heads))
    sim = sim * scale
    lse = torch.logsumexp(sim, dim=-1)
    out = torch.einsum("bhnm,bhmc->bhnc", torch.exp(sim - lse[..., None]),
                       _heads(v, heads))
    return _packed(out, q.dtype), lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v per head, computed in f32."""
    return flash_attention_lse_plain(q, k, v, heads, scale)[0]


def attention_delta(out: torch.Tensor, dout: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head: (B, H, N) f32."""
    b, n, hc = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, n, heads, hc // heads).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              lse: torch.Tensor, delta: torch.Tensor,
                              heads: int, scale: float):
    """(dq, dk, dv) recomputed from the lse, the math of K5a/K5b: S = q k^T
    * scale, P = exp(S - lse), dV = P^T dO, dS = P o (dO V^T - delta),
    dQ = scale dS K, dK = scale dS^T Q; P and dS rounded to the operands'
    dtype before their products, as the kernels round them."""
    qh, kh, vh, doh = (_heads(t, heads) for t in (q, k, v, dout))
    s = torch.einsum("bhnc,bhmc->bhnm", qh, kh) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhnc,bhmc->bhnm", doh, vh)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dv = torch.einsum("bhnm,bhnc->bhmc", p, doh)
    dq = torch.einsum("bhnm,bhmc->bhnc", ds, kh) * scale
    dk = torch.einsum("bhnm,bhnc->bhmc", ds, qh) * scale
    return _packed(dq, q.dtype), _packed(dk, k.dtype), _packed(dv, v.dtype)


# the C entry points of each form: dtype -> (K1, K5a, K5b)
_ENTRY = {torch.bfloat16: ("llt2i_flash_fwd", "llt2i_flash_bwd_dq",
                           "llt2i_flash_bwd_dkv"),
          torch.float32: ("llt2i_flash_fwd_f32", "llt2i_flash_bwd_dq_f32",
                          "llt2i_flash_bwd_dkv_f32")}


def _check_qkv(q, k, v, heads, what):
    """q, k and v of q's operand type (bf16 or f32) on one card, packed
    (B, rows, H*d) with 16-byte aligned rows: strides in whole 16-byte
    vectors of that type (8 bf16, 4 f32). Returns the type."""
    b, _, hc = q.shape
    dev = q.get_device()
    dtype = operand_dtype(q)
    per_vec = vector_elems(dtype)
    name_of = "bf16" if dtype is torch.bfloat16 else "f32"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_cuda and t.get_device() == dev and t.dtype is dtype):
            raise ValueError(f"{what}: {name} must be {name_of} on {q.device}")
        if not (t.dim() == 3 and t.shape[0] == b and t.shape[2] == hc):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)}")
        if (t.stride(2) != 1 or t.stride(1) % per_vec
                or t.stride(0) % per_vec or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} rows must be 16-byte aligned")
    if v.shape[1] != k.shape[1]:
        raise ValueError(f"{what}: k and v lengths differ")
    if hc % heads or (hc // heads) % 8:
        raise ValueError(
            f"{what}: head dim {hc}/{heads} must be a multiple of 8")
    return dtype


def _launch_fwd(q, k, v, heads, scale, need_lse):
    """K1; with ``need_lse`` it also writes the (B, H, N) f32 lse."""
    dtype = _check_qkv(q, k, v, heads, "flash_attention")
    b, n, hc = q.shape
    m = k.shape[1]
    out = torch.empty((b, n, hc), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
           if need_lse else None)
    check(getattr(lib("flash_attention"), _ENTRY[dtype][0])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, heads, n, m, hc // heads,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        float(scale), stream_handle(q.get_device())), "flash_attention")
    flash_attention.launches += 1
    if dtype is torch.float32:
        flash_attention.f32_launches += 1
    return out, lse


def _check_bwd(q, k, v, dout, lse, delta, heads, what):
    """As ``_check_qkv``, and dout contiguous of q's type and shape. Returns
    the operand type."""
    dtype = _check_qkv(q, k, v, heads, what)
    b, n, _ = q.shape
    require(dout.shape == q.shape and dout.dtype == q.dtype
            and dout.is_cuda and dout.get_device() == q.get_device()
            and dout.is_contiguous(),
            f"{what}: dout must be contiguous, of q's dtype and shape")
    for name, t in (("lse", lse), ("delta", delta)):
        require(t.shape == (b, heads, n) and t.dtype == torch.float32
                and t.is_cuda and t.get_device() == q.get_device()
                and t.is_contiguous(),
                f"{what}: {name} must be contiguous f32 (B, H, N)")
    return dtype


def _bwd_args(q, k, v, dout, lse, delta, heads):
    b, n, hc = q.shape
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (b, heads, n, k.shape[1], hc // heads, q.stride(0), q.stride(1),
             k.stride(0), k.stride(1), v.stride(0), v.stride(1)))


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           dout: torch.Tensor, lse: torch.Tensor,
                           delta: torch.Tensor, heads: int,
                           scale: float) -> torch.Tensor:
    """K5a: dQ (B, N, H*d) from the saved lse and delta."""
    if not use_kernel(q):
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads,
                                         scale)[0]
    dtype = _check_bwd(q, k, v, dout, lse, delta, heads,
                       "flash_attention_bwd_dq")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptrs, dims = _bwd_args(q, k, v, dout, lse, delta, heads)
    check(getattr(lib("flash_attention"), _ENTRY[dtype][1])(
        *ptrs, dq.data_ptr(), *dims, float(scale),
        stream_handle(q.get_device())),
        "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    if dtype is torch.float32:
        flash_attention_bwd_dq.f32_launches += 1
    return dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor, heads: int, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5b: (dK, dV), each (B, M, H*d), from the saved lse and delta."""
    if not use_kernel(q):
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads,
                                         scale)[1:]
    dtype = _check_bwd(q, k, v, dout, lse, delta, heads,
                       "flash_attention_bwd_dkv")
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    ptrs, dims = _bwd_args(q, k, v, dout, lse, delta, heads)
    check(getattr(lib("flash_attention"), _ENTRY[dtype][2])(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, float(scale),
        stream_handle(q.get_device())), "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    if dtype is torch.float32:
        flash_attention_bwd_dkv.f32_launches += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 with the lse forward, K5a/K5b backward; on CPU tensors the plain
    versions of both (the backward then is ``flash_attention_bwd_plain``,
    not autograd of the plain forward)."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        # the backward takes the forward's route: autograd runs it on its
        # own thread, which does not see a plain_route() around the call
        ctx.kernel = use_kernel(q)
        if ctx.kernel:
            out, lse = _launch_fwd(q, k, v, heads, scale, need_lse=True)
        else:
            out, lse = flash_attention_lse_plain(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout, ctx.heads)
        if ctx.kernel:
            dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.heads,
                                        ctx.scale)
            dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                             ctx.heads, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                   ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """q: (B, N, H*d); k, v: (B, M, H*d) -> (B, N, H*d)."""
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, heads, scale)
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, heads, scale)
    return _launch_fwd(q, k, v, heads, scale, need_lse=False)[0]


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
# the f32 forms' shares of ``launches``
flash_attention.f32_launches = 0
flash_attention_bwd_dq.f32_launches = 0
flash_attention_bwd_dkv.f32_launches = 0
