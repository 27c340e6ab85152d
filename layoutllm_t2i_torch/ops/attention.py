"""Multi-head attention core (layoutllm_t2i_tpu/ops/attention.py).

``multi_head_attention`` routes to the flash kernel (K1) exactly where the
JAX package routes to its Pallas flash kernel: no key mask, at least 512
query rows and at least 128 key rows (attention.py:28,42,133-137). Every
other site (the 16^2 and 8^2 levels, text cross-attention with M = 77,
the relation fuser) runs the plain path: an einsum with an f32 softmax,
never a fused library attention. K1 is built for the head dims that the
SD-1.4 geometry routes to it (40, 80 and the VAE's 512); another head dim
routed here raises on the card.

The q/k/v and output projections are plain matmuls on the dense (or
dequantized) weights, as the JAX package's ``attention_with_projections``
computes them with einsums and dots (attention.py:139-183), never through
``nn.linear``: under LLT2I_PALLAS_MATMUL=1 they take no GEMM kernel.
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention
from .nn import dense

_NEG_INF = -1e30
FLASH_MIN_Q_LEN = 512
FLASH_MIN_KV = 128


def attention_with_projections(p, x: torch.Tensor, key: torch.Tensor,
                               value: torch.Tensor, num_heads: int,
                               mask=None) -> torch.Tensor:
    """q/k/v projections, attention, output projection.
    p: {'to_q','to_k','to_v','to_out':{'0'}} in torch-name layout."""
    out = multi_head_attention(dense(p["to_q"], x), dense(p["to_k"], key),
                               dense(p["to_v"], value), num_heads, mask=mask)
    return dense(p["to_out"]["0"], out)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, mask=None) -> torch.Tensor:
    """Scaled dot-product attention over packed heads.

    q: (B, N, H*C); k, v: (B, M, H*C); mask: optional (B, M) key validity.
    Returns (B, N, H*C)."""
    b, n, hc = q.shape
    m = k.shape[1]
    c = hc // num_heads
    scale = c ** -0.5
    if mask is None and n >= FLASH_MIN_Q_LEN and m >= FLASH_MIN_KV:
        return flash_attention(q, k, v, num_heads, scale)
    qh = q.reshape(b, n, num_heads, c)
    kh = k.reshape(b, m, num_heads, c)
    vh = v.reshape(b, m, num_heads, c)
    # f32 scores, as JAX's preferred_element_type=f32 gives them
    sim = torch.einsum("bnhc,bmhc->bhnm", qh.float(), kh.float()) * scale
    if mask is not None:
        sim = sim.masked_fill(~mask.bool()[:, None, None, :], _NEG_INF)
    attn = torch.softmax(sim, dim=-1).to(q.dtype)
    out = torch.einsum("bhnm,bmhc->bnhc", attn, vh)
    return out.reshape(b, n, hc)
