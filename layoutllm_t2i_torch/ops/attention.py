"""Multi-head attention core (layoutllm_t2i_tpu/ops/attention.py).

``multi_head_attention`` routes to the flash kernel (K1) exactly where the
JAX package routes to its Pallas flash kernel: no key mask, at least 512
query rows and at least 128 key rows (attention.py:28,42,133-137). Every
other site (the 16^2 and 8^2 levels, text cross-attention with M = 77,
the relation fuser) runs the plain path: an einsum with an f32 softmax,
never a fused library attention. K1 takes every head dim the Pallas kernel
takes (SD-1.4's 40 and 80 and the VAE's 512; 160 at 768^2's 24^2 sites;
64 and 128 with num_heads 5; 640 and 1280 with num_heads 1, on the
column-group kernels; a d that is not whole 16-byte vectors through a
padded copy, kernels/flash_attention.py), and its backward K5a/K5b every
d as well (past 320 on the column-group kernels: num_heads 1 trains K5 at
d 640).

The q/k/v and output projections are plain matmuls on the dense (or
dequantized) weights, as the JAX package's ``attention_with_projections``
computes them with einsums and dots (attention.py:139-183), never through
``nn.linear``: under LLT2I_PALLAS_MATMUL=1 they take no GEMM kernel.

Under tensor parallelism (parallel/tp.py), 'heads': a rank projects its
heads' columns, attends over them (K1 at H / world heads where the site
is K1's) and projects them out, and the partial outputs are all-reduced
before the bias (attention.py:178-183, 219-232 in the JAX package);
'spatial': a rank's q rows attend to K and V gathered whole (K1 at the
local q rows against every key, the JAX package's ``_tp_spatial_flash``,
attention.py:91-113). The JAX package routes 'heads' through XLA only
because GSPMD cannot partition its Pallas call; a rank's heads are a
whole attention of their own, so K1 on them is exact.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import flash_attention
from ..parallel import tp
from .nn import _bias, dense, weight

_NEG_INF = -1e30
FLASH_MIN_Q_LEN = 512
FLASH_MIN_KV = 128


def attention_with_projections(p, x: torch.Tensor, key: torch.Tensor,
                               value: torch.Tensor, num_heads: int,
                               mask=None,
                               kv_rows: Optional[Tuple[int, int]] = None
                               ) -> torch.Tensor:
    """q/k/v projections, attention, output projection.
    p: {'to_q','to_k','to_v','to_out':{'0'}} in torch-name layout.
    ``kv_rows`` = (local, total) under 'spatial' TP: the first ``local``
    rows of key and value are this rank's block of ``total`` rows (any rows
    after them, every rank holds); K and V are gathered whole after their
    projections."""
    heads = tp.block(num_heads)
    if heads is not None:
        return _heads_attention(p, x, key, value, num_heads, heads, mask)
    k, v = dense(p["to_k"], key), dense(p["to_v"], value)
    if kv_rows is not None:
        local, total = kv_rows
        k, v = (torch.cat([tp.gather_tokens(t[:, :local], total),
                           t[:, local:]], dim=1) for t in (k, v))
    out = multi_head_attention(dense(p["to_q"], x), k, v, num_heads, mask=mask)
    return dense(p["to_out"]["0"], out)


def _heads_attention(p, x, key, value, num_heads: int, heads: slice, mask):
    """attention_with_projections on this rank's ``heads`` ('heads' TP)."""
    dt = x.dtype
    c = p["to_q"]["weight"].shape[0] // num_heads
    cols = slice(heads.start * c, heads.stop * c)

    def project(pp, t):
        b = _bias(pp, dt)
        return F.linear(t, weight(pp, dt)[cols], None if b is None else b[cols])

    out = multi_head_attention(project(p["to_q"], x), project(p["to_k"], key),
                               project(p["to_v"], value),
                               heads.stop - heads.start, mask=mask)
    po = p["to_out"]["0"]
    y = tp.replicate_out(F.linear(out, weight(po, dt)[:, cols]))
    return y if "bias" not in po else y + po["bias"].to(dt)


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
