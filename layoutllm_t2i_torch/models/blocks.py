"""GLIGEN / LayoutLLM-T2I transformer blocks (layoutllm_t2i_tpu/models/
blocks.py; reference GLIGEN/ldm/modules/attention.py).

Token activations are (B, H*W, C) rows in row-major pixel order. The
per-step grounding strength ``fuser_scale`` is an argument, replacing the
reference's host-side ``set_alpha_scale`` module mutation. The relation
fuser is vectorized as in the JAX package: a rasterized box mask
(B, MO, H*W) and two batched matmuls, with the reference loop's
break-at-first-degenerate-box semantics as a cumulative product.

Under 'spatial' tensor parallelism (parallel/tp.py) x holds this rank's
block of the ``total`` = h * w visual token rows: self-attention gathers
K and V whole, the gated fusers gather the visual rows' K and V and keep
the grounding tokens (which every rank holds) after them, and the relation
fuser sums its per-object pooling over every rank's rows. The grounding
tokens' own query rows are computed on every rank: the gated
self-attention drops them and gatedSA2 keeps only them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import nn
from ..ops.attention import attention_with_projections
from ..ops.resize import resize_nhwc
from ..parallel import tp
from . import initializers as init


def _kv_rows(n: int, total: Optional[int]):
    """attention_with_projections' ``kv_rows`` for ``n`` local visual rows
    of ``total``: None where they are all of them."""
    return None if total is None or n == total else (n, total)


def cross_attention(p, x, key, value, heads: int, mask=None):
    return attention_with_projections(p, x, key, value, heads, mask=mask)


def self_attention(p, x, heads: int, total: Optional[int] = None):
    """``total``: the token rows in all, where x holds this rank's block."""
    return attention_with_projections(p, x, x, x, heads,
                                      kv_rows=_kv_rows(x.shape[1], total))


def init_cross_attention(ini, query_dim, key_dim, value_dim, heads, d_head):
    inner = heads * d_head
    return {
        "to_q": init.linear_p(ini, query_dim, inner, bias=False),
        "to_k": init.linear_p(ini, key_dim, inner, bias=False),
        "to_v": init.linear_p(ini, value_dim, inner, bias=False),
        "to_out": {"0": init.linear_p(ini, inner, query_dim)},
    }


def init_ff(ini, dim, mult: int = 4):
    inner = dim * mult
    return {"net": {"0": {"proj": init.linear_p(ini, dim, inner * 2)},
                    "2": init.linear_p(ini, inner, dim)}}


# ---------------------------------------------------------------------------
# gated fusers (attention.py:181-281)


def _gate(scale: float, alpha: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(scale * tanh(alpha)) computed in f32 and cast ONCE to the activation
    dtype, as layoutllm_t2i_tpu/models/blocks.py:64 does; leaving either
    factor uncast would promote every activation downstream to f32. A 0-d
    device tensor: the gate never syncs to the host."""
    return (torch.tanh(alpha.float()) * float(scale)).to(dtype)


def _joint_attention(p, x, objs, heads: int, total: Optional[int]):
    """Self-attention over [x; linear(objs)] after norm1, all rows out."""
    objs = nn.linear(p["linear"], objs)
    cat = nn.layer_norm(p["norm1"], torch.cat([x, objs], dim=1))
    return attention_with_projections(p["attn"], cat, cat, cat, heads,
                                      kv_rows=_kv_rows(x.shape[1], total))


def gated_self_attention(p, x, objs, heads: int, scale: float,
                         total: Optional[int] = None):
    n_visual = x.shape[1]
    attn_out = _joint_attention(p, x, objs, heads, total)[:, :n_visual, :]
    x = x + _gate(scale, p["alpha_attn"], x.dtype) * attn_out
    return nn.ln_geglu_ff_scaled_res(p["ff"], p["norm2"], x,
                                     _gate(scale, p["alpha_dense"], x.dtype))


def gated_cross_attention(p, x, objs, heads: int, scale: float,
                          total: Optional[int] = None):
    """The visual rows attend to the grounding tokens (attention.py:181-206)."""
    x = x + _gate(scale, p["alpha_attn"], x.dtype) * cross_attention(
        p["attn"], nn.layer_norm(p["norm1"], x), objs, objs, heads)
    return nn.ln_geglu_ff_scaled_res(p["ff"], p["norm2"], x,
                                     _gate(scale, p["alpha_dense"], x.dtype))


def gated_self_attention2(p, x, objs, heads: int, scale: float,
                          total: Optional[int] = None):
    """The interpolating variant (attention.py:237-281): the grounding
    tokens' rows of the joint self-attention, a square grid, are resized
    to the visual grid (bicubic, as jax.image.resize computes it) and
    added."""
    b, n_visual, _ = x.shape
    n_all = total or n_visual
    n_ground = objs.shape[1]
    size_v = int(round(n_all ** 0.5))
    size_g = int(round(n_ground ** 0.5))
    if size_v * size_v != n_all or size_g * size_g != n_ground:
        raise ValueError(f"gatedSA2: {n_all} visual and {n_ground} "
                         "grounding tokens must both be square grids")
    out = _joint_attention(p, x, objs, heads, total)
    out = out[:, n_visual:, :].reshape(b, size_g, size_g, -1)
    residual = resize_nhwc(out, (size_v, size_v), "bicubic").reshape(b, n_all, -1)
    rows = tp.token_block(n_visual, n_all)
    if rows is not None:
        residual = residual[:, rows]
    x = x + _gate(scale, p["alpha_attn"], x.dtype) * residual
    return nn.ln_geglu_ff_scaled_res(p["ff"], p["norm2"], x,
                                     _gate(scale, p["alpha_dense"], x.dtype))


_FUSERS = {
    "gatedSA": gated_self_attention,
    "gatedSA2": gated_self_attention2,
    "gatedCA": gated_cross_attention,
}


def init_gated_self_attention(ini, query_dim, context_dim, heads, d_head):
    return {
        "linear": init.linear_p(ini, context_dim, query_dim),
        "attn": init_cross_attention(ini, query_dim, query_dim, query_dim,
                                     heads, d_head),
        "ff": init_ff(ini, query_dim),
        "norm1": init.norm_p(ini, query_dim),
        "norm2": init.norm_p(ini, query_dim),
        "alpha_attn": init.scalar_p(ini, 0.0),
        "alpha_dense": init.scalar_p(ini, 0.0),
    }


def init_gated_cross_attention(ini, query_dim, key_dim, value_dim, heads,
                               d_head):
    return {
        "attn": init_cross_attention(ini, query_dim, key_dim, value_dim,
                                     heads, d_head),
        "ff": init_ff(ini, query_dim),
        "norm1": init.norm_p(ini, query_dim),
        "norm2": init.norm_p(ini, query_dim),
        "alpha_attn": init.scalar_p(ini, 0.0),
        "alpha_dense": init.scalar_p(ini, 0.0),
    }


# ---------------------------------------------------------------------------
# relation cross attention (attention.py:284-359), vectorized


def rasterize_boxes(boxes: torch.Tensor, masks: torch.Tensor, h: int, w: int):
    """Per-object region masks on the (h, w) grid.

    boxes: (B, MO, 4) normalized xyxy; masks: (B, MO) 0/1 validity. Returns
    (region (B, MO, h*w) bool, processed (B, MO) bool). Pixel bounds truncate
    toward zero like the reference (attention.py:325-330):
    x in [int(x0*w), int(min(x1*w, w))); the loop stops at the first padded
    or degenerate box, so later boxes are skipped too."""
    b, mo, _ = boxes.shape
    nbox = masks.sum(dim=-1)
    x0 = (boxes[:, :, 0] * w).to(torch.int32)
    y0 = (boxes[:, :, 1] * h).to(torch.int32)
    x1 = torch.clamp(boxes[:, :, 2] * w, max=float(w)).to(torch.int32)
    y1 = torch.clamp(boxes[:, :, 3] * h, max=float(h)).to(torch.int32)
    nondegen = (x0 != x1) & (y0 != y1)
    within = torch.arange(mo, device=boxes.device)[None, :] < nbox[:, None]
    processed = torch.cumprod((nondegen & within).to(torch.int32), dim=1).bool()
    rows = torch.arange(h, device=boxes.device)
    cols = torch.arange(w, device=boxes.device)
    row_in = (rows[None, None, :] >= y0[:, :, None]) & (rows[None, None, :] < y1[:, :, None])
    col_in = (cols[None, None, :] >= x0[:, :, None]) & (cols[None, None, :] < x1[:, :, None])
    region = row_in[:, :, :, None] & col_in[:, :, None, :]
    region = region & processed[:, :, None, None]
    return region.reshape(b, mo, h * w), processed


def relation_cross_attention(p, x, relations, boxes, masks, h: int, w: int,
                             heads: int, scale: float = 1.0):
    """x: (B, h*w, C); relations: (B, R, 768); boxes: (B, MO, 4). Returns the
    fused hidden state; the caller blends (out + x) / 2 (attention.py:398)."""
    mo = boxes.shape[1]
    hidden = nn.layer_norm(p["norm3"], x)
    region, _ = rasterize_boxes(boxes, masks, h, w)
    regionf = region.to(hidden.dtype)
    counts = torch.clamp(regionf.sum(dim=-1), min=1.0)          # (B, MO)
    rows = tp.token_block(x.shape[1], h * w)
    if rows is None:
        obj = torch.bmm(regionf, hidden)
    else:
        # 'spatial' TP: this rank's pixels; the pooled sums over every
        # rank's, in f32 and rounded once, as one bmm rounds them
        regionf = regionf[:, :, rows]
        obj = tp.sum_over_rows(torch.bmm(regionf.float(), hidden.float()))
        obj = obj.to(hidden.dtype)
    obj = obj / counts[..., None]
    attn_out = cross_attention(p["attn"], nn.layer_norm(p["norm1"], obj),
                               relations, relations, heads)
    obj = obj + _gate(scale, p["alpha_attn"], obj.dtype) * attn_out
    obj = obj + _gate(scale, p["alpha_dense"], obj.dtype) * nn.geglu_ff(
        p["ff"], nn.layer_norm(p["norm2"], obj))
    # mean over objects of (hidden + region_i * obj_i) == hidden + scatter/MO
    return hidden + torch.bmm(regionf.transpose(1, 2), obj) / mo


def init_relation_cross_attention(ini, query_dim, key_dim, value_dim, heads,
                                  d_head):
    return {
        "attn": init_cross_attention(ini, query_dim, key_dim, value_dim,
                                     heads, d_head),
        "ff": init_ff(ini, query_dim),
        "norm1": init.norm_p(ini, query_dim),
        "norm2": init.norm_p(ini, query_dim),
        "norm3": init.norm_p(ini, query_dim),
        "alpha_attn": init.scalar_p(ini, 0.0),
        "alpha_dense": init.scalar_p(ini, 0.0),
    }


# ---------------------------------------------------------------------------
# transformer block + spatial transformer (attention.py:362-446); the fuser
# is one of _FUSERS by ``fuser_type``


def basic_transformer_block(p, x, context, objs, relations, boxes, masks,
                            h: int, w: int, heads: int, fuser_scale: float = 1.0,
                            use_rela: bool = True, skip_gated: bool = False,
                            fuser_type: str = "gatedSA"):
    """x: (B, n, C) token rows of an (h, w) image: all h * w of them, or
    this rank's block under 'spatial' TP."""
    total = h * w
    x = self_attention(p["attn1"], nn.layer_norm(p["norm1"], x), heads,
                       total) + x
    if not skip_gated:
        # skip_gated: the sampler knows fuser_scale == 0 for this step, so
        # every gated contribution is x + 0*(...) = x and the fuser's
        # attention and FF are elided bit-exactly
        x = _FUSERS[fuser_type](p["fuser"], x, objs, heads, fuser_scale,
                                total)
    if use_rela:
        # the relation fuser keeps scale=1 always: set_alpha_scale touches
        # only the gated fusers (txt2img.py:46-50)
        x = (relation_cross_attention(p["rela_fuse"], x, relations, boxes,
                                      masks, h, w, heads) + x) / 2
    x = cross_attention(p["attn2"], nn.layer_norm(p["norm2"], x), context,
                        context, heads) + x
    return nn.ln_geglu_ff_res(p["ff"], p["norm3"], x)


def init_basic_transformer_block(ini, query_dim, key_dim, value_dim, heads,
                                 d_head, use_rela: bool = True,
                                 fuser_type: str = "gatedSA"):
    if fuser_type not in _FUSERS:
        raise ValueError(f"unknown fuser_type {fuser_type!r}")
    p = {
        "attn1": init_cross_attention(ini, query_dim, query_dim, query_dim,
                                      heads, d_head),
        "ff": init_ff(ini, query_dim),
        "attn2": init_cross_attention(ini, query_dim, key_dim, value_dim,
                                      heads, d_head),
        "norm1": init.norm_p(ini, query_dim),
        "norm2": init.norm_p(ini, query_dim),
        "norm3": init.norm_p(ini, query_dim),
        "fuser": (init_gated_cross_attention(ini, query_dim, key_dim,
                                             value_dim, heads, d_head)
                  if fuser_type == "gatedCA" else
                  init_gated_self_attention(ini, query_dim, key_dim, heads,
                                            d_head)),
    }
    if use_rela:
        p["rela_fuse"] = init_relation_cross_attention(
            ini, query_dim, key_dim, value_dim, heads, d_head)
    return p


def spatial_transformer(p, x, context, objs, relations, boxes, masks,
                        heads: int, fuser_scale: float = 1.0, depth: int = 1,
                        use_rela: bool = True, skip_gated: bool = False,
                        fuser_type: str = "gatedSA"):
    """x: (B, C, H, W) channels_last, or this rank's block of its rows
    ('spatial' TP). Conv-in/out are 1x1 (attention.py:405-446)."""
    h, w = x.shape[2:]
    rows = tp.row_block(x)
    h_all = h if rows is None else rows[0]
    x_in = x
    x = nn.group_norm(p["norm"], x, eps=1e-6)
    x = nn.to_rows(nn.conv2d(p["proj_in"], x, padding=0))
    for d in range(depth):
        x = basic_transformer_block(
            p["transformer_blocks"][str(d)], x, context, objs, relations,
            boxes, masks, h_all, w, heads, fuser_scale, use_rela=use_rela,
            skip_gated=skip_gated, fuser_type=fuser_type)
    x = nn.conv2d(p["proj_out"], nn.from_rows(x, h, w), padding=0)
    return x + x_in


def init_spatial_transformer(ini, in_channels, key_dim, value_dim, heads,
                             d_head, depth: int = 1, use_rela: bool = True,
                             fuser_type: str = "gatedSA"):
    query_dim = heads * d_head
    return {
        "norm": init.norm_p(ini, in_channels),
        "proj_in": init.conv_p(ini, 1, 1, in_channels, query_dim),
        "transformer_blocks": {
            str(d): init_basic_transformer_block(ini, query_dim, key_dim,
                                                 value_dim, heads, d_head,
                                                 use_rela, fuser_type)
            for d in range(depth)
        },
        "proj_out": init.conv_p(ini, 1, 1, query_dim, in_channels),
    }
