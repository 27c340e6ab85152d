"""Primitive NN ops as functions over parameter dicts (torch state_dict
names and layouts: conv weights OIHW, linear weights (out, in)).

Activations of the conv/norm layers are logical NCHW tensors in
``torch.channels_last`` memory, so that ``F.conv2d`` runs NHWC and the
GroupNorm kernel sees contiguous (N, H*W, C) rows through a free view.

Every GroupNorm runs through K2 and every LayerNorm through K3; a CPU
tensor takes each kernel's plain version. Eps is per site: 1e-5 for the
UNet ResBlock GroupNorms and every LayerNorm, 1e-6 for the
spatial-transformer and VAE GroupNorms (layoutllm_t2i_tpu/ops/nn.py:12-18).

The feed-forward and projection sites follow the JAX package's routing
(layoutllm_t2i_tpu/ops/nn.py:29-358), predicate for predicate and in the
same fall-through order, with its switches and defaults:

* ``LLT2I_PALLAS_FFN`` (default 1): the fused FF kernels, K4 at an LN + FF
  site, K6 at an FF + residual site, where ``ffn_eligible`` holds;
* ``LLT2I_FFN_LN`` (default 1; 0 splits the LN out: K3, then K6 or the
  dense FF);
* ``LLT2I_FFN_INT8`` (default 0): K7 at the LN + FF sites of an int8 UNet;
  otherwise int8 weights are dequantized at each use site (``weight``);
* ``LLT2I_PALLAS_MATMUL`` (default 0): K8b for the FF up-projection and K8a
  for a ``linear`` of at least 1024 rows, where ``_eligible`` holds.

The JAX package takes these routes on the TPU backend only; the port takes
them for CUDA tensors (``_on_card``). Under ``plain_route()`` a CUDA tensor
keeps its route and each kernel wrapper on it takes its plain version, so
a reference run holds every kernel against its own plain version.

Under the tensor-parallel mode (parallel/tp.py) the convolutions, the
GroupNorms and the upsampling take a rank's block of image rows
('spatial': halo rows, statistics over every rank's rows), and the GEGLU
FF splits its inner dimension ('heads': a rank's slice, then one
all-reduce), where the JAX package states the same layouts as
GSPMD constraints (ops/nn.py:141-145, 239-258). The JAX package turns its
Pallas kernels off under TP (GSPMD cannot partition a custom call); the
port keeps K2, K3, K4 and K7 on a rank's rows under 'spatial', and under
'heads' K2 and K3 on the whole activations and K6 on a rank's inner slice
(its partial sums, with a zero residual and bias): the same function on
the same rows, so the routing is exact. int8 FF weights under 'heads' are
dequantized at their use, as at every other site off K7.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..kernels import (ffn_geglu, ffn_ln_geglu, ffn_ln_geglu_q, geglu_fused,
                       linear_fused)
from ..kernels import group_norm as _group_norm_rows
from ..kernels import layer_norm as _layer_norm_rows
from ..kernels.ffn import ffn_eligible
from ..kernels.group_norm import group_norm_split
from ..kernels.matmul import _eligible
from ..parallel import tp
from .quant import is_quantized

CL = torch.channels_last

Scale = Union[float, torch.Tensor]


def _on_card(x: torch.Tensor) -> bool:
    """The JAX package's ``jax.default_backend() == "tpu"``."""
    return x.device.type == "cuda"


def _pallas_matmul_enabled(x: torch.Tensor) -> bool:
    """K8a/K8b for the big FF sites. Opt-in (LLT2I_PALLAS_MATMUL=1), as in
    the JAX package, where its Pallas GEMM measured slower than XLA's dots
    on the TPU."""
    return os.environ.get("LLT2I_PALLAS_MATMUL", "0") == "1" and _on_card(x)


def _pallas_ffn_enabled(x: torch.Tensor) -> bool:
    """The fused FF kernels (K4, K6, K7). Opt-out (LLT2I_PALLAS_FFN=0)."""
    return os.environ.get("LLT2I_PALLAS_FFN", "1") == "1" and _on_card(x)


def _ffn_ln_enabled() -> bool:
    return os.environ.get("LLT2I_FFN_LN", "1") == "1"


def _get(p, name: str):
    return p[name] if name in p else None


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


def weight(p, dtype: torch.dtype, name: str = "weight") -> torch.Tensor:
    """``p[name]`` in ``dtype``: the one accessor every weight read of the
    model code goes through. An int8 leaf is dequantized here, at its use
    site, as the JAX package's ``QuantTensor.astype`` does."""
    w = p[name]
    if is_quantized(w):
        return w.dequantize(dtype)
    return w.to(dtype)


def _bias(p, dtype: torch.dtype) -> Optional[torch.Tensor]:
    return p["bias"].to(dtype) if "bias" in p else None


def _ffn_quantized(proj, out) -> bool:
    """int8 FF weights skip K4 and K6, as the JAX package's skip its Pallas
    FF kernels (ops/nn.py:102); K7 is their kernel."""
    return (is_quantized(_get(proj, "weight"))
            or is_quantized(_get(out, "weight")))


def _ffn_int8_site(p_ff, p_norm, x: torch.Tensor, s: Scale):
    """K7 for an LN + GEGLU FF + residual site with int8 weights, or None
    where it does not apply. Opt-in (LLT2I_FFN_INT8=1), as in the JAX
    package (ops/nn.py:68)."""
    if os.environ.get("LLT2I_FFN_INT8", "0") != "1":
        return None
    proj, out = p_ff["net"]["0"]["proj"], p_ff["net"]["2"]
    qw, ow = _get(proj, "weight"), _get(out, "weight")
    if not (is_quantized(qw) and is_quantized(ow)):
        return None
    if "bias" not in proj or "bias" not in out:
        return None
    n2, k = qw.shape
    m = _rows(x)
    if not ffn_eligible(m, k, n2 // 2, x.element_size()):
        return None
    y = ffn_ln_geglu_q(x.reshape(m, k).contiguous(), p_norm["weight"],
                       p_norm["bias"], qw.q, qw.scale,
                       proj["bias"].to(x.dtype), ow.q, ow.scale,
                       out["bias"].to(x.dtype), s)
    return y.reshape(x.shape)


def to_rows(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) channels_last -> (N, H*W, C) view."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def from_rows(r: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H*W, C) -> (N, C, H, W) in channels_last memory (a view)."""
    n, _, c = r.shape
    return r.reshape(n, h, w, c).permute(0, 3, 1, 2)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=CL)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x W^T + b on the dense (or dequantized) weight, never a kernel: the
    JAX package's plain dots (its attention projections use these)."""
    return F.linear(x, weight(p, x.dtype), _bias(p, x.dtype))


def linear(p, x: torch.Tensor) -> torch.Tensor:
    n = p["weight"].shape[0]
    if _pallas_matmul_enabled(x):
        m = _rows(x)
        if _eligible(m, x.shape[-1], n):
            y = linear_fused(x.reshape(m, x.shape[-1]).contiguous(),
                             weight(p, x.dtype), _bias(p, x.dtype))
            return y.reshape(*x.shape[:-1], n)
    return dense(p, x)


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """A rank's block of rows under 'spatial' TP convolves with its
    neighbours' halo rows (tp.halo_conv2d)."""
    if tp.row_block(x) is not None:
        return tp.halo_conv2d(x, weight(p, x.dtype), _bias(p, x.dtype),
                              stride, padding)
    y = F.conv2d(x, weight(p, x.dtype), _bias(p, x.dtype), stride=stride,
                 padding=padding)
    return y.contiguous(memory_format=CL)


def group_norm(p, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm(+SiLU) over NCHW channels_last, f32 statistics (K2). On a
    rank's block of rows ('spatial' TP) the statistics cover every rank's
    rows: K2's pair with its partials all-gathered between the launches."""
    h, w = x.shape[2:]
    rows = to_rows(x).contiguous()
    if tp.row_block(x) is not None:
        y = group_norm_split(rows, p["weight"], p["bias"], num_groups, eps,
                             silu, tp.gather_partials)
    else:
        y = _group_norm_rows(rows, p["weight"], p["bias"], num_groups, eps,
                             silu)
    return from_rows(y, h, w)


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, f32 statistics (K3). The affine
    parameters take x's dtype, as the JAX package casts them (an f32
    tokenizer input on a bf16 bundle: the map modalities' ConvNeXt)."""
    c = x.shape[-1]
    y = _layer_norm_rows(x.reshape(-1, c).contiguous(), p["weight"].to(x.dtype),
                         p["bias"].to(x.dtype), eps)
    return y.reshape(x.shape)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form, as the reference's GEGLU


def _inner_block(p_ff):
    """This rank's slice of the FF's inner dimension under 'heads' TP, or
    None where the FF runs whole."""
    return tp.block(p_ff["net"]["2"]["weight"].shape[1])


def _geglu_ff_heads(p, x: torch.Tensor, blk: slice) -> torch.Tensor:
    """geglu_ff on this rank's slice of the inner dimension, a and gate
    each sliced on its own, the down projection's partial sums all-reduced
    and its bias added once (ops/nn.py:239-258 in the JAX package). The
    partial is K6 where eligible, with a zero bias and a zero residual:
    its residual and bias are added after the reduction."""
    proj, out = p["net"]["0"]["proj"], p["net"]["2"]
    w, b = weight(proj, x.dtype), _bias(proj, x.dtype)
    inner = w.shape[0] // 2
    gate_blk = slice(inner + blk.start, inner + blk.stop)
    w2 = weight(out, x.dtype)[:, blk]
    m, k = _rows(x), x.shape[-1]
    if (_pallas_ffn_enabled(x) and not _ffn_quantized(proj, out)
            and b is not None and ffn_eligible(m, k, w2.shape[1])):
        zeros = x.new_zeros((m, k))
        part = ffn_geglu(x.reshape(m, k).contiguous(),
                         torch.cat([w[blk], w[gate_blk]]),
                         torch.cat([b[blk], b[gate_blk]]), w2.contiguous(),
                         zeros[0], zeros).reshape(x.shape)
    else:
        a = F.linear(x, w[blk], None if b is None else b[blk])
        gate = F.linear(x, w[gate_blk], None if b is None else b[gate_blk])
        part = F.linear(a * gelu(gate), w2)
    y = tp.replicate_out(part)
    return y if "bias" not in out else y + out["bias"].to(x.dtype)


def geglu_ff(p, x: torch.Tensor) -> torch.Tensor:
    """FeedForward(glu=True): Linear(d->8d) -> a*gelu(gate) -> Linear(4d->d).
    Under LLT2I_PALLAS_MATMUL=1 the projection is K8b where eligible; under
    'heads' TP a rank computes its slice of the inner dimension."""
    blk = _inner_block(p)
    if blk is not None:
        return _geglu_ff_heads(p, x, blk)
    proj = p["net"]["0"]["proj"]
    if _pallas_matmul_enabled(x):
        n2, k = proj["weight"].shape
        m = _rows(x)
        if _eligible(m, k, n2 // 2):
            h = geglu_fused(x.reshape(m, k).contiguous(), weight(proj, x.dtype),
                            _bias(proj, x.dtype))
            return linear(p["net"]["2"], h.reshape(*x.shape[:-1], n2 // 2))
    a, gate = linear(proj, x).chunk(2, dim=-1)
    return linear(p["net"]["2"], a * gelu(gate))


def geglu_ff_res(p, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """geglu_ff(p, x) + residual: the norm3 site once its LN is split out
    (K6 where eligible)."""
    proj, out = p["net"]["0"]["proj"], p["net"]["2"]
    if (_pallas_ffn_enabled(x) and not _ffn_quantized(proj, out)
            and "bias" in proj and "bias" in out and _inner_block(p) is None):
        n2, k = proj["weight"].shape
        m = _rows(x)
        if ffn_eligible(m, k, n2 // 2):
            y = ffn_geglu(x.reshape(m, k).contiguous(), weight(proj, x.dtype),
                          proj["bias"].to(x.dtype), weight(out, x.dtype),
                          out["bias"].to(x.dtype),
                          residual.reshape(m, k).contiguous())
            return y.reshape(x.shape)
    return geglu_ff(p, x) + residual


def _ffn_ln_site(p_ff, p_norm, x: torch.Tensor, s: Scale):
    """K7 or K4 for ``x + s * geglu_ff(p_ff, layer_norm(p_norm, x))``, or
    None where neither applies (ops/nn.py:304-325, :335-356)."""
    if not (_pallas_ffn_enabled(x) and _ffn_ln_enabled()) or (
            _inner_block(p_ff) is not None):
        return None
    y = _ffn_int8_site(p_ff, p_norm, x, s)
    if y is not None:
        return y
    proj, out = p_ff["net"]["0"]["proj"], p_ff["net"]["2"]
    if _ffn_quantized(proj, out) or "bias" not in proj or "bias" not in out:
        return None
    n2, k = proj["weight"].shape
    m = _rows(x)
    if not ffn_eligible(m, k, n2 // 2):
        return None
    y = ffn_ln_geglu(x.reshape(m, k).contiguous(), p_norm["weight"],
                     p_norm["bias"], weight(proj, x.dtype),
                     proj["bias"].to(x.dtype), weight(out, x.dtype),
                     out["bias"].to(x.dtype), s)
    return y.reshape(x.shape)


def ln_geglu_ff_scaled_res(p_ff, p_norm, x: torch.Tensor,
                           s: Scale) -> torch.Tensor:
    """x + s * geglu_ff(p_ff, layer_norm(p_norm, x)): the gated fusers'
    dense branch (s = fuser_scale * tanh(alpha_dense)), in one K4 (or K7)
    call where eligible."""
    y = _ffn_ln_site(p_ff, p_norm, x, s)
    if y is not None:
        return y
    s = torch.as_tensor(s, dtype=x.dtype, device=x.device)
    return x + s * geglu_ff(p_ff, layer_norm(p_norm, x))


def ln_geglu_ff_res(p_ff, p_norm, x: torch.Tensor) -> torch.Tensor:
    """geglu_ff(p_ff, layer_norm(p_norm, x)) + x: the norm3 site (s = 1)."""
    y = _ffn_ln_site(p_ff, p_norm, x, 1.0)
    if y is not None:
        return y
    return geglu_ff_res(p_ff, layer_norm(p_norm, x), x)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Row-local on a rank's block ('spatial' TP); a whole image whose
    doubled rows split is split here, as the JAX package's next conv
    input would be."""
    y = F.interpolate(x, scale_factor=2, mode="nearest").contiguous(
        memory_format=CL)
    return y if tp.row_block(x) is not None or tp.current_tp() is None \
        else tp.shard_rows(y)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """The mean of each 2x2 patch (layoutllm_t2i_tpu/ops/nn.py:367)."""
    return F.avg_pool2d(x, 2).contiguous(memory_format=CL)
