"""Weight-only int8 quantization of the inference path (layoutllm_t2i_tpu/
ops/quant.py), opt-in through ``pipeline/loaders.py quantize_unet_int8``.

Every selected weight is stored as int8 with a symmetric f32 scale per
output channel, amax / 127, rounded half to even and clipped to +-127. The
JAX package quantizes over its last axis, the output channel of its
(in, out) linear and HWIO conv layouts; the port keeps the torch layouts
(linear (out, in), conv OIHW), so its scale runs over axis 0, and q and
scale come out bit-identical to the JAX package's after the layout
transpose. Dequantizing computes ``q * scale`` in f32 and casts once, as
``QuantTensor.astype`` does (bf16 scales would add round-off to int8's).

The model code reads every weight through ``ops.nn.weight``, which
dequantizes a ``QuantTensor`` at its use site; the LN + FF sites of an int8
UNet can instead take K7 (``LLT2I_FFN_INT8=1``), which reads the int8
values and the scales themselves. ``QuantTensor`` has no ``.to()``: a
``ParamTree`` moves its leaves with the device only (``place``), so
``tree.to(torch.bfloat16)`` never turns the f32 scales into bf16.
"""
from __future__ import annotations

from typing import Any, Optional

import torch


class QuantTensor:
    """int8 weight + per-output-channel (axis 0) f32 scale.

    ``q``: int8 in the weight's torch layout; ``scale``: f32 ``(shape[0],)``;
    ``dtype``: the logical dtype a use site dequantizes to by default."""

    __slots__ = ("q", "scale", "dtype")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16):
        self.q = q
        self.scale = scale
        self.dtype = dtype

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def device(self) -> torch.device:
        return self.q.device

    def numel(self) -> int:
        return self.q.numel()

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        s = self.scale.reshape((-1,) + (1,) * (self.q.ndim - 1))
        return (self.q.float() * s).to(dtype or self.dtype)

    def __repr__(self) -> str:
        return f"QuantTensor(shape={tuple(self.q.shape)}, dtype={self.dtype})"


def is_quantized(x: Any) -> bool:
    return isinstance(x, QuantTensor)


def place(leaf, device=None, dtype: Optional[torch.dtype] = None):
    """``leaf`` on ``device``: a dense tensor also cast to ``dtype``; a
    QuantTensor keeps its int8 values and f32 scales and takes ``dtype`` as
    its logical dtype."""
    if is_quantized(leaf):
        return QuantTensor(leaf.q.to(device), leaf.scale.to(device),
                           dtype or leaf.dtype)
    return leaf.to(device=device, dtype=dtype)


def quantize_tensor(w: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> QuantTensor:
    """Symmetric per-output-channel int8 quantization over axis 0."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.ndim)))
    # tensor / tensor: true f32 division (a Python scalar divisor may be
    # taken as a multiplication by its reciprocal), as numpy divides
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale.reshape((-1,) + (1,) * (wf.ndim - 1))),
                    -127, 127).to(torch.int8)
    return QuantTensor(q, scale, dtype or w.dtype)


def _is_node(v) -> bool:
    return isinstance(v, dict) or isinstance(v, torch.nn.Module)


def _map_weights(tree, fn):
    """A tree of the same container type (dict or ParamTree) with every leaf
    replaced by ``fn(key, leaf)``; nothing else is copied."""
    def rec(node):
        return {k: rec(node[k]) if _is_node(node[k]) else fn(k, node[k])
                for k in node.keys()}
    out = rec(tree)
    return out if isinstance(tree, dict) else type(tree)(out)


def quantize_params(tree, min_size: int = 1 << 16,
                    dtype: Optional[torch.dtype] = None):
    """Quantize every ``weight`` leaf with ndim >= 2 and at least
    ``min_size`` elements (the JAX package's rule: norms, embeddings, biases
    and small convs stay dense)."""
    def fn(key, v):
        if (key == "weight" and not is_quantized(v) and v.ndim >= 2
                and v.numel() >= min_size):
            return quantize_tensor(v, dtype)
        return v
    return _map_weights(tree, fn)


def dequantize_params(tree):
    """The inverse of quantize_params: dense leaves at the logical dtype."""
    return _map_weights(tree, lambda _k, v: v.dequantize() if is_quantized(v)
                        else v)


def quantized_bytes(tree) -> int:
    """Device bytes of all leaves: int8 values plus f32 scales for a
    QuantTensor, the dense bytes otherwise."""
    total = 0

    def rec(node):
        nonlocal total
        for k in node.keys():
            v = node[k]
            if _is_node(v):
                rec(v)
            elif is_quantized(v):
                total += v.q.numel() + 4 * v.scale.numel()
            else:
                total += v.numel() * v.element_size()
    rec(tree)
    return total
