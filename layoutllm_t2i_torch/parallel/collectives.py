"""The collectives of the port's parallel paths, on a ``Mesh``.

Only operations that both backends take on the tensors the port hands
them: NCCL on CUDA tensors, gloo on CPU tensors and, where ranks share one
card, on CUDA tensors as they are (all-reduce, broadcast and all-gather;
PyTorch's gloo group copies them through the host itself). gloo takes
neither bf16 nor int16, so a bf16 gather or broadcast moves the bytes and
a bf16 sum runs in f32. A world of one returns its operand. The halo
exchange of the row-split convolutions is an all-gather of each rank's
edge rows (``parallel/tp.py``), so no point-to-point send is needed.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .mesh import Mesh


def _moved(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous; bf16 seen as bytes on gloo (its last dimension
    doubled): a gather or a broadcast moves bits."""
    t = t.contiguous()
    if mesh.backend == "gloo" and t.dtype is torch.bfloat16:
        return t.view(torch.uint8)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), concatenated along
    ``dim`` in rank order, on every rank."""
    if mesh.size == 1:
        return t
    dim = dim % t.dim()
    if dim == t.dim() - 1 and t.dtype is torch.bfloat16:
        raise ValueError("all_gather: bf16 along the last dimension")
    src = _moved(mesh, t)
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=dim).view(t.dtype)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``t`` on every rank (a new tensor). A bf16
    operand is summed in f32 and rounded once."""
    if mesh.size == 1:
        return t
    buf = t.float() if t.dtype is torch.bfloat16 else t.clone()
    dist.all_reduce(buf, group=mesh.group)
    return buf.to(t.dtype)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (a new tensor; every rank passes
    one of the same shape and type)."""
    if mesh.size == 1:
        return t
    buf = _moved(mesh, t).clone()
    dist.broadcast(buf, src, group=mesh.group)
    return buf.view(t.dtype)
