"""The collectives of the port's parallel paths, on a ``Mesh``.

Only operations that both backends take on the tensors the port hands
them: NCCL on CUDA tensors, gloo on CPU tensors and, where ranks share one
card, on CUDA tensors as they are (all-reduce, broadcast and all-gather;
PyTorch's gloo group copies them through the host itself). gloo takes
neither bf16 nor int16, so a bf16 gather or broadcast moves the bytes and
a bf16 sum runs in f32. A world of one returns its operand. The halo
exchange of the row-split convolutions is an all-gather of each rank's
edge rows (``parallel/tp.py``), so no point-to-point send is needed.

Data-parallel training moves lists of tensors: ``all_reduce_mean_``
averages them in place and ``all_gather_slices`` assembles each rank's
slice of each tensor, both through flat buckets of at most ``BUCKET_BYTES``
(a tensor larger than that is reduced in place on its own), so the 272
``rela_fuse`` gradients are a dozen collectives and a full fine-tune's
are never one flat copy. gloo has no reduce-scatter, so ZeRO-1 takes its
slice of an all-reduced gradient (``training/train_step.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

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


BUCKET_BYTES = 64 << 20


def _buckets(tensors: Sequence[torch.Tensor]):
    """Runs of indices into ``tensors`` of one dtype and at most
    ``BUCKET_BYTES`` together (a larger tensor alone), in order within each dtype."""
    open_, out = {}, []
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        idx, size = open_.get(t.dtype, ([], 0))
        if idx and size + nbytes > BUCKET_BYTES:
            out.append(idx)
            idx, size = [], 0
        open_[t.dtype] = (idx + [i], size + nbytes)
    return out + [idx for idx, _ in open_.values() if idx]


@torch.no_grad()
def all_reduce_mean_(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Every tensor of ``tensors`` replaced, in place, by its mean over the
    ranks (each rank passes the same shapes in the same order). A bf16
    bucket is summed in f32."""
    if mesh.size == 1:
        return
    for idx in _buckets(tensors):
        ts = [tensors[i] for i in idx]
        if len(ts) == 1 and ts[0].is_contiguous() and ts[0].dtype is not torch.bfloat16:
            dist.all_reduce(ts[0], group=mesh.group)
            ts[0].div_(mesh.size)
            continue
        wide = torch.float32 if ts[0].dtype is torch.bfloat16 else ts[0].dtype
        flat = torch.cat([t.reshape(-1).to(wide) for t in ts])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


@torch.no_grad()
def all_gather_slices(mesh: Mesh, pieces: Sequence[torch.Tensor],
                      outs: Sequence[torch.Tensor],
                      dims: Sequence[Optional[int]]) -> None:
    """``outs[i]`` filled with every rank's ``pieces[i]``, rank r's at block
    r of ``dims[i]`` (each rank's piece is one equal block; an ``outs``
    tensor may sit on another device). A piece whose dim is None is the
    whole tensor on every rank and is copied as it is."""
    for t, out, d in zip(pieces, outs, dims):
        if (d is None or mesh.size == 1) and t is not out:
            out.copy_(t)
    idx_all = [i for i, d in enumerate(dims) if d is not None]
    if mesh.size == 1 or not idx_all:
        return
    for idx in _buckets([pieces[i] for i in idx_all]):
        idx = [idx_all[j] for j in idx]
        flat = torch.cat([pieces[i].reshape(-1) for i in idx])
        src = _moved(mesh, flat)
        parts = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(parts, src, group=mesh.group)
        for r, part in enumerate(parts):
            part, off = part.view(flat.dtype), 0
            for i in idx:
                t, d = pieces[i], dims[i]
                outs[i].narrow(d, r * t.shape[d], t.shape[d]).copy_(
                    part[off:off + t.numel()].view(t.shape))
                off += t.numel()
