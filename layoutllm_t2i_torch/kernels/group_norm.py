"""K2: GroupNorm + affine (+SiLU) over channels-last rows (csrc/group_norm.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/norms.py`` ``_gn_pallas`` and
``_gn_pallas_rows`` (their ``_gn_kernel``, ``_gn_stats_kernel`` and
``_gn_apply_kernel``). Differentiable through ``GroupNorm``, whose backward
is the plain version's VJP, as ``_gn_bwd`` (norms.py:294) recomputes it.

``plan_group_norm`` (a function of the shape and the item size alone)
picks the kernel's path: one cluster launch that holds each (sample, slab)
on chip, or two streaming launches where no portable cluster (8 blocks)
holds the slab. ``group_norm_split`` runs the streaming pair on one rank's
block of rows under 'spatial' tensor parallelism: the statistics launch
writes this rank's partials (count, mean, M2 a chunk), a caller's function
gathers every rank's between the two launches, and the apply launch merges
them all by count (Chan's formula; the last chunk of a rank is shorter). The kernels come in bf16 and in f32 (x, weight and bias of
one type, picked from ``x.dtype``); an f32 slab holds half the rows in
shared memory, so more shapes stream.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

from .build import check, lib
from .dispatch import (check_operand, needs_grad, operand_dtype, plain_vjp,
                       require, require_aligned, stream_handle, use_kernel)

# the H100's SMs; a block's dynamic shared memory; what each of two blocks
# resident on one SM can have (228 KB an SM, 1 KB of it reserved a block)
SMS = 132
SMEM_MAX = 232_448            # csrc/group_norm.cu kSmemMax
SMEM_PAIR = (233_472 - 2 * 1024) // 2
THREADS = 256                 # csrc/group_norm.cu kThreads
MAX_CLUSTER = 8               # the portable cluster size, csrc kMaxCluster
MIN_SLAB = 16                 # channels: 32 bytes a row, one memory sector
MIN_ROWS = 16                 # rows a block before a cluster grows for fill
STREAM_BLOCKS = 2 * SMS       # blocks a streaming launch aims at


class GNPlan(NamedTuple):
    """How K2 runs one (N, HW, C, G). ``path`` "cluster": ``cluster``
    blocks of ``rows`` rows per (sample, slab of ``slab`` channels), each
    holding ``cluster_smem_bytes`` of shared memory. ``path`` "stream":
    statistics over slabs of ``slab`` channels in ``chunks`` chunks of
    ``rows`` rows, then the apply pass in blocks of ``apply_rows`` rows."""
    path: str
    slab: int
    cluster: int
    rows: int
    chunks: int
    apply_rows: int


def _round16(b: int) -> int:
    return (b + 15) & ~15


def row_parts(slab: int) -> int:
    """Row parts of the on-chip statistics pass (csrc ``P``): its 8 warps
    take min(slab / 8, 8) vectors of 8 channels at once."""
    return (THREADS // 32) // min(slab // 8, THREADS // 32)


def cluster_smem_bytes(rows: int, slab: int, cg: int, itemsize: int = 2) -> int:
    """Shared memory of one on-chip block (csrc ``ClusterSmem``): the tile
    of ``itemsize``-byte values (2: bf16, 4: f32), the row parts' sums,
    three per-channel and five per-group floats. The planner runs without a
    card, so this mirrors the C layout; the card tests hold it to
    ``llt2i_group_norm_cluster_smem``."""
    return _round16(rows * slab * itemsize) + 4 * (2 * row_parts(slab) * slab
                                                   + 3 * slab + 5 * (slab // cg))


def slabs(c: int, groups: int) -> list:
    """Every slab width: whole groups, a multiple of 8 channels, dividing C."""
    unit = math.lcm(c // groups, 8)
    return [s for s in range(unit, c + 1, unit) if c % s == 0]


def cluster_slab(c: int, groups: int) -> int:
    """The on-chip path's slab: the narrowest of at least MIN_SLAB channels
    (the widest there is where none is that wide)."""
    widths = slabs(c, groups)
    return next((s for s in widths if s >= MIN_SLAB), widths[-1])


@functools.lru_cache(maxsize=4096)
def plan_group_norm(n: int, hw: int, c: int, groups: int,
                    itemsize: int = 2) -> GNPlan:
    """K2's plan for x (n, hw, c) in ``groups`` groups of ``itemsize``-byte
    values (2: bf16, 4: f32; the tile's bytes, nothing else). The slab is the
    narrowest of at least MIN_SLAB channels. A cluster takes the fewest
    blocks whose rows fit shared memory, two blocks an SM where that needs
    no more than MAX_CLUSTER, and, where the clusters alone leave more
    than an eighth of the SMs idle, more blocks (up to MAX_CLUSTER, at
    least MIN_ROWS rows each) until the grid fills the SMs. A slab that no
    cluster of MAX_CLUSTER blocks holds streams. ``cli/group_norm_sweep.py``
    times every plan against this choice on the card."""
    if n < 1 or hw < 1 or not (c % groups == 0 and c % 8 == 0
                               and groups <= 128):
        raise ValueError(f"group_norm: C={c} with {groups} groups over "
                         f"N={n}, HW={hw} is unsupported")
    cg = c // groups
    slab = cluster_slab(c, groups)
    clusters = n * (c // slab)

    def fits(k, limit):
        return cluster_smem_bytes(-(-hw // k), slab, cg, itemsize) <= limit

    sizes = range(1, min(MAX_CLUSTER, hw) + 1)
    k_min = next((k for k in sizes if fits(k, SMEM_MAX)), None)
    if k_min is None:
        return stream_plan(n, hw, c, groups)
    k = next((k for k in sizes[k_min - 1:] if fits(k, SMEM_PAIR)), k_min)
    fill = min(MAX_CLUSTER, -(-SMS // clusters), max(1, hw // MIN_ROWS))
    if 8 * clusters >= 7 * SMS:
        fill = 1  # measured: the barrier costs more than the idle SMs gain
    k = max(k, fill)
    rows = -(-hw // k)
    k = -(-hw // rows)
    return GNPlan("cluster", slab, k, rows, 0, 0)


def stream_plan(n: int, hw: int, c: int, groups: int) -> GNPlan:
    """The streaming path's plan: statistics over whole rows where C <= 2048
    (else the widest slab of at most 2048 channels), in about STREAM_BLOCKS
    blocks; the apply pass in about STREAM_BLOCKS blocks. Its shared memory
    holds f32 sums only, so the item size does not enter it."""
    widths = slabs(c, groups)
    slab = max((s for s in widths if s <= 2048), default=widths[0])
    chunks = min(hw, max(1, -(-STREAM_BLOCKS // (n * (c // slab)))))
    rows = -(-hw // chunks)
    chunks = -(-hw // rows)
    apply_rows = -(-hw // min(hw, max(1, -(-STREAM_BLOCKS // n))))
    return GNPlan("stream", slab, 0, rows, chunks, apply_rows)


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    n, hw, c = x.shape
    xf = x.float().reshape(n, hw, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, hw, c)
    y = y * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_stats_plain(x: torch.Tensor, num_groups: int,
                           rows: int) -> torch.Tensor:
    """(N, G, chunks, 3) f32 partials of x (N, HW, C) over chunks of
    ``rows`` rows (the last one shorter): each chunk's element count, mean
    and sum of squared deviations, as gn_stats_kernel writes them."""
    n, hw, c = x.shape
    cg = c // num_groups
    parts = []
    for r0 in range(0, hw, rows):
        xf = x[:, r0:r0 + rows].float().reshape(n, -1, num_groups, cg)
        mean = xf.mean(dim=(1, 3))
        m2 = ((xf - mean[:, None, :, None]) ** 2).sum(dim=(1, 3))
        cnt = torch.full_like(mean, float(xf.shape[1] * cg))
        parts.append(torch.stack([cnt, mean, m2], dim=-1))
    return torch.stack(parts, dim=2)


def merge_partials(part: torch.Tensor, eps: float):
    """(mean, rstd), each (N, G), of (N, G, chunks, 3) partials merged by
    count, as gn_apply_kernel merges them: mean = sum(cnt mean) / sum(cnt),
    M2 = sum(M2_k + cnt_k (mean_k - mean)^2)."""
    cnt, mean_k, m2_k = part.unbind(-1)
    tot = cnt.sum(-1)
    mean = (cnt * mean_k).sum(-1) / tot
    m2 = (m2_k + cnt * (mean_k - mean[..., None]) ** 2).sum(-1)
    return mean, torch.rsqrt(m2 / tot + eps)


def group_norm_apply_plain(x: torch.Tensor, part: torch.Tensor,
                           weight: torch.Tensor, bias: torch.Tensor,
                           num_groups: int, eps: float,
                           silu: bool) -> torch.Tensor:
    """GroupNorm of x's rows with the statistics of ``part`` (every rank's
    partials), computed in f32."""
    n, hw, c = x.shape
    mean, rstd = merge_partials(part, eps)
    xf = x.float().reshape(n, hw, num_groups, c // num_groups)
    y = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(n, hw, c)
    y = y * weight.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_split(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     num_groups: int, eps: float, silu: bool,
                     gather: Callable[[torch.Tensor], torch.Tensor]
                     ) -> torch.Tensor:
    """GroupNorm of one rank's rows x (N, HW_local, C) with statistics over
    every rank's: K2's statistics launch, ``gather`` of the (N, G, chunks,
    3) partials into every rank's (N, G, world * chunks, 3), K2's apply
    launch. Inference only (no gradient)."""
    n, hw, c = x.shape
    plan = stream_plan(n, hw, c, num_groups)
    if not use_kernel(x):
        part = group_norm_stats_plain(x, num_groups, plan.rows)
        return group_norm_apply_plain(x, gather(part), weight, bias,
                                      num_groups, eps, silu)
    return launch_split(x, weight, bias, num_groups, eps, silu, gather, plan)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """x: (N, HW, C) channels-last rows -> same shape, f32 statistics."""
    if needs_grad(x, weight, bias):
        return GroupNorm.apply(x, weight, bias, num_groups, eps, silu)
    return _forward(x, weight, bias, num_groups, eps, silu)


class GroupNorm(torch.autograd.Function):
    """K2 forward; the backward recomputes through ``group_norm_plain``."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, silu):
        ctx.save_for_backward(x, weight, bias)
        ctx.static = (num_groups, eps, silu)
        return _forward(x, weight, bias, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, grad):
        args = (*ctx.saved_tensors, *ctx.static)
        return plain_vjp(group_norm_plain, args, ctx.needs_input_grad, grad)


def _forward(x, weight, bias, num_groups, eps, silu):
    if not use_kernel(x):
        return group_norm_plain(x, weight, bias, num_groups, eps, silu)
    return launch(x, weight, bias, num_groups, eps, silu)


def launch(x, weight, bias, num_groups, eps, silu, plan: GNPlan = None):
    """K2 on CUDA tensors along ``plan`` (``plan_group_norm``'s by default;
    a test may force either path): one launch on chip, or the two streaming
    launches and their partials. Raises where the kernel cannot launch."""
    n, hw, c = x.shape
    dev, dtype = _checked(x, weight, bias)
    f32 = dtype is torch.float32
    if plan is None:
        plan = plan_group_norm(n, hw, c, num_groups, x.element_size())
    out = torch.empty_like(x)
    gn = lib("group_norm")
    if plan.path == "cluster":
        entry = gn.llt2i_group_norm_cluster_f32 if f32 else gn.llt2i_group_norm_cluster
        err = entry(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, hw, c, num_groups, plan.slab, plan.cluster, plan.rows,
            float(eps), int(silu), stream_handle(dev))
    else:
        part = torch.empty(n * num_groups * plan.chunks * 3,
                           dtype=torch.float32, device=x.device)
        entry = gn.llt2i_group_norm_stream_f32 if f32 else gn.llt2i_group_norm_stream
        err = entry(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            part.data_ptr(), n, hw, c, num_groups, plan.slab, plan.chunks,
            plan.rows, plan.apply_rows, float(eps), int(silu),
            stream_handle(dev))
    check(err, "group_norm")
    group_norm.launches += 1
    if f32:
        group_norm.f32_launches += 1
    return out


def _checked(x, weight, bias):
    """Validate K2's operands; returns (device index, type)."""
    c = x.shape[2]
    dev = x.get_device()
    dtype = operand_dtype(x)
    check_operand(x, "group_norm: x", dev, dtype)
    check_operand(weight, "group_norm: weight", dev, dtype)
    check_operand(bias, "group_norm: bias", dev, dtype)
    require(weight.shape == (c,) and bias.shape == (c,),
            "group_norm: affine params must be (C,)")
    require_aligned(x, "group_norm: x")
    return dev, dtype


def launch_split(x, weight, bias, num_groups, eps, silu, gather,
                 plan: GNPlan):
    """K2's streaming pair on CUDA tensors with the partials crossing ranks
    between its launches: the statistics launch on this rank's rows, then
    ``gather``, then the apply launch over all the gathered partials.
    Counted once in ``group_norm.launches`` and in ``split_launches``."""
    n, hw, c = x.shape
    dev, dtype = _checked(x, weight, bias)
    f32 = dtype is torch.float32
    gn = lib("group_norm")
    part = torch.empty((n, num_groups, plan.chunks, 3), dtype=torch.float32,
                       device=x.device)
    stats = gn.llt2i_group_norm_stats_f32 if f32 else gn.llt2i_group_norm_stats
    check(stats(x.data_ptr(), part.data_ptr(), n, hw, c, num_groups,
                plan.slab, plan.chunks, plan.rows, stream_handle(dev)),
          "group_norm stats")
    every = gather(part).contiguous()
    require(every.shape[:2] == part.shape[:2] and every.shape[3] == 3,
            f"group_norm: gathered partials {tuple(every.shape)}")
    out = torch.empty_like(x)
    apply = gn.llt2i_group_norm_apply_f32 if f32 else gn.llt2i_group_norm_apply
    check(apply(x.data_ptr(), every.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), out.data_ptr(), n, hw, c, num_groups,
                every.shape[2], plan.apply_rows, float(eps), int(silu),
                stream_handle(dev)), "group_norm apply")
    group_norm.launches += 1
    group_norm.split_launches += 1
    if f32:
        group_norm.f32_launches += 1
    return out


group_norm.launches = 0
group_norm.f32_launches = 0  # the f32 form's share of ``launches``
group_norm.split_launches = 0  # the split pair's share (launch_split)
