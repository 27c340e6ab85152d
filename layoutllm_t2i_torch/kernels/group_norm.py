"""K2: GroupNorm + affine (+SiLU) over channels-last rows (csrc/group_norm.cu).

Replaces ``layoutllm_t2i_tpu/ops/pallas/norms.py`` ``_gn_pallas`` and
``_gn_pallas_rows`` (their ``_gn_kernel``, ``_gn_stats_kernel`` and
``_gn_apply_kernel``). Differentiable through ``GroupNorm``, whose backward
is the plain version's VJP, as ``_gn_bwd`` (norms.py:294) recomputes it.

``plan_group_norm`` (a function of the shape alone) picks the kernel's
path: one cluster launch that holds each (sample, slab) on chip, or two
streaming launches where no portable cluster (8 blocks) holds the slab.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .build import check, lib
from .dispatch import (check_operand, needs_grad, plain_vjp, require,
                       require_aligned, stream_handle, use_kernel)

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


def cluster_smem_bytes(rows: int, slab: int, cg: int) -> int:
    """Shared memory of one on-chip block (csrc ``ClusterSmem``): the bf16
    tile, the row parts' sums, three per-channel and five per-group floats.
    The planner runs without a card, so this mirrors the C layout; the card
    tests hold it to ``llt2i_group_norm_cluster_smem``."""
    return _round16(rows * slab * 2) + 4 * (2 * row_parts(slab) * slab
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
def plan_group_norm(n: int, hw: int, c: int, groups: int) -> GNPlan:
    """K2's plan for x (n, hw, c) in ``groups`` groups. The slab is the
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
        return cluster_smem_bytes(-(-hw // k), slab, cg) <= limit

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
    blocks; the apply pass in about STREAM_BLOCKS blocks."""
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
    dev = x.get_device()
    check_operand(x, "group_norm: x", dev)
    check_operand(weight, "group_norm: weight", dev)
    check_operand(bias, "group_norm: bias", dev)
    require(weight.shape == (c,) and bias.shape == (c,),
            "group_norm: affine params must be (C,)")
    require_aligned(x, "group_norm: x")
    if plan is None:
        plan = plan_group_norm(n, hw, c, num_groups)
    out = torch.empty_like(x)
    if plan.path == "cluster":
        err = lib("group_norm").llt2i_group_norm_cluster(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, hw, c, num_groups, plan.slab, plan.cluster, plan.rows,
            float(eps), int(silu), stream_handle(dev))
    else:
        part = torch.empty(n * num_groups * plan.chunks * 3,
                           dtype=torch.float32, device=x.device)
        err = lib("group_norm").llt2i_group_norm_stream(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            part.data_ptr(), n, hw, c, num_groups, plan.slab, plan.chunks,
            plan.rows, plan.apply_rows, float(eps), int(silu),
            stream_handle(dev))
    check(err, "group_norm")
    group_norm.launches += 1
    return out


group_norm.launches = 0
