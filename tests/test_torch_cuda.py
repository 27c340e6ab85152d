"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``: they carry the
``cuda`` marker and skip where no CUDA device is present. They cover edge
cases the main-path shapes of ``chip_smoke.py`` do not reach: ragged tails
off the block sizes, strided attention operands; for K1's TMA and wgmma
design, operands fenced by NaN and Inf columns and rows (a pad or an
overread turns the output NaN), N and M off both tile sizes, the lse of
the d = 512 head and two launches agreeing bit for bit (a race in the
K/V stage ring would not); odd group widths, K2's on-chip (cluster)
and streaming paths through both C entry points, its ragged last block,
bitwise repeatability, equal inputs in different blocks mapped to equal
outputs, SiLU's negative tail to a bf16 ulp, an operand fenced by NaN,
the planner's copy of the on-chip kernel's shared-memory layout and the
split pair over 2 and 4 blocks of rows (every block's partials handed to
each apply launch, as the ranks' gather does), in bf16 and f32;
wide and narrow LayerNorm rows in bf16 and in f32 (the reward towers'
shapes, a ragged last row block), a partial FF row block; the training path's
kernels: K1's lse output, the K5a/K5b backward at the ragged training
shapes (N = M = 4126 and 1054), on operands fenced by NaN and Inf, into
outputs filled with NaN (every element written, nothing past N, M or d),
and bitwise repeatable over launches, and the gradients of the K1-K4 autograd
Functions against the plain versions on the card; and the opt-in FF and
GEMM kernels K6, K7, K8a and K8b: ragged M, K = 1280 with inner = 5120,
the scale s as a device tensor, int8 weights whose width is not a multiple
of the 32-deep k step, and the gradients of the K6, K8a and K8b Functions;
for K4's, K6's, K8a's and K8b's TMA and wgmma design (gemm_tiles.cuh;
K8b with and without its bias), ragged M, N and K, the grid-fill shape,
operands fenced by NaN and Inf, outputs and scratch pre-filled with NaN,
bitwise repeatability and misaligned operands; the f32 forms of K6, K7,
K8a and K8b (all on tf32_gemm.cuh's TF32 wgmma mainloop, K7 with int8 B
operands) at ragged shapes and
at the f32 generation's and split-route training's shapes, with and
without K8a's bias and residual and K8b's bias, K7's s as a device tensor,
two launches agreeing bit for bit, the size rules and the gradients of the
K6, K8a and K8b Functions in f32; K5a/f32 and K5b/f32 at the f32
training's batch-8 shapes, on strided operands fenced by NaN, into NaN
outputs and a NaN-guarded shared workspace, bit for bit over launches,
past d 320 on the column-group kernels; the TF32 wgmma kernels, K1/f32 at d 512,
K4/f32's and K6/f32's up and down GEMMs and K8a/f32 (tf32_gemm.cuh), at
ragged N, M and K (one row, widths off their tiles,
two heads), with K1's lse, on operands fenced by NaN and Inf, into a NaN
output with a guard, and bit for bit over launches; and one generation of the fast preset (DPM, guidance
interval, encoder cache) at small geometry through K1-K4 against the plain
route.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine need not have). Tolerance: the one ``chip_smoke.py`` states,
from ``layoutllm_t2i_torch/kernels/tolerance.py``.
"""
import importlib
import math

import numpy as np
import pytest
import torch

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.kernels.build import check, lib
from layoutllm_t2i_torch.kernels.dispatch import stream_handle
from layoutllm_t2i_torch.kernels.flash_attention import (FlashAttention, _bwd_args,
                                                         _launch_fwd)
from layoutllm_t2i_torch.kernels.tolerance import agreement

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (Hopper, sm_90)")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return g


def _rand(gen, *shape, scale=1.0, shift=0.0):
    t = torch.randn(*shape, generator=gen, device=gen.device) * scale + shift
    return t.to(torch.bfloat16)


def _check(kid, kernel_fn, plain_fn, counter):
    before = counter.launches
    out = kernel_fn()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    got = agreement(kid, out, plain_fn())
    assert got["ok"], got


@pytest.mark.parametrize("b,n,m,heads,d", [
    (1, 600, 630, 2, 40),     # ragged q and kv tails, padded head dim
    (2, 513, 129, 8, 80),     # one row past a q block, one past a kv block
    (1, 512, 700, 2, 80),
    (1, 520, 600, 1, 512),    # the VAE's single wide head
    # every width: d 20 through the padded copy (24, on the 48 width), 64
    # and 128 (num_heads 5), 96 and 144 (zero columns on the 128 and 160
    # widths), 160 (768^2's 24^2 sites), 256 (on the 512 width)
    (1, 600, 630, 16, 20), (1, 600, 630, 5, 64), (1, 600, 630, 2, 96),
    (1, 600, 630, 5, 128), (1, 600, 630, 2, 144), (2, 576, 606, 8, 160),
    (1, 576, 576, 5, 256),
    # past 512, the column-group kernel (num_heads 1): d 520 (the last
    # group's columns ragged), 640, 1280, and 636 through the padded copy
    (1, 600, 630, 2, 520), (2, 1054, 1054, 1, 640), (1, 606, 606, 1, 1280),
    (1, 600, 630, 2, 636),
])
def test_flash_attention(dev, gen, b, n, m, heads, d):
    q = _rand(gen, b, n, heads * d)
    k = _rand(gen, b, m, heads * d)
    v = _rand(gen, b, m, heads * d)
    s = d ** -0.5
    _check("K1", lambda: K.flash_attention(q, k, v, heads, s),
           lambda: K.flash_attention_plain(q, k, v, heads, s), K.flash_attention)


def test_flash_attention_strided_operands(dev, gen):
    b, n, heads, d = 2, 640, 4, 40
    qkv = _rand(gen, b, n, 3 * heads * d)   # q, k, v as column slices
    q, k, v = qkv.split(heads * d, dim=-1)
    _check("K1", lambda: K.flash_attention(q, k, v, heads, 0.2),
           lambda: K.flash_attention_plain(q, k, v, heads, 0.2), K.flash_attention)


@pytest.mark.parametrize("b,n,m,heads,d", [
    (1, 1, 130, 2, 40),       # one q row; M one tile and two rows
    (1, 1, 130, 2, 80),
    (1, 1, 130, 1, 512),
    (3, 4127, 4126, 8, 40),   # neither a multiple of BQ nor of BK
    (3, 4127, 4126, 8, 80),
    (3, 4127, 4126, 1, 512),
])
def test_flash_attention_ragged_tiles(dev, gen, b, n, m, heads, d):
    q = _rand(gen, b, n, heads * d)
    k = _rand(gen, b, m, heads * d)
    v = _rand(gen, b, m, heads * d)
    s = d ** -0.5
    _check("K1", lambda: K.flash_attention(q, k, v, heads, s),
           lambda: K.flash_attention_plain(q, k, v, heads, s), K.flash_attention)


def _fenced(gen, b, rows, heads, d):
    """A (b, rows, heads*d) column slice of a wider buffer: 8 NaN columns
    before it, 8 Inf columns after it, and 37 more rows of NaN below it
    in every batch element. A kernel that reads a pad column, another
    head's columns or past a row or the last row as data turns NaN."""
    buf = torch.full((b, rows + 37, heads * d + 16), float("nan"),
                     device=gen.device, dtype=torch.bfloat16)
    buf[:, :, heads * d + 8:] = float("inf")
    view = buf[:, :rows, 8:8 + heads * d]
    view.copy_(_rand(gen, b, rows, heads * d))
    return view


@pytest.mark.parametrize("d", [40, 80, 640])
@pytest.mark.parametrize("need_lse", [False, True])
def test_flash_attention_never_reads_outside_its_operands(dev, gen, d, need_lse):
    b, n, m, heads = 2, 700, 650, 4
    q, k, v = (_fenced(gen, b, rows, heads, d) for rows in (n, m, m))
    s = d ** -0.5
    ref_out, ref_lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    before = K.flash_attention.launches
    out, lse = _launch_fwd(q, k, v, heads, s, need_lse)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    got = agreement("K1", out, ref_out)
    assert got["ok"], got
    if need_lse:
        got = agreement("lse", lse, ref_lse)
        assert got["ok"], got


@pytest.mark.parametrize("b,n,m", [(2, 4096, 4096), (1, 520, 600)])
def test_flash_attention_lse_wide_head(dev, gen, b, n, m):
    # the VAE's single head of 512, with its lse: both consumer warpgroups
    # compute S, one writes the lse
    q, k, v, _ = _attention_inputs(gen, b, n, m, 1, 512)
    s = 512 ** -0.5
    out, lse = _launch_fwd(q, k, v, 1, s, need_lse=True)
    ref_out, ref_lse = K.flash_attention_lse_plain(q, k, v, 1, s)
    torch.cuda.synchronize()
    got = agreement(("K1", "lse"), (out, lse), (ref_out, ref_lse))
    assert got["ok"], got


@pytest.mark.parametrize("b,n,m,heads,d", [
    (4, 4126, 4126, 8, 40),
    (4, 1054, 1054, 8, 80),
    (2, 4096, 4096, 1, 512),
    (4, 1054, 1054, 1, 640),   # two column groups, each with its own V ring
])
def test_flash_attention_is_bitwise_repeatable(dev, gen, b, n, m, heads, d):
    # two launches on the same inputs agree bit for bit: a race in the K/V
    # stage ring (a stage refilled before every warp released it) would
    # not
    q = _rand(gen, b, n, heads * d)
    k = _rand(gen, b, m, heads * d)
    v = _rand(gen, b, m, heads * d)
    first = _launch_fwd(q, k, v, heads, d ** -0.5, need_lse=True)
    second = _launch_fwd(q, k, v, heads, d ** -0.5, need_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_flash_attention_uninstantiated_head_dim_raises(dev, gen):
    # K1 takes every head dim (past 512 the column-group kernel), and so
    # does its backward now (past 320 K5's column-group kernels): a num_heads
    # 1 training step's site (d 640 at 512^2's 32^2 sites) raises nowhere,
    # launches K1 once and K5a and K5b once each, and its gradients agree
    # with the plain route's
    q, k, v, dout = _attention_inputs(gen, 1, 512, 512, 1, 640)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = (K.flash_attention.launches, K.flash_attention_bwd_dq.launches,
              K.flash_attention_bwd_dkv.launches)
    out = K.flash_attention(*leaves, 1, 640 ** -0.5)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (K.flash_attention.launches, K.flash_attention_bwd_dq.launches,
            K.flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    with K.plain_route():
        ref = torch.autograd.grad(K.flash_attention(*leaves, 1, 640 ** -0.5),
                                  leaves, dout)
    assert agreement("K5a", grads[0], ref[0])["ok"]
    assert agreement("K5b", grads[1:], ref[1:])["ok"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,m,heads,d", [
    (1, 600, 630, 2, 520), (4, 1054, 1054, 1, 640), (4, 606, 606, 1, 1280),
    (4, 2334, 2334, 1, 640),   # 768^2's gated 48^2 site
])
def test_flash_attention_lse_past_512(dev, gen, dtype, b, n, m, heads, d):
    # the column-group kernels with their lse: every group computes S, the
    # first writes the lse
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _ = (t.to(dtype) for t in _attention_inputs(gen, b, n, m, heads, d))
    s = d ** -0.5
    f32 = "/f32" if dtype is torch.float32 else ""
    before = K.flash_attention.launches
    out, lse = _launch_fwd(q, k, v, heads, s, need_lse=True)
    ref = K.flash_attention_lse_plain(q, k, v, heads, s)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    got = agreement((f"K1{f32}", f"lse{f32}"), (out, lse), ref)
    assert got["ok"], got


@pytest.mark.parametrize("n,hw,c,groups", [
    (3, 49, 96, 32),       # three channels a group, ragged row chunks
    (1, 4096, 64, 32),
    (2, 1, 2560, 32),      # one row
    (1, 16384, 128, 8),
])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm(dev, gen, n, hw, c, groups, silu):
    x = _rand(gen, n, hw, c, scale=3.0, shift=1.5)
    w, bias = _rand(gen, c, scale=0.5, shift=1.0), _rand(gen, c, scale=0.5)
    _check("K2", lambda: K.group_norm(x, w, bias, groups, 1e-6, silu),
           lambda: K.group_norm_plain(x, w, bias, groups, 1e-6, silu), K.group_norm)


# K2's two paths (kernels/group_norm.py launch with a forced plan)
GN = importlib.import_module("layoutllm_t2i_torch.kernels.group_norm")


def _gn_operands(gen, n, hw, c):
    x = _rand(gen, n, hw, c, scale=3.0, shift=1.5)
    return x, _rand(gen, c, scale=0.5, shift=1.0), _rand(gen, c, scale=0.5)


def _gn_plan(path, n, hw, c, groups):
    plan = (GN.plan_group_norm(n, hw, c, groups) if path == "cluster"
            else GN.stream_plan(n, hw, c, groups))
    assert plan.path == path
    return plan


@pytest.mark.parametrize("path", ["cluster", "stream"])
def test_group_norm_both_entry_points(dev, gen, path):
    # one shape, through the on-chip and the streaming C entry point
    n, hw, c, groups = 2, 4096, 320, 32
    plan = _gn_plan(path, n, hw, c, groups)
    x, w, bias = _gn_operands(gen, n, hw, c)
    _check("K2", lambda: GN.launch(x, w, bias, groups, 1e-6, True, plan),
           lambda: K.group_norm_plain(x, w, bias, groups, 1e-6, True), K.group_norm)


def _split_run(x, w, bias, groups, silu, world):
    """K2's split pair over ``world`` blocks of x's rows in one process: a
    first pass keeps each block's partials from its statistics launch, the
    second hands every block all of them, as the ranks' gather would."""
    blocks = [b.contiguous() for b in x.chunk(world, dim=1)]
    parts = []

    def keep(part):
        parts.append(part.clone())
        return part

    for b in blocks:
        GN.group_norm_split(b, w, bias, groups, 1e-6, silu, keep)
    every = torch.cat(parts, dim=2)
    before = GN.group_norm.split_launches
    out = torch.cat([GN.group_norm_split(b, w, bias, groups, 1e-6, silu,
                                         lambda part: every)
                     for b in blocks], dim=1)
    torch.cuda.synchronize()
    assert GN.group_norm.split_launches == before + world
    return out


@pytest.mark.parametrize("world,n,hw,c,groups", [
    (2, 2, 4096, 320, 32),   # the UNet's 64^2 level, 2 ranks
    (2, 2, 3002, 128, 32),   # each rank's last statistics chunk ragged
    (4, 1, 1024, 640, 32),
])
@pytest.mark.parametrize("f32", [False, True])
def test_group_norm_split_pair(dev, gen, world, n, hw, c, groups, f32):
    x, w, bias = _gn_operands(gen, n, hw, c)
    if f32:
        x, w, bias = x.float(), w.float(), bias.float()
    out = _split_run(x, w, bias, groups, True, world)
    got = agreement("K2/f32" if f32 else "K2", out,
                    K.group_norm_plain(x, w, bias, groups, 1e-6, True))
    assert got["ok"], got


@pytest.mark.parametrize("n,hw,c,groups", [
    (2, 4097, 96, 32),     # C/G = 3 (24-channel slabs), a ragged last block
])
def test_group_norm_cluster_ragged(dev, gen, n, hw, c, groups):
    plan = _gn_plan("cluster", n, hw, c, groups)
    assert hw % plan.rows and plan.cluster > 1
    x, w, bias = _gn_operands(gen, n, hw, c)
    _check("K2", lambda: K.group_norm(x, w, bias, groups, 1e-6, True),
           lambda: K.group_norm_plain(x, w, bias, groups, 1e-6, True), K.group_norm)


@pytest.mark.parametrize("path,shape", [("cluster", (4, 4096, 960)),
                                        ("stream", (2, 65536, 256))])
def test_group_norm_is_bitwise_repeatable(dev, gen, path, shape):
    # two launches give the same bits (blocks agreeing with each other is
    # test_group_norm_blocks_apply_one_scale)
    plan = _gn_plan(path, *shape, 32)
    x, w, bias = _gn_operands(gen, *shape)
    a = GN.launch(x, w, bias, 32, 1e-5, True, plan)
    b = GN.launch(x, w, bias, 32, 1e-5, True, plan)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("path,shape", [("cluster", (2, 4097, 96)),
                                        ("cluster", (4, 4096, 960)),
                                        ("stream", (2, 65536, 256))])
def test_group_norm_blocks_apply_one_scale(dev, gen, path, shape):
    # each channel holds two values, the second's share growing along the
    # rows, so the blocks' own statistics differ widely; every block (of a
    # cluster, or of the streaming apply pass) must map each value to the
    # same output bits, which a block on statistics other than the others'
    # would not
    n, hw, c = shape
    plan = _gn_plan(path, n, hw, c, 32)
    assert (plan.cluster if path == "cluster" else -(-hw // plan.apply_rows)) > 1
    r = torch.arange(hw, device=dev, dtype=torch.float32)
    second = ((r * 0.6180339887) % 1.0) < (r + 0.5) / hw
    a = _rand(gen, n, 1, c, scale=2.0)
    b = (a.float() + _rand(gen, n, 1, c).float().abs() + 0.25).to(torch.bfloat16)
    x = torch.where(second[None, :, None], b, a)
    w, bias = _rand(gen, c, scale=0.5, shift=1.0), _rand(gen, c, scale=0.5)
    y = GN.launch(x, w, bias, 32, 1e-5, True, plan)
    torch.cuda.synchronize()
    for rows in (second, ~second):
        ys = y[:, rows]
        assert torch.equal(ys, ys[:, :1].expand_as(ys))
    got = agreement("K2", y, K.group_norm_plain(x, w, bias, 32, 1e-5, True))
    assert got["ok"], got


@pytest.mark.parametrize("path", ["cluster", "stream"])
def test_group_norm_silu_tail(dev, gen, path):
    # rows a ramp and gamma 9: the normalised values span about [-15.6,
    # 15.6]; SiLU's negative tail (-2.7e-3 at -8, -4.6e-6 at -15) must hold
    # to a bf16 ulp of the plain version, not to K2's absolute 1e-2
    n, hw, c = 2, 4096, 320
    plan = _gn_plan(path, n, hw, c, 32)
    ramp = torch.linspace(-1.0, 1.0, hw, device=dev)
    x = (ramp[None, :, None] + 0.01 * _rand(gen, n, hw, c).float()).to(torch.bfloat16)
    w = torch.full((c,), 9.0, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(c, device=dev, dtype=torch.bfloat16)
    y = GN.launch(x, w, bias, 32, 1e-5, True, plan)
    ref = K.group_norm_plain(x, w, bias, 32, 1e-5, True)
    assert ref.float().min() < -0.27 and (ref.float().abs() < 1e-5).any()
    torch.testing.assert_close(y.float(), ref.float(), rtol=2 ** -7, atol=1e-4)


def test_group_norm_smem_mirror(dev):
    # the planner's cluster_smem_bytes against the C layout and limit, at
    # both item sizes (bf16 and f32 tiles), every slab of each group width
    # up to 640 channels, rows up to and one past the most a block holds
    smem = lib("group_norm").llt2i_group_norm_cluster_smem
    for item in (2, 4):
        for cg in (1, 2, 3, 4, 8, 10, 16, 20, 30, 40, 60, 80):
            for slab in range(math.lcm(cg, 8), 641, math.lcm(cg, 8)):
                most = GN.SMEM_MAX // (item * slab)
                while GN.cluster_smem_bytes(most, slab, cg, item) > GN.SMEM_MAX:
                    most -= 1
                for rows in (1, 31, 32, 205, most // 2, most, most + 1):
                    py = GN.cluster_smem_bytes(rows, slab, cg, item)
                    want = py if py <= GN.SMEM_MAX else -1
                    assert smem(rows, slab, cg, item) == want, (rows, slab, cg, item)


@pytest.mark.parametrize("path,shape", [("cluster", (4, 1024, 640)),
                                        ("stream", (2, 65536, 256))])
def test_group_norm_fenced_operand(dev, gen, path, shape):
    # x a slice of a larger buffer whose neighbours are NaN: a read past
    # either end of x turns the output NaN
    n, hw, c = shape
    guard = 4096
    buf = torch.full((n * hw * c + 2 * guard,), float("nan"), device=dev,
                     dtype=torch.bfloat16)
    x = buf[guard:guard + n * hw * c].view(n, hw, c)
    x.copy_(_rand(gen, n, hw, c, scale=3.0, shift=1.5))
    w, bias = _rand(gen, c, scale=0.5, shift=1.0), _rand(gen, c, scale=0.5)
    plan = _gn_plan(path, n, hw, c, 32)
    out = GN.launch(x, w, bias, 32, 1e-6, False, plan)
    torch.cuda.synchronize()
    assert not out.isnan().any()
    got = agreement("K2", out, K.group_norm_plain(x, w, bias, 32, 1e-6, False))
    assert got["ok"], got


@pytest.mark.parametrize("rows,c", [(1, 8), (7, 1000), (33, 2048), (4126, 320)])
def test_layer_norm(dev, gen, rows, c):
    x = _rand(gen, rows, c, scale=2.0, shift=0.5)
    w, bias = _rand(gen, c, scale=0.5, shift=1.0), _rand(gen, c, scale=0.5)
    _check("K3", lambda: K.layer_norm(x, w, bias, 1e-5),
           lambda: K.layer_norm_plain(x, w, bias, 1e-5), K.layer_norm)


@pytest.mark.parametrize("m,k", [(100, 320), (64, 72), (130, 640)])
@pytest.mark.parametrize("scale", [1.0, "tensor"])
def test_ffn_ln_geglu(dev, gen, m, k, scale):
    inner = 4 * k
    x = _rand(gen, m, k)
    lw, lb = _rand(gen, k, scale=0.2, shift=1.0), _rand(gen, k, scale=0.2)
    w1, b1 = _rand(gen, 2 * inner, k, scale=k ** -0.5), _rand(gen, 2 * inner, scale=0.1)
    w2, b2 = _rand(gen, k, inner, scale=inner ** -0.5), _rand(gen, k, scale=0.1)
    s = torch.tensor(0.37, device=dev) if scale == "tensor" else scale
    _check("K4", lambda: K.ffn_ln_geglu(x, lw, lb, w1, b1, w2, b2, s),
           lambda: K.ffn_ln_geglu_plain(x, lw, lb, w1, b1, w2, b2, s), K.ffn_ln_geglu)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_past_2048_names_queue_2(dev, gen, dtype):
    # K3's widest row is 2048 (the Pallas kernel takes any C): past it the
    # wrapper raises naming ROADMAP.md's Queue 2 item, before any launch
    x = _rand(gen, 8, 2560).to(dtype)
    w, bias = _rand(gen, 2560).to(dtype), _rand(gen, 2560).to(dtype)
    before = K.layer_norm.launches
    with pytest.raises(ValueError, match="ROADMAP.md Queue 2: K3 past C 2048"):
        K.layer_norm(x, w, bias, 1e-5)
    assert K.layer_norm.launches == before


def test_cuda_tensor_never_takes_the_plain_version(dev):
    x = torch.randn(4, 16, device=dev).half()  # f16: no kernel takes it
    with pytest.raises(ValueError, match="dtype"):
        K.layer_norm(x, torch.ones(16, device=dev).half(),
                     torch.zeros(16, device=dev).half())


@pytest.mark.parametrize("rows,c", [(2056, 1024), (8, 1024), (616, 768),
                                    (6160, 768), (771, 1024), (1, 4),
                                    (7, 1000), (33, 2048)])
def test_layer_norm_f32(dev, gen, rows, c):
    """K3's f32 form at the reward towers' shapes (771 = 3 x 257 rows: a
    ragged last block of 8 rows) and at the widths' edges."""
    x = _rand(gen, rows, c, scale=2.0, shift=0.5).float()
    w = _rand(gen, c, scale=0.5, shift=1.0).float()
    bias = _rand(gen, c, scale=0.5).float()
    before = K.layer_norm.f32_launches
    _check("K3", lambda: K.layer_norm(x, w, bias, 1e-5),
           lambda: K.layer_norm_plain(x, w, bias, 1e-5), K.layer_norm)
    assert K.layer_norm.f32_launches == before + 1


def test_layer_norm_f32_refuses_mixed_types_and_widths(dev):
    x = torch.randn(4, 1022, device=dev)
    w, b = torch.ones(1022, device=dev), torch.zeros(1022, device=dev)
    with pytest.raises(ValueError, match="C=1022 is unsupported"):
        K.layer_norm(x, w, b)
    x = torch.randn(4, 16, device=dev)
    with pytest.raises(ValueError, match="layer_norm: weight: dtype "
                       "torch.bfloat16, expected torch.float32"):
        K.layer_norm(x, torch.ones(16, device=dev, dtype=torch.bfloat16),
                     torch.zeros(16, device=dev))


# (operand, fault): a CPU x is no fault (it takes the plain version)
@pytest.mark.parametrize("operand,fault", [
    ("weight", "cpu"), ("bias", "cpu"), ("x", "f16"), ("weight", "f32"),
    ("bias", "f32"), ("x", "strided"), ("weight", "strided"),
    ("bias", "strided")])
def test_layer_norm_host_path_still_checks_every_operand(dev, gen, operand,
                                                          fault):
    # the host path's cheaper checks (a device index, a dtype identity, no
    # torch.device built) raise as before, and nothing launches
    args = {"x": _rand(gen, 64, 320), "weight": _rand(gen, 320),
            "bias": _rand(gen, 320)}
    t = args[operand]
    if fault == "cpu":
        t, match = t.cpu(), "on cpu, expected cuda:0"
    elif fault == "f32":
        t, match = t.float(), "dtype torch.float32, expected torch.bfloat16"
    elif fault == "f16":  # K3 takes bf16 or f32 x, nothing else
        t, match = t.half(), "dtype torch.float16, expected torch.bfloat16"
    elif t.dim() == 2:  # the same values, column-major
        t, match = t.t().contiguous().t(), "must be contiguous"
    else:  # every other element of a buffer twice as long
        t, match = torch.stack([t, t], -1).flatten()[::2], "must be contiguous"
    args[operand] = t
    before = K.layer_norm.launches
    with pytest.raises(ValueError, match=f"layer_norm: {operand}: {match}"):
        K.layer_norm(args["x"], args["weight"], args["bias"], 1e-5)
    assert K.layer_norm.launches == before


def _attention_inputs(gen, b, n, m, heads, d, scale=1.0):
    q = _rand(gen, b, n, heads * d, scale=scale)
    k = _rand(gen, b, m, heads * d, scale=scale)
    v = _rand(gen, b, m, heads * d)
    dout = _rand(gen, b, n, heads * d, scale=0.1)
    return q, k, v, dout


TRAIN_SHAPES = [
    (1, 4126, 4126, 8, 40),   # the gated 64^2 site: ragged q and kv tails
    (2, 1054, 1054, 8, 80),   # the gated 32^2 site
    (1, 600, 630, 2, 40),     # tails off the 64-row tiles
    (2, 513, 129, 8, 80),     # one row past a q tile, one past a kv tile
]


@pytest.mark.parametrize("b,n,m,heads,d", TRAIN_SHAPES)
def test_flash_attention_lse(dev, gen, b, n, m, heads, d):
    q, k, v, _ = _attention_inputs(gen, b, n, m, heads, d)
    s = d ** -0.5
    before = K.flash_attention.launches
    q.requires_grad_()
    out = FlashAttention.apply(q, k, v, heads, s)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    ref_out, ref_lse = K.flash_attention_lse_plain(q.detach(), k, v, heads, s)
    got = agreement("K1", out.detach(), ref_out)
    assert got["ok"], got
    # the lse is saved for backward: recover it from the graph
    lse = out.grad_fn.saved_tensors[4]
    got = agreement("lse", lse, ref_lse)
    assert got["ok"], got


@pytest.mark.parametrize("b,n,m,heads,d", TRAIN_SHAPES)
def test_flash_attention_backward(dev, gen, b, n, m, heads, d):
    q, k, v, dout = _attention_inputs(gen, b, n, m, heads, d)
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, s)
    _check("K5a", lambda: K.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                                    heads, s),
           lambda: ref[0], K.flash_attention_bwd_dq)
    _check("K5b", lambda: K.flash_attention_bwd_dkv(q, k, v, dout, lse,
                                                     delta, heads, s),
           lambda: ref[1:], K.flash_attention_bwd_dkv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,m,heads,d", [
    (1, 600, 630, 16, 20), (1, 600, 630, 5, 64), (1, 600, 630, 2, 96),
    (2, 1054, 1054, 5, 128), (1, 600, 630, 2, 144), (2, 576, 606, 8, 160),
    (1, 600, 630, 2, 168), (2, 576, 606, 5, 256), (1, 600, 630, 2, 300),
    (2, 1054, 1054, 2, 320),
    # past 320, the column-group kernels: d 328 (two groups of 168, the
    # last ragged), 640 (2 x 320) and 1280 (4 x 320), one head each at the
    # num_heads 1 sites' lengths
    (1, 600, 630, 2, 328), (2, 1054, 1054, 1, 640), (1, 576, 606, 1, 1280),
])
def test_flash_attention_backward_head_dims(dev, gen, b, n, m, heads, d, dtype):
    # K5a and K5b at every width past 80 (K5b/f32 at 128 and 160, and K5b
    # at 256, 320 and past 320 in both types, as its dV pass, then its dK
    # pass: one count) and at d on a wider one (20 and bf16 300 through the
    # padded copy), each against the plain backward
    q, k, v, dout = (t.to(dtype) for t in _attention_inputs(gen, b, n, m, heads, d))
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, s)
    tag = "/f32" if dtype is torch.float32 else ""
    for kid, fn, want in (("K5a", K.flash_attention_bwd_dq, ref[0]),
                          ("K5b", K.flash_attention_bwd_dkv, ref[1:])):
        before = fn.launches
        got = agreement(kid + tag, fn(q, k, v, dout, lse, delta, heads, s), want)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got["ok"], got


def test_flash_attention_backward_strided_operands(dev, gen):
    b, n, heads, d = 2, 700, 4, 40
    qkv = _rand(gen, b, n, 3 * heads * d)   # q, k, v as column slices
    q, k, v = qkv.split(heads * d, dim=-1)
    dout = _rand(gen, b, n, heads * d, scale=0.1)
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, 0.2)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, 0.2)
    _check("K5a", lambda: K.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                                    heads, 0.2),
           lambda: ref[0], K.flash_attention_bwd_dq)
    _check("K5b", lambda: K.flash_attention_bwd_dkv(q, k, v, dout, lse,
                                                     delta, heads, 0.2),
           lambda: ref[1:], K.flash_attention_bwd_dkv)


@pytest.mark.parametrize("d", [40, 80])
def test_flash_attention_backward_never_reads_outside_its_operands(dev, gen, d):
    # K5a/K5b read q, k and v through the same TMA maps as K1: fenced by NaN
    # and Inf columns and NaN rows, the gradients stay finite and right
    b, n, m, heads = 2, 700, 650, 4
    q, k, v = (_fenced(gen, b, rows, heads, d) for rows in (n, m, m))
    dout = _rand(gen, b, n, heads * d, scale=0.1)
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, s)
    _check("K5a", lambda: K.flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                                    heads, s),
           lambda: ref[0], K.flash_attention_bwd_dq)
    _check("K5b", lambda: K.flash_attention_bwd_dkv(q, k, v, dout, lse,
                                                     delta, heads, s),
           lambda: ref[1:], K.flash_attention_bwd_dkv)


def _bwd_into_nan(q, k, v, dout, lse, delta, heads, s, guard=4096):
    """K5a and K5b through their C entry points into output buffers filled
    with NaN, each followed by ``guard`` more NaN elements: (dq, dk, dv,
    the three guards)."""
    b, n, hc = q.shape
    m = k.shape[1]
    bufs = [torch.full((b * rows * hc + guard,), float("nan"), device=q.device,
                       dtype=torch.bfloat16) for rows in (n, m, m)]
    ptrs, dims = _bwd_args(q, k, v, dout, lse, delta, heads)
    lib_fa, stream = lib("flash_attention"), stream_handle(q.get_device())
    check(lib_fa.llt2i_flash_bwd_dq(*ptrs, bufs[0].data_ptr(), *dims, float(s),
                                    stream), "flash_attention_bwd_dq")
    check(lib_fa.llt2i_flash_bwd_dkv(*ptrs, bufs[1].data_ptr(),
                                     bufs[2].data_ptr(), *dims, float(s),
                                     stream), "flash_attention_bwd_dkv")
    torch.cuda.synchronize()
    outs = [buf[:-guard].view(b, rows, hc) for buf, rows in zip(bufs, (n, m, m))]
    return outs, [buf[-guard:] for buf in bufs]


@pytest.mark.parametrize("b,n,m,heads,d", [
    (2, 700, 650, 4, 40),     # ragged N and M, the 48-column padded tile
    (2, 650, 700, 4, 80),
    (1, 1, 130, 2, 40),       # one q row
    (1, 130, 2, 2, 80),       # two k rows (with one, dQ is 0 exactly)
    (3, 4127, 4126, 8, 40),   # neither a multiple of a stage nor of 128
])
def test_flash_attention_backward_writes_only_its_outputs(dev, gen, b, n, m,
                                                          heads, d):
    # every element of dQ, dK and dV is written (none stays NaN), nothing
    # past the last row (the guards stay NaN), and no row past N or M nor
    # column past d overwrites another row's or head's values
    q, k, v, dout = _attention_inputs(gen, b, n, m, heads, d)
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, s)
    (dq, dk, dv), guards = _bwd_into_nan(q, k, v, dout, lse, delta, heads, s)
    assert all(bool(g.isnan().all()) for g in guards)
    got = agreement("K5a", dq, ref[0])
    assert got["ok"], got
    got = agreement("K5b", (dk, dv), ref[1:])
    assert got["ok"], got


@pytest.mark.parametrize("b,n,m,heads,d", [
    (4, 4126, 4126, 8, 40),
    (4, 1054, 1054, 8, 80),
])
def test_flash_attention_backward_is_bitwise_repeatable(dev, gen, b, n, m,
                                                        heads, d):
    # each output row is summed by one block in a fixed order: no atomics,
    # so repeated launches agree bit for bit (a race in the stage ring
    # would not)
    q, k, v, dout = _attention_inputs(gen, b, n, m, heads, d)
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    runs = [(K.flash_attention_bwd_dq(q, k, v, dout, lse, delta, heads, s),
             *K.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, heads, s))
            for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], run))


def test_flash_attention_backward_uninstantiated_head_dim_raises(dev, gen):
    # past the widest backward instantiation (320) no wrapper raises any
    # more: d 328 launches the column-group kernels once each (K5b's two
    # passes one count), into outputs filled with NaN whose every element
    # is written, nothing past them
    q, k, v, dout = _attention_inputs(gen, 1, 512, 512, 2, 328)
    s = 328 ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, 2, s)
    delta = K.attention_delta(out, dout, 2)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, 2, s)
    before = (K.flash_attention_bwd_dq.launches, K.flash_attention_bwd_dkv.launches)
    dq = K.flash_attention_bwd_dq(q, k, v, dout, lse, delta, 2, s)
    dk, dv = K.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, 2, s)
    torch.cuda.synchronize()
    assert (K.flash_attention_bwd_dq.launches,
            K.flash_attention_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    assert agreement("K5a", dq, ref[0])["ok"]
    assert agreement("K5b", (dk, dv), ref[1:])["ok"]
    (dq, dk, dv), guards = _bwd_into_nan(q, k, v, dout, lse, delta, 2, s)
    assert all(bool(g.isnan().all()) for g in guards)
    assert agreement("K5a", dq, ref[0])["ok"]
    assert agreement("K5b", (dk, dv), ref[1:])["ok"]


def test_flash_attention_autograd_through_the_kernels(dev, gen):
    """torch.autograd.grad through flash_attention launches K1 once and
    K5a, K5b once each, and agrees with the plain route."""
    q, k, v, dout = _attention_inputs(gen, 2, 1054, 1054, 8, 80)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    K.reset_launches()
    grads = torch.autograd.grad(K.flash_attention(q, k, v, 8, 80 ** -0.5),
                                leaves, dout)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["K1"], counts["K5a"], counts["K5b"]) == (1, 1, 1)
    with K.plain_route():
        ref = torch.autograd.grad(K.flash_attention(q, k, v, 8, 80 ** -0.5),
                                  leaves, dout)
    assert K.launch_counts() == counts
    assert agreement("K5a", grads[0], ref[0])["ok"]
    got = agreement("K5b", grads[1:], ref[1:])
    assert got["ok"], got


def _grads_match(fn, plain, args, counter):
    """The Function's gradients on the card against autograd through the
    plain version: its backward is that same recompute at the same saved
    inputs, so they agree to rounding."""
    leaves = [a for a in args if isinstance(a, torch.Tensor)]
    for t in leaves:
        t.requires_grad_()
    before = counter.launches
    out = fn(*args)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = torch.autograd.grad(plain(*args), leaves, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b)


def test_group_norm_grads(dev, gen):
    x = _rand(gen, 2, 1024, 640, scale=2.0, shift=0.5)
    w, bias = _rand(gen, 640, scale=0.5, shift=1.0), _rand(gen, 640, scale=0.5)
    _grads_match(K.group_norm, K.group_norm_plain, [x, w, bias, 32, 1e-5, True],
                 K.group_norm)


def test_layer_norm_grads(dev, gen):
    x = _rand(gen, 4126, 320, scale=2.0, shift=0.5)
    w, bias = _rand(gen, 320, scale=0.5, shift=1.0), _rand(gen, 320, scale=0.5)
    _grads_match(K.layer_norm, K.layer_norm_plain, [x, w, bias, 1e-5],
                 K.layer_norm)


@pytest.mark.parametrize("scale", [1.0, "tensor"])
def test_ffn_ln_geglu_grads(dev, gen, scale):
    m, k = 1054, 640
    inner = 4 * k
    x = _rand(gen, m, k)
    lw, lb = _rand(gen, k, scale=0.2, shift=1.0), _rand(gen, k, scale=0.2)
    w1, b1 = _rand(gen, 2 * inner, k, scale=k ** -0.5), _rand(gen, 2 * inner, scale=0.1)
    w2, b2 = _rand(gen, k, inner, scale=inner ** -0.5), _rand(gen, k, scale=0.1)
    s = torch.tensor(0.37, device=dev) if scale == "tensor" else scale
    _grads_match(K.ffn_ln_geglu, K.ffn_ln_geglu_plain,
                 [x, lw, lb, w1, b1, w2, b2, s, 1e-5], K.ffn_ln_geglu)


def test_training_runs_f32_on_the_card(dev):
    """TrainStepConfig's default, f32 (the JAX package's), trains on the
    card through the kernels' f32 forms: a step at a geometry whose 32^2
    sites reach K1 with its lse, K5a/K5b and K4, all in f32, against the
    same step under plain_route(); the frozen weights are the masters
    themselves, not an f32 copy."""
    from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule
    from layoutllm_t2i_torch.training.train_step import TrainStep, TrainStepConfig
    from layoutllm_t2i_torch.models.initializers import Init
    from layoutllm_t2i_torch.models.unet import UNetConfig, init_unet_params
    from layoutllm_t2i_torch.utils.trees import ParamTree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # 160 channels in 2 heads: d 80 at the 32^2 sites (1024 tokens, 1054
    # with the grounding tokens), whose FF sites (2048 rows) take K4
    cfg_u = UNetConfig(image_size=32, model_channels=160, num_res_blocks=1,
                       attention_resolutions=(1,), channel_mult=(1, 1),
                       num_heads=2)
    g = torch.Generator(device=dev).manual_seed(0)
    unet = ParamTree(init_unet_params(Init(g, dev, torch.float32), cfg_u))
    for name, p in unet.named_parameters():
        if name.rsplit(".", 1)[-1].startswith("alpha_"):
            p.data.fill_(0.5)
    cfg = TrainStepConfig(unet_cfg=cfg_u, warmup_steps=0,
                          schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012))
    assert not cfg.mixed_precision and cfg.compute_dtype is torch.float32
    step = TrainStep(cfg, unet)
    frozen = dict(unet.named_parameters())
    assert all(t.data_ptr() == frozen[n].data_ptr() for n, t in step._frozen.items())
    b = 2
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    boxes = torch.zeros(b, 30, 4, device=dev)
    boxes[:, 0] = torch.tensor([0.1, 0.2, 0.6, 0.9], device=dev)
    masks = torch.zeros(b, 30, device=dev)
    masks[:, 0] = 1
    batch = {"z": rnd(b, 4, 32, 32).contiguous(memory_format=torch.channels_last),
             "context": rnd(b, 77, 768), "boxes": boxes, "masks": masks,
             "phrase_embeddings": rnd(b, 30, 768), "relations": rnd(b, 5, 768)}
    t = torch.tensor([701, 42], device=dev)
    noise = rnd(b, 4, 32, 32).contiguous(memory_format=torch.channels_last)
    keep = torch.ones((), device=dev)
    K.reset_launches()
    loss, grads = step.grads(batch, t, noise, keep)
    torch.cuda.synchronize()
    f32 = K.f32_launch_counts()
    assert all(f32[kid] > 0 for kid in ("K1", "K2", "K3", "K4", "K5a", "K5b")), f32
    assert f32 == {kid: n for kid, n in K.launch_counts().items() if kid in f32}
    with K.plain_route():
        loss_p, grads_p = step.grads(batch, t, noise, keep)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    num = sum(float((a - b_).double().pow(2).sum()) for a, b_ in zip(grads, grads_p))
    den = sum(float(b_.double().pow(2).sum()) for b_ in grads_p)
    assert math.sqrt(num / den) <= 1e-4
    before = [p.detach().clone() for p in step.params.values()]
    gen = torch.Generator(device=dev).manual_seed(1)
    assert torch.isfinite(step(batch, gen))
    assert all(not torch.equal(p, q) for p, q in zip(step.params.values(), before))


# ---------------------------------------------------------------------------
# the f32 forms of K1, K5a/K5b, K2 and K4 (3xTF32 on TF32 wgmma; K2 on f32
# tiles), against the plain versions in full f32


@pytest.fixture
def f32(dev):
    """The plain versions' products in full f32 (no TF32), as chip_smoke
    sets it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.float32


def _check_f32(kid, kernel_fn, plain_fn, counter, kids=None):
    before, before_f32 = counter.launches, counter.f32_launches
    out = kernel_fn()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert counter.f32_launches == before_f32 + 1
    got = agreement(kids or f"{kid}/f32", out, plain_fn())
    assert got["ok"], got


@pytest.mark.parametrize("b,n,m,heads,d", [
    (1, 600, 630, 2, 40), (2, 513, 129, 8, 80), (1, 520, 600, 1, 512),
    (2, 4126, 4126, 8, 40), (1, 4096, 4096, 1, 512),
    # the gated 32^2 site of the f32 generation; 77 keys, one ragged tile
    (4, 1054, 1054, 8, 80), (2, 1024, 77, 8, 80), (2, 4096, 77, 8, 40),
    # the widths past 80 and d on a wider one: 20 (the 40 width), 96 (128),
    # 144 (160), 256 (512)
    (1, 600, 630, 16, 20), (1, 600, 630, 5, 64), (1, 600, 630, 2, 96),
    (1, 600, 630, 5, 128), (1, 600, 630, 2, 144), (2, 576, 606, 8, 160),
    (1, 576, 576, 5, 256),
    # past 512, the column-group kernel and its pre-pass: d 520, 640, 1280,
    # and 638 through the padded copy
    (1, 600, 630, 2, 520), (2, 1054, 1054, 1, 640), (1, 606, 606, 1, 1280),
    (1, 600, 630, 2, 638),
])
def test_flash_attention_f32(dev, gen, f32, b, n, m, heads, d):
    q, k, v = (_rand(gen, b, r, heads * d).float() for r in (n, m, m))
    s = d ** -0.5
    _check_f32("K1", lambda: K.flash_attention(q, k, v, heads, s),
               lambda: K.flash_attention_plain(q, k, v, heads, s),
               K.flash_attention)


@pytest.mark.parametrize("b,n,m,heads,d", TRAIN_SHAPES + [(4, 4126, 4126, 8, 40)])
def test_flash_attention_lse_f32(dev, gen, f32, b, n, m, heads, d):
    q, k, v, _ = (t.float() for t in _attention_inputs(gen, b, n, m, heads, d))
    s = d ** -0.5
    _check_f32("K1", lambda: _launch_fwd(q, k, v, heads, s, need_lse=True),
               lambda: K.flash_attention_lse_plain(q, k, v, heads, s),
               K.flash_attention, kids=("K1/f32", "lse/f32"))


@pytest.mark.parametrize("b,n,m,heads,d", TRAIN_SHAPES + [
    (8, 4126, 4126, 8, 40), (8, 1054, 1054, 8, 80),    # f32 training's batch
    # past 320, the column-group kernels (and their pre-pass): d 328, 640
    # and 1280 at the num_heads 1 sites' lengths
    (1, 600, 630, 2, 328), (2, 1054, 1054, 1, 640), (1, 576, 606, 1, 1280)])
def test_flash_attention_backward_f32(dev, gen, f32, b, n, m, heads, d):
    q, k, v, dout = (t.float() for t in _attention_inputs(gen, b, n, m, heads, d))
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, s)
    _check_f32("K5a", lambda: K.flash_attention_bwd_dq(q, k, v, dout, lse,
                                                        delta, heads, s),
               lambda: ref[0], K.flash_attention_bwd_dq)
    _check_f32("K5b", lambda: K.flash_attention_bwd_dkv(q, k, v, dout, lse,
                                                         delta, heads, s),
               lambda: ref[1:], K.flash_attention_bwd_dkv)


def _f32_packed(dev, gen, b, n, heads, d, guard=4096):
    """q, k and v f32 column slices of one packed (b, n, 3 H d) buffer (row
    stride 3 H d: a multiple of 4 floats, not of 8) between NaN guards: a
    read past any operand turns the result NaN."""
    buf = torch.full((b * n * 3 * heads * d + 2 * guard,), float("nan"),
                     device=dev)
    qkv = buf[guard:guard + b * n * 3 * heads * d].view(b, n, 3 * heads * d)
    qkv.copy_(_rand(gen, b, n, 3 * heads * d).float())
    return qkv.split(heads * d, dim=-1)


@pytest.mark.parametrize("d", [40, 80])
def test_flash_attention_backward_f32_strided_and_fenced(dev, gen, f32, d):
    # K5a/K5b f32 read q, k and v once, in the pre-pass that splits (and
    # transposes) them into the workspace: strided column slices of one
    # packed buffer, its neighbours NaN, at ragged N and M off every tile
    b, n, heads = 2, 700, 2
    q, k, v = _f32_packed(dev, gen, b, n, heads, d)
    k, v = k[:, :650], v[:, :650]
    dout = _rand(gen, b, n, heads * d, scale=0.1).float()
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, s)
    dq = K.flash_attention_bwd_dq(q, k, v, dout, lse, delta, heads, s)
    dk, dv = K.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, heads, s)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    got = agreement("K5a/f32", dq, ref[0])
    assert got["ok"], got
    got = agreement("K5b/f32", (dk, dv), ref[1:])
    assert got["ok"], got


def _bwd_f32_into_nan(q, k, v, dout, lse, delta, heads, s, guard=4096):
    """K5a/f32 and K5b/f32 through their C entry points, sharing one
    workspace as the autograd backward does (K5a's pre-pass for both), into
    outputs filled with NaN, each followed by ``guard`` more NaN elements,
    and the workspace followed by a NaN guard: (dq, dk, dv), the guards."""
    b, n, hc = q.shape
    m = k.shape[1]
    fa = lib("flash_attention")
    nbytes = fa.llt2i_flash_bwd_f32_ws(b, heads, n, m, hc // heads)
    ws = torch.full((nbytes // 4 + guard,), float("nan"), device=q.device)
    bufs = [torch.full((b * rows * hc + guard,), float("nan"), device=q.device)
            for rows in (n, m, m)]
    ptrs, dims = _bwd_args(q, k, v, dout, lse, delta, heads)
    stream = stream_handle(q.get_device())
    check(fa.llt2i_flash_bwd_dq_f32(*ptrs, bufs[0].data_ptr(), *dims, float(s),
                                    ws.data_ptr(), 3, stream), "K5a/f32")
    check(fa.llt2i_flash_bwd_dkv_f32(*ptrs, bufs[1].data_ptr(),
                                     bufs[2].data_ptr(), *dims, float(s),
                                     ws.data_ptr(), 0, stream), "K5b/f32")
    torch.cuda.synchronize()
    outs = [buf[:-guard].view(b, rows, hc) for buf, rows in zip(bufs, (n, m, m))]
    return outs, [buf[-guard:] for buf in bufs + [ws]]


@pytest.mark.parametrize("b,n,m,heads,d", [
    (2, 700, 650, 4, 40), (2, 650, 700, 4, 80),
    (1, 1, 130, 2, 40),       # one q row
    (1, 130, 2, 2, 80),       # two k rows
    (3, 4127, 4126, 8, 40),   # neither a multiple of a stage nor of 128
])
def test_flash_attention_backward_f32_writes_only_its_outputs(dev, gen, f32, b,
                                                              n, m, heads, d):
    # every element of dQ, dK and dV written (none stays NaN), nothing past
    # the last row nor past the workspace (the guards stay NaN), and the
    # shared workspace read by K5b as K5a's pre-pass wrote it
    q, k, v, dout = (t.float() for t in _attention_inputs(gen, b, n, m, heads, d))
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, s)
    (dq, dk, dv), guards = _bwd_f32_into_nan(q, k, v, dout, lse, delta, heads, s)
    assert all(bool(g.isnan().all()) for g in guards)
    got = agreement("K5a/f32", dq, ref[0])
    assert got["ok"], got
    got = agreement("K5b/f32", (dk, dv), ref[1:])
    assert got["ok"], got


@pytest.mark.parametrize("b,n,m,heads,d", [(4, 4126, 4126, 8, 40),
                                            (4, 1054, 1054, 8, 80)])
def test_flash_attention_backward_f32_is_bitwise_repeatable(dev, gen, f32, b, n,
                                                            m, heads, d):
    # each output row summed by one block in a fixed order (at d 80 the two
    # warpgroups' halves added in one order): launches agree bit for bit
    q, k, v, dout = (t.float() for t in _attention_inputs(gen, b, n, m, heads, d))
    s = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, s)
    delta = K.attention_delta(out, dout, heads)
    runs = [(K.flash_attention_bwd_dq(q, k, v, dout, lse, delta, heads, s),
             *K.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, heads, s))
            for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], run))


def test_flash_attention_backward_f32_other_head_dims_raise(dev, gen, f32):
    # past 320 no head dim raises any more: d 328 has a workspace (at d
    # itself: q, dO, k, v split, k, q, dO also transposed) and launches the
    # column-group kernels once each, sharing it as the autograd backward
    # does, into NaN outputs and a NaN-guarded workspace
    q, k, v, dout = (t.float() for t in _attention_inputs(gen, 1, 512, 512, 2, 328))
    s = 328 ** -0.5
    fa = lib("flash_attention")
    assert fa.llt2i_flash_bwd_f32_ws(1, 2, 512, 512, 328) == 4 * 2 * 328 * (
        4 * 512 + 4 * 512 + 2 * 512 + 4 * 512)
    assert fa.llt2i_flash_bwd_f32_ws(1, 2, 512, 512, 320) > 0
    out, lse = K.flash_attention_lse_plain(q, k, v, 2, s)
    delta = K.attention_delta(out, dout, 2)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, 2, s)
    _check_f32("K5a", lambda: K.flash_attention_bwd_dq(q, k, v, dout, lse,
                                                        delta, 2, s),
               lambda: ref[0], K.flash_attention_bwd_dq)
    _check_f32("K5b", lambda: K.flash_attention_bwd_dkv(q, k, v, dout, lse,
                                                         delta, 2, s),
               lambda: ref[1:], K.flash_attention_bwd_dkv)
    (dq, dk, dv), guards = _bwd_f32_into_nan(q, k, v, dout, lse, delta, 2, s)
    assert all(bool(g.isnan().all()) for g in guards)
    assert agreement("K5a/f32", dq, ref[0])["ok"]
    assert agreement("K5b/f32", (dk, dv), ref[1:])["ok"]


@pytest.mark.parametrize("d", [40, 80, 640])
def test_flash_attention_f32_strided_and_fenced(dev, gen, f32, d):
    # q, k and v slices of one packed qkv buffer (row stride 3 H d, a
    # multiple of 4 floats, not of 8) whose neighbours are NaN: a read past
    # any operand (the K/V pre-pass's or a tensor map's) turns the output NaN
    b, n, heads = 2, 700, 2
    guard = 4096
    buf = torch.full((b * n * 3 * heads * d + 2 * guard,), float("nan"),
                     device=dev)
    qkv = buf[guard:guard + b * n * 3 * heads * d].view(b, n, 3 * heads * d)
    qkv.copy_(_rand(gen, b, n, 3 * heads * d).float())
    q, k, v = qkv.split(heads * d, dim=-1)
    out = K.flash_attention(q, k, v, heads, d ** -0.5)
    torch.cuda.synchronize()
    assert not out.isnan().any()
    got = agreement("K1/f32", out, K.flash_attention_plain(q, k, v, heads, d ** -0.5))
    assert got["ok"], got


@pytest.mark.parametrize("b,n,m,heads,d", [(2, 4126, 4126, 8, 40),
                                            (4, 1054, 1054, 8, 80),
                                            (1, 600, 630, 2, 40)])
def test_flash_attention_f32_repeats_bit_for_bit(dev, gen, f32, b, n, m, heads, d):
    # each output row summed by one warp in a fixed order and the workspace
    # written whole by its pre-pass before the main kernel reads it: a stage
    # refilled before its readers left, or a stale workspace slot, would
    # change the bits between launches
    q, k, v = (_rand(gen, b, r, heads * d).float() for r in (n, m, m))
    runs = [_launch_fwd(q, k, v, heads, d ** -0.5, need_lse=True) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.isfinite(runs[0][0]).all()
    for out, lse in runs[1:]:
        assert torch.equal(runs[0][0], out) and torch.equal(runs[0][1], lse)


def test_flash_attention_f32_autograd_through_the_kernels(dev, gen, f32):
    b, n, heads, d = 2, 1054, 8, 80
    leaves = [_rand(gen, b, n, heads * d).float().requires_grad_() for _ in range(3)]
    gout = _rand(gen, b, n, heads * d, scale=0.1).float()
    before = K.f32_launch_counts()
    got = torch.autograd.grad(K.flash_attention(*leaves, heads, d ** -0.5),
                              leaves, gout)
    after = K.f32_launch_counts()
    assert all(after[kid] == before[kid] + 1 for kid in ("K1", "K5a", "K5b"))
    with K.plain_route():
        want = torch.autograd.grad(K.flash_attention(*leaves, heads, d ** -0.5),
                                   leaves, gout)
    for kid, a, w in zip(("K5a", "K5b", "K5b"), got, want):
        res = agreement(f"{kid}/f32", a, w)
        assert res["ok"], res


def test_flash_attention_f32_refuses_mixed_types(dev, gen):
    q = _rand(gen, 1, 600, 80).float()
    k = _rand(gen, 1, 600, 80)
    with pytest.raises(ValueError, match="k must be f32"):
        K.flash_attention(q, k, k, 2, 40 ** -0.5)
    # a row stride of 2 H d + 2 floats: not a whole 16-byte vector
    bad = torch.zeros(1, 600, 2 * 80 + 2, device=dev)[..., :80]
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.flash_attention(bad, bad, bad, 2, 40 ** -0.5)


def test_group_norm_f32_refuses_a_bf16_plan_that_does_not_fit(dev, gen):
    # a plan made for 2-byte values holds twice the rows an f32 tile can:
    # the C entry point refuses it, nothing launches
    n, hw, c = 4, 4096, 960
    plan = GN.plan_group_norm(n, hw, c, 32)
    assert plan.path == "cluster" and GN.plan_group_norm(n, hw, c, 32, 4).path == "stream"
    x, w, bias = (t.float() for t in _gn_operands(gen, n, hw, c))
    before = K.group_norm.launches
    with pytest.raises(RuntimeError, match="group_norm: CUDA error"):
        GN.launch(x, w, bias, 32, 1e-5, True, plan)
    assert K.group_norm.launches == before


@pytest.mark.parametrize("path,shape", [("cluster", (3, 49, 96)),
                                        ("cluster", (2, 4097, 96)),
                                        ("cluster", (8, 4096, 320)),
                                        ("stream", (2, 65536, 256)),
                                        ("stream", (8, 4096, 960))])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_f32(dev, gen, f32, path, shape, silu):
    # the f32 tiles on both paths: the planner's plan at item size 4
    n, hw, c = shape
    plan = (GN.plan_group_norm(n, hw, c, 32, 4) if path == "cluster"
            else GN.stream_plan(n, hw, c, 32))
    assert plan.path == path
    if shape == (8, 4096, 960):   # on chip in bf16, streamed in f32
        assert GN.plan_group_norm(n, hw, c, 32, 4) == plan
    x, w, bias = (t.float() for t in _gn_operands(gen, n, hw, c))
    _check_f32("K2", lambda: K.group_norm(x, w, bias, 32, 1e-6, silu),
               lambda: K.group_norm_plain(x, w, bias, 32, 1e-6, silu),
               K.group_norm)


@pytest.mark.parametrize("path,shape", [("cluster", (4, 4096, 320)),
                                        ("stream", (2, 65536, 256))])
def test_group_norm_f32_repeatable_and_fenced(dev, gen, f32, path, shape):
    # two launches give the same bits; x is a slice of a NaN-fenced buffer
    n, hw, c = shape
    plan = (GN.plan_group_norm(n, hw, c, 32, 4) if path == "cluster"
            else GN.stream_plan(n, hw, c, 32))
    assert plan.path == path and (path == "stream" or plan.cluster > 1)
    guard = 4096
    buf = torch.full((n * hw * c + 2 * guard,), float("nan"), device=dev)
    x = buf[guard:guard + n * hw * c].view(n, hw, c)
    x.copy_(_rand(gen, n, hw, c, scale=3.0, shift=1.5).float())
    w, bias = (_rand(gen, c, scale=0.5, shift=1.0).float(),
               _rand(gen, c, scale=0.5).float())
    a = GN.launch(x, w, bias, 32, 1e-5, True, plan)
    b = GN.launch(x, w, bias, 32, 1e-5, True, plan)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and not a.isnan().any()


@pytest.mark.parametrize("m,k", [(100, 320), (64, 72), (200, 640),
                                 (32768, 320), (2048, 1280), (1024, 1280)])
@pytest.mark.parametrize("scale", [1.0, "tensor"])
def test_ffn_ln_geglu_f32(dev, gen, f32, m, k, scale):
    # ragged row blocks and k steps (K = 72: inner 288, h columns off the
    # 64-wide up tiles), two of the training sites, and the f32
    # generation's M = 1024, where the down GEMM takes 80-wide tiles
    inner = 4 * k
    x = _rand(gen, m, k).float()
    lw, lb = _rand(gen, k, scale=0.2, shift=1.0).float(), _rand(gen, k, scale=0.2).float()
    w1, b1 = (_rand(gen, 2 * inner, k, scale=k ** -0.5).float(),
              _rand(gen, 2 * inner, scale=0.1).float())
    w2, b2 = (_rand(gen, k, inner, scale=inner ** -0.5).float(),
              _rand(gen, k, scale=0.1).float())
    s = torch.tensor(0.37, device=dev) if scale == "tensor" else scale
    _check_f32("K4", lambda: K.ffn_ln_geglu(x, lw, lb, w1, b1, w2, b2, s),
               lambda: K.ffn_ln_geglu_plain(x, lw, lb, w1, b1, w2, b2, s),
               K.ffn_ln_geglu)


def test_f32_products_sum_in_round_to_nearest(dev, gen, f32):
    # the longest sums of the training path: PV over 4096 keys (K1 at d
    # 40) and K4's down product over inner = 5120. Each 3xTF32 step or
    # stage adds into its accumulator in round-to-nearest f32
    # (a fresh accumulator a tile or stage, tf32_gemm.cuh's and K1/f32's):
    # chained through the tensor cores' truncating C operand instead, the
    # same kernels read 2.9e-5 and 3.0e-5 of rms(b) at these sites'
    # batch-8 shapes (PERF.md §6), K1 within its stated bound; the
    # round-to-nearest sums read under 1.5e-6 there
    q, k, v = (_rand(gen, 2, 4096, 8 * 40).float() for _ in range(3))
    got = agreement("K1/f32", K.flash_attention(q, k, v, 8, 40 ** -0.5),
                    K.flash_attention_plain(q, k, v, 8, 40 ** -0.5))
    assert got["rms_rel_err"] <= 5e-6, got
    m, k_ = 2048, 1280
    inner = 4 * k_
    x = _rand(gen, m, k_).float()
    lw, lb = _rand(gen, k_, shift=1.0).float(), _rand(gen, k_).float()
    w1, b1 = (_rand(gen, 2 * inner, k_, scale=k_ ** -0.5).float(),
              _rand(gen, 2 * inner, scale=0.1).float())
    w2, b2 = (_rand(gen, k_, inner, scale=inner ** -0.5).float(),
              _rand(gen, k_, scale=0.1).float())
    got = agreement("K4/f32", K.ffn_ln_geglu(x, lw, lb, w1, b1, w2, b2, 1.0),
                    K.ffn_ln_geglu_plain(x, lw, lb, w1, b1, w2, b2, 1.0))
    assert got["rms_rel_err"] <= 5e-6, got


def test_ffn_ln_geglu_f32_writes_only_its_output(dev, gen, f32):
    m, k = 200, 320
    inner = 4 * k
    args = [t.float() for t in (_rand(gen, m, k), _rand(gen, k, shift=1.0),
                                _rand(gen, k), _rand(gen, 2 * inner, k, scale=k ** -0.5),
                                _rand(gen, 2 * inner, scale=0.1),
                                _rand(gen, k, inner, scale=inner ** -0.5),
                                _rand(gen, k, scale=0.1))]
    a = K.ffn_ln_geglu(*args, 0.5)
    b = K.ffn_ln_geglu(*args, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.isfinite(a).all()


def _ffn_weights(gen, k, inner):
    w1, b1 = _rand(gen, 2 * inner, k, scale=k ** -0.5), _rand(gen, 2 * inner, scale=0.1)
    w2, b2 = _rand(gen, k, inner, scale=inner ** -0.5), _rand(gen, k, scale=0.1)
    return w1, b1, w2, b2


# (M, K, inner): a ragged row block, K = 1280 with inner = 5120, and widths
# off the 64-column tiles
FF_SHAPES = [(100, 320, 1280), (1054, 1280, 5120), (130, 72, 200)]


@pytest.mark.parametrize("m,k,inner", FF_SHAPES)
def test_ffn_geglu(dev, gen, m, k, inner):
    x, r = _rand(gen, m, k), _rand(gen, m, k)
    w1, b1, w2, b2 = _ffn_weights(gen, k, inner)
    _check("K6", lambda: K.ffn_geglu(x, w1, b1, w2, b2, r),
           lambda: K.ffn_geglu_plain(x, w1, b1, w2, b2, r), K.ffn_geglu)


def _k7_args(gen, m, k, inner, scale=0.37):
    """K7's operands: K4's with w1 and w2 quantized per output channel, s
    a float or (``"tensor"``) a device scalar."""
    from layoutllm_t2i_torch.ops.quant import quantize_tensor

    x = _rand(gen, m, k)
    lw, lb = _rand(gen, k, scale=0.2, shift=1.0), _rand(gen, k, scale=0.2)
    w1, b1, w2, b2 = _ffn_weights(gen, k, inner)
    q1, q2 = quantize_tensor(w1), quantize_tensor(w2)
    s = torch.tensor(0.37, device=gen.device) if scale == "tensor" else scale
    return [x, lw, lb, q1.q, q1.scale, b1, q2.q, q2.scale, b2, s]


# int8 needs K and inner to be multiples of 16: K = 336 ends both products'
# first GEMM in a 16-deep chunk (of 64), inner = 1344 in a partial 128-wide
# tile of h; M = 16384 and K = 320 is the int8 path's largest shape
@pytest.mark.parametrize("m,k,inner", [(100, 320, 1280), (1054, 1280, 5120),
                                       (77, 336, 1344), (16384, 320, 1280)])
@pytest.mark.parametrize("scale", [1.0, 0.37, "tensor"])
def test_ffn_ln_geglu_q(dev, gen, m, k, inner, scale):
    args = _k7_args(gen, m, k, inner, scale)
    _check("K7", lambda: K.ffn_ln_geglu_q(*args),
           lambda: K.ffn_ln_geglu_q_plain(*args), K.ffn_ln_geglu_q)


def test_ffn_ln_geglu_q_refuses_what_it_cannot_take(dev, gen):
    x = _rand(gen, 64, 72)  # K = 72: no 16-byte int8 rows
    lw, lb = _rand(gen, 72), _rand(gen, 72)
    q1 = torch.zeros(2 * 288, 72, dtype=torch.int8, device=dev)
    q2 = torch.zeros(72, 288, dtype=torch.int8, device=dev)
    s1, s2 = torch.ones(576, device=dev), torch.ones(72, device=dev)
    b1, b2 = _rand(gen, 576), _rand(gen, 72)
    with pytest.raises(ValueError, match="multiples of 16"):
        K.ffn_ln_geglu_q(x, lw, lb, q1, s1, b1, q2, s2, b2)
    with pytest.raises(ValueError, match="inference only"):
        K.ffn_ln_geglu_q(x.requires_grad_(), lw, lb, q1, s1, b1, q2, s2, b2)
    # an int8 weight whose view starts one byte into its buffer: TMA needs
    # 16-byte aligned bases, so the wrapper raises and nothing launches
    for idx in (3, 6):  # q1, q2
        args = _k7_args(gen, 256, 64, 256)
        t = args[idx]
        buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        args[idx] = buf[1:].view(t.shape)
        args[idx].copy_(t)
        before = K.ffn_ln_geglu_q.launches
        with pytest.raises(ValueError, match="aligned"):
            K.ffn_ln_geglu_q(*args)
        assert K.ffn_ln_geglu_q.launches == before


# K7 on the wgmma mainloop with its int8 B operands (gemm_tiles.cuh,
# Cfg::kQ): a ragged M, a contraction ending in a 16-deep chunk (K = 80)
# and h ending in a partial tile (inner = 208)
K7_RAGGED = [(100, 80, 208), (1054, 80, 208)]


@pytest.mark.parametrize("m,k,inner", K7_RAGGED)
def test_ffn_ln_geglu_q_never_reads_outside_its_operands(dev, gen, m, k,
                                                          inner):
    # the int8 weights between 16 bytes of 0x7f and 4096 more: a map whose
    # dims ran past K or inner would sum them in; the bf16 operands between
    # NaN and Inf fences
    args = _k7_args(gen, m, k, inner)
    fenced = []
    for a in args:
        if not isinstance(a, torch.Tensor) or a.dtype == torch.float32:
            fenced.append(a)
        elif a.dtype == torch.int8:
            buf = torch.full((16 + a.numel() + 4096,), 127, device=dev,
                             dtype=torch.int8)
            view = buf[16:16 + a.numel()].view(a.shape)
            view.copy_(a)
            fenced.append(view)
        else:
            fenced.append(_fenced_flat(a))
    _check("K7", lambda: K.ffn_ln_geglu_q(*fenced),
           lambda: K.ffn_ln_geglu_q_plain(*args), K.ffn_ln_geglu_q)


@pytest.mark.parametrize("m,k,inner", K7_RAGGED)
def test_ffn_ln_geglu_q_writes_only_its_outputs(dev, gen, m, k, inner):
    # through the C entry point into an output and a scratch (h, then
    # bf16(LN(x))) filled with NaN, each followed by NaN guards: every
    # output element is written, nothing past either buffer
    x, lw, lb, q1, s1, b1, q2, s2, b2, s = _k7_args(gen, m, k, inner)
    guard = 4096
    nan = lambda n: torch.full((n + guard,), float("nan"), device=dev,
                               dtype=torch.bfloat16)
    out, hbuf = nan(m * k), nan(m * (inner + k))
    check(lib("ffn").llt2i_ffn_ln_geglu_q(
        x.data_ptr(), lw.data_ptr(), lb.data_ptr(), q1.data_ptr(),
        s1.data_ptr(), b1.data_ptr(), q2.data_ptr(), s2.data_ptr(),
        b2.data_ptr(), hbuf.data_ptr(), out.data_ptr(), None, s, m, k, inner,
        1e-5, stream_handle(x.get_device())), "ffn_ln_geglu_q")
    torch.cuda.synchronize()
    assert bool(out[-guard:].isnan().all()) and bool(hbuf[-guard:].isnan().all())
    got = agreement("K7", out[:-guard].view(m, k),
                    K.ffn_ln_geglu_q_plain(x, lw, lb, q1, s1, b1, q2, s2, b2, s))
    assert got["ok"], got


@pytest.mark.parametrize("m,k,inner", [(1054, 80, 208), (16384, 320, 1280),
                                       (1024, 1280, 5120)])
def test_ffn_ln_geglu_q_is_bitwise_repeatable(dev, gen, m, k, inner):
    # one thread sums each output element in a fixed order, and the B slot
    # a chunk is converted into is rewritten only after both warpgroups'
    # products of three chunks back have completed: launches agree bit for
    # bit (a slot rewritten too early would not)
    args = _k7_args(gen, m, k, inner)
    runs = [K.ffn_ln_geglu_q(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], run) for run in runs[1:])


@pytest.mark.parametrize("m,k,n", [(100, 320, 1280), (1054, 5120, 1280),
                                   (130, 72, 200)])
@pytest.mark.parametrize("bias,residual", [(True, False), (False, True),
                                           (False, False)])
def test_linear_fused(dev, gen, m, k, n, bias, residual):
    x, w = _rand(gen, m, k), _rand(gen, n, k, scale=k ** -0.5)
    b = _rand(gen, n, scale=0.1) if bias else None
    r = _rand(gen, m, n) if residual else None
    _check("K8a", lambda: K.linear_fused(x, w, b, r),
           lambda: K.linear_plain(x, w, b, r), K.linear_fused)


@pytest.mark.parametrize("m,k,n", [(100, 320, 1280), (1054, 1280, 5120),
                                   (130, 72, 200)])
@pytest.mark.parametrize("bias", [True, False])
def test_geglu_fused(dev, gen, m, k, n, bias):
    x, w = _rand(gen, m, k), _rand(gen, 2 * n, k, scale=k ** -0.5)
    b = _rand(gen, 2 * n, scale=0.1) if bias else None
    _check("K8b", lambda: K.geglu_fused(x, w, b),
           lambda: K.geglu_plain(x, w, b), K.geglu_fused)


def test_ffn_geglu_grads(dev, gen):
    m, k, inner = 1054, 640, 2560
    x, r = _rand(gen, m, k), _rand(gen, m, k)
    w1, b1, w2, b2 = _ffn_weights(gen, k, inner)
    _grads_match(K.ffn_geglu, K.ffn_geglu_plain, [x, w1, b1, w2, b2, r],
                 K.ffn_geglu)


def test_gemm_grads(dev, gen):
    m, k, n = 1054, 640, 2560
    x, w, b = _rand(gen, m, k), _rand(gen, n, k, scale=k ** -0.5), _rand(gen, n)
    _grads_match(K.linear_fused, K.linear_plain, [x, w, b, None],
                 K.linear_fused)
    x, w, b = _rand(gen, m, k), _rand(gen, 2 * n, k, scale=k ** -0.5), _rand(gen, 2 * n)
    _grads_match(K.geglu_fused, K.geglu_plain, [x, w, b], K.geglu_fused)



# ---------------------------------------------------------------------------
# K4, K6, K8a and K8b on the wgmma mainloop (csrc/gemm_tiles.cuh)


def _k4_args(gen, m, k, inner, s=0.37):
    """K4's operands (x off unit variance, as a LayerNorm sees it) and s as
    a device tensor, the fusers' traced gate."""
    x = _rand(gen, m, k, scale=2.0, shift=0.5)
    lw, lb = _rand(gen, k, scale=0.2, shift=1.0), _rand(gen, k, scale=0.2)
    w1, b1, w2, b2 = _ffn_weights(gen, k, inner)
    return [x, lw, lb, w1, b1, w2, b2, torch.tensor(s, device=gen.device)]


def _k8a_args(gen, m, k, n):
    x, w = _rand(gen, m, k), _rand(gen, n, k, scale=k ** -0.5)
    return [x, w, _rand(gen, n, scale=0.1), _rand(gen, m, n)]


def _k6_args(gen, m, k, inner):
    x, r = _rand(gen, m, k), _rand(gen, m, k)
    return [x, *_ffn_weights(gen, k, inner), r]


def _k8b_args(gen, m, k, n, bias=True):
    x, w = _rand(gen, m, k), _rand(gen, 2 * n, k, scale=k ** -0.5)
    return [x, w, _rand(gen, 2 * n, scale=0.1) if bias else None]


# case -> (wrapper, plain version, operands for an (M, contraction, N)
# case); a case is a kernel id, "-nobias" K8b without its bias
WGMMA_GEMMS = {
    "K4": (K.ffn_ln_geglu, K.ffn_ln_geglu_plain,
           lambda gen, m, k, n: _k4_args(gen, m, k, n)),
    "K8a": (K.linear_fused, K.linear_plain, _k8a_args),
    "K6": (K.ffn_geglu, K.ffn_geglu_plain, _k6_args),
    "K8b": (K.geglu_fused, K.geglu_plain, _k8b_args),
    "K8b-nobias": (K.geglu_fused, K.geglu_plain,
                   lambda gen, m, k, n: _k8b_args(gen, m, k, n, bias=False)),
}


def _kid(case):
    """The kernel id, and so the tolerance, of a WGMMA_GEMMS case."""
    return case.split("-")[0]


def _wgmma_cases(*shapes):
    return [pytest.param(kid, shape, id=f"{kid}-{'-'.join(map(str, shape))}")
            for kid in WGMMA_GEMMS for shape in shapes]


# K4's and K6's (M, K, inner), K8a's and K8b's (M, K, N): K = 72 ends in a
# ragged 64-deep chunk, N = 200 in a partial tile, M = 100 and 1054 in a
# partial 128-row block; M = 1024 with a 5,120-deep contraction and 1,280
# outputs is the grid-fill shape (K8a's 1024 x 5120 x 1280, K4's and K6's
# down GEMM at K = 1280), as are K8b's 1024 x 1280 x 5120 (320 tiles 128
# wide, 2.4 waves on 132 SMs)
RAGGED = [(100, 72, 200), (1054, 72, 200)]


@pytest.mark.parametrize("kid,shape", _wgmma_cases(*RAGGED) + [
    pytest.param("K4", (1024, 1280, 5120), id="K4-grid-fill"),
    pytest.param("K8a", (1024, 5120, 1280), id="K8a-grid-fill"),
    pytest.param("K6", (1024, 1280, 5120), id="K6-grid-fill"),
    pytest.param("K8b", (1024, 1280, 5120), id="K8b-grid-fill"),
    pytest.param("K8b-nobias", (1024, 1280, 5120), id="K8b-nobias-grid-fill")])
def test_wgmma_gemm_ragged_and_grid_fill(dev, gen, kid, shape):
    fn, plain, make = WGMMA_GEMMS[kid]
    args = make(gen, *shape)
    _check(_kid(kid), lambda: fn(*args), lambda: plain(*args), fn)


def _fenced_flat(t, before=8, after=4096):
    """``t`` copied into a flat buffer between ``before`` NaNs (16 bytes,
    so the copy stays 16-byte aligned) and ``after`` Infs: a kernel that
    reads past either end of the operand turns its output NaN or Inf."""
    buf = torch.full((before + t.numel() + after,), float("nan"),
                     device=t.device, dtype=t.dtype)
    buf[before + t.numel():] = float("inf")
    view = buf[before:before + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("kid,shape", _wgmma_cases(*RAGGED))
def test_wgmma_gemm_never_reads_outside_its_operands(dev, gen, kid, shape):
    # TMA zero-fills past the last row and column: a map whose dims ran
    # past K or N would read the next row, and at the end the Inf fence
    fn, plain, make = WGMMA_GEMMS[kid]
    args = make(gen, *shape)
    fenced = [a if a is None or not a.dim() else _fenced_flat(a) for a in args]
    _check(_kid(kid), lambda: fn(*fenced), lambda: plain(*args), fn)


def _into_nan(kid, args, guard=4096):
    """A WGMMA_GEMMS case through its C entry point into an output (and
    K4's or K6's scratch) filled with NaN, each followed by ``guard`` more
    NaN elements: (output, [guards])."""
    x = args[0]
    m = x.shape[0]
    stream = stream_handle(x.get_device())
    nan = lambda n: torch.full((n + guard,), float("nan"), device=x.device,
                               dtype=torch.bfloat16)
    ptr = lambda t: None if t is None else t.data_ptr()
    if kid == "K8a":
        x, w, b, r = args
        n, k = w.shape
        out = nan(m * n)
        check(lib("matmul").llt2i_linear(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                         r.data_ptr(), out.data_ptr(), m, k, n,
                                         stream), "linear_fused")
        bufs = [out]
        shape = (m, n)
    elif _kid(kid) == "K8b":
        x, w, b = args
        n, k = w.shape[0] // 2, w.shape[1]
        out = nan(m * n)
        check(lib("matmul").llt2i_geglu(x.data_ptr(), w.data_ptr(), ptr(b),
                                        out.data_ptr(), m, k, n, stream),
              "geglu_fused")
        bufs = [out]
        shape = (m, n)
    elif kid == "K6":
        x, w1, b1, w2, b2, r = args
        k, inner = x.shape[1], w2.shape[1]
        out, hbuf = nan(m * k), nan(m * inner)
        check(lib("ffn").llt2i_ffn_geglu(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), r.data_ptr(), hbuf.data_ptr(), out.data_ptr(), m,
            k, inner, stream), "ffn_geglu")
        bufs = [out, hbuf]
        shape = (m, k)
    else:
        x, lw, lb, w1, b1, w2, b2, s = args
        k, inner = x.shape[1], w2.shape[1]
        out, hbuf = nan(m * k), nan(m * (inner + k))
        check(lib("ffn").llt2i_ffn_ln_geglu(
            x.data_ptr(), lw.data_ptr(), lb.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), hbuf.data_ptr(),
            out.data_ptr(), s.data_ptr(), 1.0, m, k, inner, 1e-5, stream),
            "ffn_ln_geglu")
        bufs = [out, hbuf]
        shape = (m, k)
    torch.cuda.synchronize()
    return out[:-guard].view(shape), [buf[-guard:] for buf in bufs]


@pytest.mark.parametrize("kid,shape", _wgmma_cases(*RAGGED))
def test_wgmma_gemm_writes_only_its_outputs(dev, gen, kid, shape):
    # every output element is written (none stays NaN), and nothing past
    # the output or K4's scratch (h, then LN(x)) or K6's (h): the guards
    # stay NaN; a column of h past inner left unwritten would turn the
    # output NaN
    fn, plain, make = WGMMA_GEMMS[kid]
    args = make(gen, *shape)
    out, guards = _into_nan(kid, args)
    assert all(bool(g.isnan().all()) for g in guards)
    got = agreement(_kid(kid), out, plain(*args))
    assert got["ok"], got


@pytest.mark.parametrize("kid,shape", _wgmma_cases((1054, 72, 200)) + [
    pytest.param("K4", (16384, 320, 1280), id="K4-16384-320-1280"),
    pytest.param("K8a", (1024, 5120, 1280), id="K8a-grid-fill"),
    pytest.param("K6", (16384, 320, 1280), id="K6-16384-320-1280"),
    pytest.param("K8b", (1024, 1280, 5120), id="K8b-grid-fill")])
def test_wgmma_gemm_is_bitwise_repeatable(dev, gen, kid, shape):
    # each output element is summed by one thread in a fixed order: no
    # atomics, so launches agree bit for bit (a race in the stage ring, a
    # stage refilled before both warpgroups released it, would not)
    fn, _, make = WGMMA_GEMMS[kid]
    args = make(gen, *shape)
    runs = [fn(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], run) for run in runs[1:])


@pytest.mark.parametrize("kid", list(WGMMA_GEMMS))
@pytest.mark.parametrize("operand", [0, 1])
def test_wgmma_gemm_misaligned_operand_raises(dev, gen, kid, operand):
    # x and the weight (K4's and K6's w1) go through TMA, which needs
    # 16-byte aligned addresses: a view 2 bytes into its buffer raises,
    # nothing launches
    fn, _, make = WGMMA_GEMMS[kid]
    args = make(gen, 256, 64, 256)
    idx = 0 if operand == 0 else (3 if kid == "K4" else 1)
    t = args[idx]
    buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
    args[idx] = buf[1:].view(t.shape)
    args[idx].copy_(t)
    before = fn.launches
    with pytest.raises(ValueError, match="aligned"):
        fn(*args)
    assert fn.launches == before


def _card_models(dev):
    """A small bundle on the card in bf16 whose 32^2 level routes to K1
    (1,024 visual tokens, heads of d 40, an instantiated width), K4
    (1,024-row FF sites at width 160), K2 and K3: the fast path's kernels
    at small geometry. The VAE's middle block is 512 channels wide, as at
    full width (K1 at d 512)."""
    from layoutllm_t2i_torch.models.clip_text import CLIPTextConfig, init_clip_text_params
    from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer
    from layoutllm_t2i_torch.models.initializers import Init
    from layoutllm_t2i_torch.models.unet import UNetConfig, init_unet_params
    from layoutllm_t2i_torch.models.vae import VAEConfig, init_vae_params
    from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule
    from layoutllm_t2i_torch.pipeline.inference import GligenModels
    from layoutllm_t2i_torch.utils.trees import ParamTree

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ini = Init(g, dev, torch.bfloat16)
    unet_cfg = UNetConfig(image_size=32, model_channels=160, num_res_blocks=1,
                          attention_resolutions=(2, 1), channel_mult=(1, 2),
                          num_heads=4, context_dim=64, grounding_in_dim=64,
                          grounding_out_dim=64)
    vae_cfg = VAEConfig(ch=128, ch_mult=(1, 4), num_res_blocks=1)
    clip_cfg = CLIPTextConfig(num_layers=1, hidden_size=64, num_heads=2,
                              intermediate_size=128, vocab_size=512)
    unet = ParamTree(init_unet_params(ini, unet_cfg))
    for name, p in unet.named_parameters():
        if name.endswith(("alpha_attn", "alpha_dense")):
            p.data.fill_(0.5)  # random init leaves the fuser gates closed
    return GligenModels(
        unet_cfg=unet_cfg, unet_params=unet,
        vae_cfg=vae_cfg, vae_params=ParamTree(init_vae_params(ini, vae_cfg)),
        clip_cfg=clip_cfg, clip_params=ParamTree(init_clip_text_params(ini, clip_cfg)),
        schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012),
        tokenizer=HashTokenizer(max_length=8, vocab_size=512),
        compute_dtype=torch.bfloat16, device=dev)


def test_fast_generation_kernels_against_plain_route(dev):
    """One fast-preset generation (DPM, CFG on (0, 0.75), encoder cache 2)
    at small geometry through K1-K4, against the same through the plain
    versions on the card: PSNR >= 30 dB, chip_smoke's fast-path bound."""
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    pipe = InferencePipeline(_card_models(dev), steps=8, sampler="dpm",
                             alpha_type=(0.3, 0.0, 0.7), cfg_interval=(0.0, 0.75),
                             encoder_cache_interval=2)
    requests = (["a dog on the grass", "a cat on a chair"],
                [([[0.1, 0.4, 0.5, 0.9]], ["a dog"]),
                 ([[0.2, 0.1, 0.6, 0.6], [0.1, 0.4, 0.7, 0.95]], ["a cat", "a chair"])],
                [["dog on grass"], ["cat on chair"]])
    K.reset_launches()
    img = pipe.generate(*requests, seeds=[3, 4])
    counts = K.launch_counts()
    with K.plain_route():
        ref = pipe.generate(*requests, seeds=[3, 4])
    assert K.launch_counts() == counts
    assert all(counts[kid] > 0 for kid in ("K1", "K2", "K3", "K4")), counts
    assert img.shape == (2, 64, 64, 3) and np.isfinite(img).all()
    for a, b in zip(img, ref):
        mse = float(np.mean((a - b) ** 2))
        assert mse == 0 or 10 * np.log10(1.0 / mse) >= 30.0, mse


def test_reward_model_on_the_card_matches_its_plain_route(dev):
    """A small RewardModel (f32 towers: every LayerNorm through K3's f32
    form) against itself under plain_route() on the same images."""
    from layoutllm_t2i_torch.models.clip_text import (CLIPTextConfig,
                                                      init_clip_text_params)
    from layoutllm_t2i_torch.models.clip_tokenizer import HashTokenizer
    from layoutllm_t2i_torch.models.clip_vision import (CLIPVisionConfig,
                                                        init_clip_vision_params)
    from layoutllm_t2i_torch.models.initializers import Init, linear_p
    from layoutllm_t2i_torch.models.policy import init_aesthetic_params
    from layoutllm_t2i_torch.pipeline.reward import RewardModel

    ini = Init(torch.Generator().manual_seed(0), torch.device("cpu"))
    text_cfg = CLIPTextConfig(num_layers=2, hidden_size=128, num_heads=2,
                              intermediate_size=256, vocab_size=512,
                              max_length=16)
    vision_cfg = CLIPVisionConfig(image_size=56, hidden_size=128, num_layers=2,
                                  num_heads=2, intermediate_size=256,
                                  projection_dim=96)
    text = init_clip_text_params(ini, text_cfg)
    text["text_projection"] = linear_p(ini, 128, 96, bias=False)
    reward = RewardModel(text_cfg, text, vision_cfg,
                         init_clip_vision_params(ini, vision_cfg),
                         init_aesthetic_params(ini, 96),
                         HashTokenizer(max_length=16, vocab_size=512),
                         device=dev)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(3, 64, 64, 3)).astype(np.float32)
    gt = rng.uniform(size=(3, 64, 64, 3)).astype(np.float32)
    layouts = [([[0.1, 0.1, 0.5, 0.5]], ["dog"]), ([[0.2, 0.2, 0.6, 0.9]], ["puppy"]),
               ([[0.0, 0.3, 0.4, 0.8]], ["cat"])]
    caps = ["a dog", "a small puppy", "a cat on a mat"]
    before = K.layer_norm.f32_launches
    gt_layouts = [([[0.1, 0.1, 0.5, 0.6]], ["dog"]), ([[0.2, 0.2, 0.6, 0.9]], ["dog"]),
                  ([[0.0, 0.3, 0.4, 0.8]], ["cat"])]
    got = reward.components(caps, imgs, gt, layouts, gt_layouts)
    assert K.layer_norm.f32_launches > before
    with K.plain_route():
        ref = reward.components(caps, imgs, gt, layouts, gt_layouts)
    for name in got:
        assert np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-4,
                                   err_msg=name)



# ---------------------------------------------------------------------------
# the f32 forms of K6, K7, K8a and K8b, all on tf32_gemm.cuh's TF32 wgmma
# mainloop (3xTF32; K7 two TF32 products against its int8 weights,
# converted to f32 in shared memory), against the plain versions in full f32


def _f32(*tensors):
    return [t.float() if t.is_floating_point() else t for t in tensors]


# (M, K, inner): a ragged row block, widths off the 64-column tiles (inner
# 200: Wa's and Wg's tensor maps each end in a ragged box) and a ragged
# 32-deep k step (K = 72), the split routes' training sites, and M = 1024,
# where the down GEMM takes 80-wide tiles
FF_F32_SHAPES = FF_SHAPES + [(32768, 320, 1280), (2048, 1280, 5120),
                             (1024, 1280, 5120)]


@pytest.mark.parametrize("m,k,inner", FF_F32_SHAPES)
def test_ffn_geglu_f32(dev, gen, f32, m, k, inner):
    x, r, w1, b1, w2, b2 = _f32(_rand(gen, m, k), _rand(gen, m, k),
                                *_ffn_weights(gen, k, inner))
    _check_f32("K6", lambda: K.ffn_geglu(x, w1, b1, w2, b2, r),
               lambda: K.ffn_geglu_plain(x, w1, b1, w2, b2, r), K.ffn_geglu)


def test_ffn_geglu_f32_repeats_bit_for_bit(dev, gen, f32):
    # each output summed by one thread in a fixed order: two launches give
    # the same bits, on the 160-wide and the 80-wide down tiles
    for m, k, inner in ((200, 320, 1280), (1024, 1280, 5120)):
        x, r, w1, b1, w2, b2 = _f32(_rand(gen, m, k), _rand(gen, m, k),
                                    *_ffn_weights(gen, k, inner))
        a = K.ffn_geglu(x, w1, b1, w2, b2, r)
        b = K.ffn_geglu(x, w1, b1, w2, b2, r)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.isfinite(a).all(), (m, k, inner)


# K % 16 and inner % 16 as in bf16: K = 80 ends the up GEMM in a 16-deep
# step, inner = 208 h in a partial tile (Qa's and Qg's maps each in a
# ragged box); M = 16384, 4096 and 1024 are the f32 int8 generation's
# sites, and at M = 1024, K = 1280 the down GEMM takes 80-wide tiles
@pytest.mark.parametrize("m,k,inner", [(100, 80, 208), (1054, 1280, 5120),
                                       (16384, 320, 1280), (4096, 640, 2560),
                                       (1024, 1280, 5120)])
@pytest.mark.parametrize("scale", [1.0, "tensor"])
def test_ffn_ln_geglu_q_f32(dev, gen, f32, m, k, inner, scale):
    args = _k7_f32_args(gen, m, k, inner, scale)
    _check_f32("K7", lambda: K.ffn_ln_geglu_q(*args),
               lambda: K.ffn_ln_geglu_q_plain(*args), K.ffn_ln_geglu_q)


def _k7_f32_args(gen, m, k, inner, scale=0.37):
    """K7/f32's operands: ``_k7_args`` with x, the LN parameters and the
    biases in f32."""
    args = _k7_args(gen, m, k, inner, scale)
    for i in (0, 1, 2, 5, 8):
        args[i] = args[i].float()
    return args


# K7/f32 on the TF32 wgmma mainloop with int8 B operands (tf32_gemm.cuh
# Cfg::kQ: 32-byte TMA boxes converted in shared memory): a ragged M, a
# contraction ending in a 16-deep stage (K = 80), h ending in a partial
# tile (inner = 208), both down widths' grids (M = 1054: 160 wide)


@pytest.mark.parametrize("m,k,inner", K7_RAGGED)
def test_ffn_ln_geglu_q_f32_never_reads_outside_its_operands(dev, gen, f32, m,
                                                              k, inner):
    # the int8 weights between 16 bytes of 0x7f and 4096 more: a map whose
    # dims ran past K or inner would sum them in; x, the LN parameters,
    # biases and scales between NaN and Inf fences
    args = _k7_f32_args(gen, m, k, inner)
    fenced = []
    for a in args:
        if not isinstance(a, torch.Tensor):
            fenced.append(a)
        elif a.dtype == torch.int8:
            buf = torch.full((16 + a.numel() + 4096,), 127, device=dev,
                             dtype=torch.int8)
            view = buf[16:16 + a.numel()].view(a.shape)
            view.copy_(a)
            fenced.append(view)
        else:
            fenced.append(_fenced_flat(a))
    _check_f32("K7", lambda: K.ffn_ln_geglu_q(*fenced),
               lambda: K.ffn_ln_geglu_q_plain(*args), K.ffn_ln_geglu_q)


@pytest.mark.parametrize("m,k,inner", K7_RAGGED)
def test_ffn_ln_geglu_q_f32_writes_only_its_outputs(dev, gen, f32, m, k,
                                                     inner):
    # through the C entry point into an output and a scratch (h, then
    # LN(x), f32) filled with NaN, each followed by NaN guards: every output
    # element is written, nothing past either buffer
    x, lw, lb, q1, s1, b1, q2, s2, b2, s = _k7_f32_args(gen, m, k, inner)
    guard = 4096
    nan = lambda n: torch.full((n + guard,), float("nan"), device=dev,
                               dtype=torch.float32)
    out, hbuf = nan(m * k), nan(m * (inner + k))
    check(lib("ffn").llt2i_ffn_ln_geglu_q_f32(
        x.data_ptr(), lw.data_ptr(), lb.data_ptr(), q1.data_ptr(),
        s1.data_ptr(), b1.data_ptr(), q2.data_ptr(), s2.data_ptr(),
        b2.data_ptr(), hbuf.data_ptr(), out.data_ptr(), None, s, m, k, inner,
        1e-5, stream_handle(x.get_device())), "ffn_ln_geglu_q_f32")
    torch.cuda.synchronize()
    assert bool(out[-guard:].isnan().all()) and bool(hbuf[-guard:].isnan().all())
    got = agreement("K7/f32", out[:-guard].view(m, k),
                    K.ffn_ln_geglu_q_plain(x, lw, lb, q1, s1, b1, q2, s2, b2, s))
    assert got["ok"], got


@pytest.mark.parametrize("m,k,inner", [(1054, 80, 208), (16384, 320, 1280),
                                       (1024, 1280, 5120)])
def test_ffn_ln_geglu_q_f32_is_bitwise_repeatable(dev, gen, f32, m, k, inner):
    # one thread sums each output element in a fixed order, and a stage's
    # B tile is converted only after every warp's products of the stage
    # that last held it have completed: launches agree bit for bit (a tile
    # rewritten too early would not)
    args = _k7_f32_args(gen, m, k, inner)
    runs = [K.ffn_ln_geglu_q(*args) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], run) for run in runs[1:])
    assert torch.isfinite(runs[0]).all()


@pytest.mark.parametrize("m,k,n", [(100, 1280, 320), (2048, 5120, 1280),
                                   (130, 72, 200)])
@pytest.mark.parametrize("bias,residual", [(True, False), (True, True),
                                           (False, True), (False, False)])
def test_linear_fused_f32(dev, gen, f32, m, k, n, bias, residual):
    x, w = _rand(gen, m, k).float(), _rand(gen, n, k, scale=k ** -0.5).float()
    b = _rand(gen, n, scale=0.1).float() if bias else None
    r = _rand(gen, m, n).float() if residual else None
    _check_f32("K8a", lambda: K.linear_fused(x, w, b, r),
               lambda: K.linear_plain(x, w, b, r), K.linear_fused)


@pytest.mark.parametrize("m,k,n", [(100, 320, 1280), (2048, 1280, 5120),
                                   (130, 72, 200), (32768, 320, 1280),
                                   (8192, 640, 2560)])
@pytest.mark.parametrize("bias", [True, False])
def test_geglu_fused_f32(dev, gen, f32, m, k, n, bias):
    x, w = _rand(gen, m, k).float(), _rand(gen, 2 * n, k, scale=k ** -0.5).float()
    b = _rand(gen, 2 * n, scale=0.1).float() if bias else None
    _check_f32("K8b", lambda: K.geglu_fused(x, w, b),
               lambda: K.geglu_plain(x, w, b), K.geglu_fused)


def test_f32_gemm_forms_repeat_bit_for_bit(dev, gen, f32):
    m, k, inner = 1054, 640, 2560
    x, r, w1, b1, w2, b2 = _f32(_rand(gen, m, k), _rand(gen, m, k),
                                *_ffn_weights(gen, k, inner))
    q = _k7_args(gen, m, k, inner)
    for i in (0, 1, 2, 5, 8):
        q[i] = q[i].float()
    for fn in (lambda: K.ffn_geglu(x, w1, b1, w2, b2, r),
               lambda: K.ffn_ln_geglu_q(*q),
               lambda: K.linear_fused(x, w1, b1),
               lambda: K.geglu_fused(x, w1, b1)):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.isfinite(a).all()


def test_f32_gemm_forms_refuse_what_they_cannot_take(dev, gen):
    # f32 rows move in 16-byte vectors: K and N multiples of 4; mixed types
    # raise; nothing launches
    x = _rand(gen, 64, 70).float()
    w = _rand(gen, 64, 70).float()
    before = K.linear_fused.launches
    with pytest.raises(ValueError, match="multiples of 4"):
        K.linear_fused(x, w)
    with pytest.raises(ValueError, match="multiples of 4"):
        K.geglu_fused(x, w)
    x, w = _rand(gen, 64, 72).float(), _rand(gen, 64, 72)
    with pytest.raises(ValueError, match="expected torch.float32"):
        K.linear_fused(x, w)
    assert K.linear_fused.launches == before
    args = _k7_args(gen, 64, 64, 256)
    args[0] = args[0].float()       # f32 x with bf16 LN parameters
    with pytest.raises(ValueError, match="ln_w: dtype"):
        K.ffn_ln_geglu_q(*args)


def test_f32_gemm_grads(dev, gen, f32):
    m, k, inner = 1054, 640, 2560
    x, r, w1, b1, w2, b2 = _f32(_rand(gen, m, k), _rand(gen, m, k),
                                *_ffn_weights(gen, k, inner))
    _grads_match(K.ffn_geglu, K.ffn_geglu_plain, [x, w1, b1, w2, b2, r],
                 K.ffn_geglu)
    x, w, b = (_rand(gen, m, k).float(),
               _rand(gen, inner, k, scale=k ** -0.5).float(),
               _rand(gen, inner).float())
    _grads_match(K.linear_fused, K.linear_plain, [x, w, b, None],
                 K.linear_fused)
    w, b = _rand(gen, 2 * inner, k, scale=k ** -0.5).float(), _rand(gen, 2 * inner).float()
    _grads_match(K.geglu_fused, K.geglu_plain, [x, w, b], K.geglu_fused)


# ---------------------------------------------------------------------------
# the TF32 wgmma kernels: K1/f32 at d 512 (flash_fwd_f32_wgmma_kernel) and
# K8a/f32 (linear_f32_wgmma_kernel on tf32_gemm.cuh), at ragged shapes


# (B, N, M, H): N past a 64-row q tile, M one key past a 32-key tile and
# within one, two heads (the map's head coordinate), a single q tile
# against the VAE's 4096 keys
D512_SHAPES = [(2, 130, 33, 1), (1, 1000, 1054, 2), (1, 64, 4096, 1),
               (2, 77, 31, 1)]


@pytest.mark.parametrize("b,n,m,heads", D512_SHAPES)
def test_flash_attention_f32_d512_ragged_with_lse(dev, gen, f32, b, n, m, heads):
    d = 512
    q, k, v = (_rand(gen, b, r, heads * d).float() for r in (n, m, m))
    s = d ** -0.5
    _check_f32("K1", lambda: _launch_fwd(q, k, v, heads, s, need_lse=True),
               lambda: K.flash_attention_lse_plain(q, k, v, heads, s),
               K.flash_attention, kids=("K1/f32", "lse/f32"))


def test_flash_attention_f32_d512_never_reads_outside_and_repeats(dev, gen, f32):
    # q, k and v slices of one packed qkv buffer (row stride 3 H d) between
    # NaN fences: TMA reads nothing past a map's rows or head, and a ring
    # refilled before its readers left, or a partial S read before the
    # other warpgroup wrote it, would change the bits between launches
    b, n, heads, d = 2, 300, 1, 512
    guard = 4096
    buf = torch.full((b * n * 3 * heads * d + 2 * guard,), float("nan"),
                     device=dev)
    qkv = buf[guard:guard + b * n * 3 * heads * d].view(b, n, 3 * heads * d)
    qkv.copy_(_rand(gen, b, n, 3 * heads * d).float())
    q, k, v = qkv.split(heads * d, dim=-1)
    runs = [K.flash_attention(q, k, v, heads, d ** -0.5) for _ in range(3)]
    torch.cuda.synchronize()
    assert not runs[0].isnan().any()
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    got = agreement("K1/f32", runs[0], K.flash_attention_plain(q, k, v, heads, d ** -0.5))
    assert got["ok"], got


# (M, K, N): ragged M, N and K (K % 32 in {4, 8, 28}), one row, N under
# one 160-wide tile, the routes' grid-fill shape
K8A_F32_SHAPES = [(1, 36, 8), (257, 68, 164), (300, 1284, 324),
                  (2048, 5120, 1280), (129, 92, 480)]


@pytest.mark.parametrize("m,k,n", K8A_F32_SHAPES)
def test_linear_fused_f32_wgmma_ragged(dev, gen, f32, m, k, n):
    x, w = _rand(gen, m, k).float(), _rand(gen, n, k, scale=k ** -0.5).float()
    b, r = _rand(gen, n, scale=0.1).float(), _rand(gen, m, n).float()
    _check_f32("K8a", lambda: K.linear_fused(x, w, b, r),
               lambda: K.linear_plain(x, w, b, r), K.linear_fused)


@pytest.mark.parametrize("m,k,n", [(257, 68, 164), (1054, 2560, 640)])
def test_linear_f32_wgmma_reads_and_writes_only_its_operands(dev, gen, f32, m, k, n):
    # x and w between NaN/Inf fences (TMA zero-fills past their ends), the
    # output in a NaN buffer with a NaN guard after it: every element
    # written, none past it, and three launches bit for bit the same
    x = _fenced_flat(_rand(gen, m, k).float())
    w = _fenced_flat(_rand(gen, n, k, scale=k ** -0.5).float())
    b = _rand(gen, n, scale=0.1).float()
    guard = 4096
    outs = []
    for _ in range(3):
        out = torch.full((m * n + guard,), float("nan"), device=dev)
        check(lib("matmul").llt2i_linear_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None, out.data_ptr(), m,
            k, n, stream_handle(x.get_device())), "linear_fused")
        outs.append(out)
    torch.cuda.synchronize()
    assert all(bool(o[-guard:].isnan().all()) for o in outs)
    assert all(torch.equal(outs[0][:-guard], o[:-guard]) for o in outs[1:])
    got = agreement("K8a/f32", outs[0][:-guard].view(m, n), K.linear_plain(x, w, b))
    assert got["ok"], got

