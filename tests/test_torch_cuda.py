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
outputs, SiLU's negative tail to a bf16 ulp, an operand fenced by NaN and
the planner's copy of the on-chip kernel's shared-memory layout;
wide and narrow LayerNorm rows, a partial FF row block; the training path's
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
bitwise repeatability and misaligned operands.
Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine need not have). Tolerance: the one ``chip_smoke.py`` states,
from ``layoutllm_t2i_torch/kernels/tolerance.py``.
"""
import importlib
import math

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


@pytest.mark.parametrize("d", [40, 80])
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
    # d = 160 (the 16^2 sites) stays on the plain path: no instantiation
    q = _rand(gen, 1, 512, 2 * 160)
    before = K.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.flash_attention(q, q, q, 2, 160 ** -0.5)
    assert K.flash_attention.launches == before


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
    # the planner's cluster_smem_bytes against the C layout and limit,
    # every slab of each group width up to 640 channels, rows up to and one
    # past the most a block holds
    smem = lib("group_norm").llt2i_group_norm_cluster_smem
    for cg in (1, 2, 3, 4, 8, 10, 16, 20, 30, 40, 60, 80):
        for slab in range(math.lcm(cg, 8), 641, math.lcm(cg, 8)):
            most = GN.SMEM_MAX // (2 * slab)
            while GN.cluster_smem_bytes(most, slab, cg) > GN.SMEM_MAX:
                most -= 1
            for rows in (1, 31, 32, 205, most // 2, most, most + 1):
                py = GN.cluster_smem_bytes(rows, slab, cg)
                want = py if py <= GN.SMEM_MAX else -1
                assert smem(rows, slab, cg) == want, (rows, slab, cg)


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


def test_cuda_tensor_never_takes_the_plain_version(dev):
    x = torch.randn(4, 16, device=dev)  # f32: no kernel takes it
    with pytest.raises(ValueError, match="dtype"):
        K.layer_norm(x, torch.ones(16, device=dev), torch.zeros(16, device=dev))


# (operand, fault): a CPU x is no fault (it takes the plain version)
@pytest.mark.parametrize("operand,fault", [
    ("weight", "cpu"), ("bias", "cpu"), ("x", "f32"), ("weight", "f32"),
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
    # d = 160 (the 16^2 sites) never routes here: no backward instantiation
    q, k, v, dout = _attention_inputs(gen, 1, 512, 512, 2, 160)
    lse = torch.zeros(1, 2, 512, device=dev)
    before = (K.flash_attention_bwd_dq.launches, K.flash_attention_bwd_dkv.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.flash_attention_bwd_dq(q, k, v, dout, lse, lse, 2, 160 ** -0.5)
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.flash_attention_bwd_dkv(q, k, v, dout, lse, lse, 2, 160 ** -0.5)
    assert (K.flash_attention_bwd_dq.launches,
            K.flash_attention_bwd_dkv.launches) == before


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


def test_training_refuses_f32_on_the_card(dev):
    """The kernels take bf16 operands: an f32 train step on the card raises
    and names the flag, rather than quietly running the plain versions."""
    from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule
    from layoutllm_t2i_torch.pipeline.loaders import model_configs
    from layoutllm_t2i_torch.training.train_step import TrainStep, TrainStepConfig
    from layoutllm_t2i_torch.utils.trees import ParamTree

    unet_cfg = model_configs(small=True)[0]
    tree = ParamTree({"rela_fuse": {"weight": torch.zeros(4, device=dev)}})
    cfg = TrainStepConfig(unet_cfg=unet_cfg,
                          schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012))
    with pytest.raises(ValueError, match="mixed_precision"):
        TrainStep(cfg, tree)


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
