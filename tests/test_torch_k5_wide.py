"""K5a/K5b past head dim 320 on the CPU.

The Pallas backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) take
any head dim, zero-padded to 128 lanes. Past 320 (``num_heads`` 1: d 640
and 1280) the port runs K5's column-group kernels (csrc/flash_attention.cu
``flash_bwd_dq_wide_kernel``, ``flash_bwd_dkv_wide_kernel`` and their f32
forms): the output's columns split over the grid in G = ceil(d / 320)
groups of ow = ceil(d / G) columns (rounded up to 8), the scores' depth
streamed in items (64 columns in bf16, 32 in f32), K5b as a dV pass then a
dK pass. On a CPU tensor the wrappers take the plain versions, so here:

* the plain backward and the autograd path (``FlashAttention.backward``)
  against ``jax.vjp`` through the Pallas VJP in interpret mode at d 328
  (the first width past 320), 640 and 1280, B 1, H 2, N 160, M 200, inputs
  from a numpy seed; tolerance 1e-5 of the largest gradient;
* CPU emulations of the kernels' arithmetic, bf16 and f32 (3xTF32), that
  walk the column groups, the depth items and each of K5b's passes. Every
  group computes the same S and dP from the same items in the same order
  (so they are computed once here); each group's output product reads its
  own columns of K (K5a), dO (dV) or Q (dK) and writes its own columns.
  Clean runs pass K5's rows of ``kernels/tolerance.py``; a group left
  unwritten, a group reading or writing another group's columns, the last
  depth item of S or of dP dropped, the ragged KV tail (K5a) or q tail
  (K5b) read on past its end unmasked, the dV pass fed dS^T, dK left
  unscaled and, in f32, a single TF32 pass fall outside them.
"""
import importlib
import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.kernels.tolerance import agreement, tol_id
from test_torch_f32_kernels import mm
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FA = importlib.import_module("layoutllm_t2i_torch.kernels.flash_attention")
GRAD_REL = 1e-5   # of the largest gradient
# csrc/flash_attention.cu: a block's output columns at most (BwdWide::kON,
# BwdF32S's kD of DqSW/DvSW/DkSW), the streamed rows of a tile (DqWide's
# kBS; BwdF32S's) and the scores' depth an item, by dtype
GROUP_COLS = 320
TILE_ROWS = {torch.bfloat16: 32, torch.float32: 16}
ITEM_COLS = {torch.bfloat16: 64, torch.float32: 32}


def _packed(a):
    """(B, H, N, d) -> (B, N, H*d)."""
    b, h, n, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, n, h * d))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, order="C")).requires_grad_(grad)


@pytest.mark.parametrize("d", [328, 640, 1280])
def test_k5_past_320_matches_pallas_vjp(rng, d):
    b, h, n, m = 1, 2, 160, 200
    q, k, v = (rng.standard_normal((b, h, r, d), dtype=np.float32)
               for r in (n, m, m))
    g = rng.standard_normal((b, h, n, d), dtype=np.float32)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, scale, 128, 128, True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [_packed(np.asarray(w)) for w in vjp(jnp.asarray(g))]

    qp, kp, vp, gp = (_t(_packed(a)) for a in (q, k, v, g))
    out, lse = K.flash_attention_lse_plain(qp, kp, vp, h, scale)
    delta = K.attention_delta(out, gp, h)
    plain = K.flash_attention_bwd_plain(qp, kp, vp, gp, lse, delta, h, scale)
    leaves = [_t(_packed(a), grad=True) for a in (q, k, v)]
    auto = torch.autograd.grad(K.flash_attention(*leaves, h, scale), leaves, gp)
    for got in (plain, auto):
        for a, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                       atol=GRAD_REL * np.abs(w).max(),
                                       err_msg=f"d{name} at d {d}")


@pytest.mark.parametrize("d,widths", [(328, (328, 328)), (636, (640, 636)),
                                      (1280, (1280, 1280))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kid", ["K5a", "K5b"])
def test_kernel_width_past_320_is_the_column_group_width(kid, dtype, d, widths):
    # past K5's widest instantiation (320) no head dim raises: the
    # column-group kernels run each d at its own width, the padded copy's
    # (bf16 636 at 640, whole 16-byte vectors), as K1 past 512
    width = widths[dtype is torch.float32]
    assert FA.kernel_width(kid, dtype, d) == width == FA.padded_head_dim(d, dtype)
    assert FA.kernel_width(kid, dtype, 320) == 320


def column_groups(d):
    """[(c0, ow)] of the column-group kernels at head dim d: G = ceil(d /
    320) groups of ow = ceil(d / G) columns rounded up to 8."""
    g = math.ceil(d / GROUP_COLS)
    ow = -(-math.ceil(d / g) // 8) * 8
    return [(i * ow, ow) for i in range(g)]


@pytest.mark.parametrize("d,groups", [
    (328, [(0, 168), (168, 168)]), (640, [(0, 320), (320, 320)]),
    (636, [(0, 320), (320, 320)]),
    (1280, [(0, 320), (320, 320), (640, 320), (960, 320)])])
def test_column_groups_cover_d(d, groups):
    # d 640 runs as 2 x 320 (not 512 + 128); every column < d lies in one
    # group, and the last group is the only one to reach past d. The
    # emulation's groups are the C code's: bf16 launch_bwd_wide's G and
    # wide_cols, f32 bwd_f32_stream's ow, both at 320 columns a block
    assert column_groups(d) == groups
    assert groups[-1][0] < d <= groups[-1][0] + groups[-1][1]
    src = (Path(FA.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()
    assert "static constexpr int kON = 320;" in src
    assert "const int G = (D + C::kON - 1) / C::kON, ow = wide_cols(D, G);" in src
    assert ("int wide_cols(int D, int parts) { return ((D + parts - 1) / parts "
            "+ 7) / 8 * 8; }") in src
    assert "using DqSW = BwdF32S<320, 5, 32, false, 0, true>;" in src
    assert "const int ow = C::kWide ? ((Dt + G - 1) / G + 7) / 8 * 8 : D;" in src
    assert "const int G = C::kWide ? (Dt + C::kD - 1) / C::kD : 1;" in src


def _heads(t, heads):
    """(B, rows, H*d) -> (B, H, rows, d) f32."""
    b, n, hc = t.shape
    return t.float().view(b, n, heads, hc // heads).transpose(1, 2)


def _tile_pad(t, rows, fault_tail):
    """The streamed operand t (B, H, len, w) as the kernel's tiles read it:
    rounded up to whole tiles of ``rows``, zeros past its end (the tensor
    maps' fill), or with ``fault_tail`` the rows that follow it in memory
    (the next (batch, head)'s first rows)."""
    b, h, n, w = t.shape
    pad = -n % rows
    tail = (t.reshape(b * h, n, w).roll(-1, 0)[:, :pad].reshape(b, h, pad, w)
            if fault_tail else t.new_zeros(b, h, pad, w))
    return torch.cat([t, tail], dim=2)


def _product(a, b, passes):
    """a @ b as the kernel's products take it: bf16 operands (exact in f32)
    summed in f32 (``passes`` None), or f32 operands in 3xTF32 (3), or one
    TF32 pass (1, the fault)."""
    return a @ b if passes is None else mm(a, b, passes)


def _scores(x, y, item, passes, drop_last):
    """x y^T over the depth in items of ``item`` columns, summed one item
    after another into one accumulator (the kernels' chain over the score
    items); ``drop_last``: the last item left out."""
    d = x.shape[-1]
    items = [slice(c, c + item) for c in range(0, d, item)]
    if drop_last:
        items = items[:-1]
    acc = None
    for i in items:
        p = _product(x[..., i], y[..., i].transpose(-1, -2), passes)
        acc = p if acc is None else acc + p
    return acc


def _k5_wide_emulated(kid, q, k, v, dout, lse, delta, heads, scale,
                      fault=None):
    """The column-group kernels' arithmetic on the CPU: K5a (dQ) or K5b's
    dV pass then its dK pass (dK, dV), in q's dtype (bf16: bf16 products
    summed in f32, P and dS rounded to bf16 before their products; f32:
    3xTF32 products, P and dS f32). The stream is read in whole tiles
    (TILE_ROWS; zeros past its end), the scores chain over ITEM_COLS-column
    items, P = exp2(S c - lse log2 e) is masked to 0 past the stream's
    end, and each column group (``column_groups``) adds its output
    product's columns of the tile's operand and stores its columns below
    d, dQ and dK times the scale. ``fault``: "group_unwritten" (the last
    group never stores), "group_reads_other" (group 0's output product
    reads group 1's columns), "group_writes_other" (group 0 stores at group
    1's columns), "drop_s_item" / "drop_dp_item" (the last item of S / dP
    left out), "tail_unmasked" (the last tile read on past the stream's
    end, K5b's statistics too, and P not masked), "dv_from_ds" (the dV pass
    fed dS^T), "dk_unscaled", "tf32_one_pass" (f32: one TF32 pass a
    product)."""
    dtype = q.dtype
    passes = None if dtype is torch.bfloat16 else (1 if fault == "tf32_one_pass" else 3)
    rnd = (lambda t: t.to(torch.bfloat16).float()) if dtype is torch.bfloat16 else (lambda t: t)
    bs, item = TILE_ROWS[dtype], ITEM_COLS[dtype]
    tail = fault == "tail_unmasked"
    qh, kh, vh, doh = (_heads(t, heads) for t in (q, k, v, dout))
    b, _, n, d = qh.shape
    m = kh.shape[2]
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    c = torch.tensor(scale, dtype=torch.float32) * log2e
    l2, dl = (lse * log2e)[..., None], delta[..., None]        # (b, h, n, 1)
    dqa = kid == "K5a"
    if dqa:   # K/V streamed in tiles of keys; the q rows' statistics
        kt, vt = _tile_pad(kh, bs, tail), _tile_pad(vh, bs, tail)
        qt, dot, l2t, dlt = qh, doh, l2, dl
        live = torch.arange(kt.shape[2]) < m                    # the keys
        live = live.view(1, 1, 1, -1)
    else:     # Q/dO streamed in tiles of q rows, with their statistics
        kt, vt = kh, vh
        qt, dot = _tile_pad(qh, bs, tail), _tile_pad(doh, bs, tail)
        l2t, dlt = _tile_pad(l2, bs, tail), _tile_pad(dl, bs, tail)
        live = (torch.arange(qt.shape[2]) < n).view(1, 1, -1, 1)  # the q rows
    # (q rows, keys) orientation; K5b's kernels compute the transposes
    s = _scores(qt, kt, item, passes, fault == "drop_s_item")
    p = torch.exp2(s * c - l2t)
    if not tail:
        p = p * live
    outs = {}
    want = ("dq",) if dqa else ("dv", "dk")
    for which in want:
        if which == "dv" and fault != "dv_from_ds":
            a, x = rnd(p).transpose(-1, -2), dot          # dV += P^T dO
        else:
            dp = _scores(dot, vt, item, passes, fault == "drop_dp_item")
            ds = rnd(p * (dp - dlt))
            a, x = (ds, kt) if which == "dq" else (ds.transpose(-1, -2),
                                                    dot if which == "dv" else qt)
        mul = 1.0 if which == "dv" or (which == "dk" and fault == "dk_unscaled") else scale
        out = torch.zeros(b, heads, a.shape[2], d)
        groups = column_groups(d)
        for g, (c0, ow) in enumerate(groups):
            if fault == "group_unwritten" and g == len(groups) - 1:
                continue
            r0 = groups[1][0] if fault == "group_reads_other" and g == 0 else c0
            w0 = groups[1][0] if fault == "group_writes_other" and g == 0 else c0
            cols = min(ow, d - r0, d - w0)
            out[..., w0:w0 + cols] = _product(a, x[..., r0:r0 + cols], passes) * mul
        outs[which] = out.transpose(1, 2).reshape(b, -1, heads * d).to(dtype)
    return outs["dq"] if dqa else (outs["dk"], outs["dv"])


# the planted faults, each kernel's own
_FAULTS = {"K5a": ("group_unwritten", "group_reads_other", "group_writes_other",
                   "drop_s_item", "drop_dp_item", "tail_unmasked"),
           "K5b": ("group_unwritten", "group_reads_other", "group_writes_other",
                   "drop_s_item", "drop_dp_item", "tail_unmasked",
                   "dv_from_ds", "dk_unscaled")}


def _case(kid, dtype, d, n, fault, heads=2):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, n, heads * d, generator=g).to(dtype)
               for _ in range(3))
    dout = (0.1 * torch.randn(1, n, heads * d, generator=g)).to(dtype)
    scale = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, scale)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, scale)
    ref = ref[0] if kid == "K5a" else ref[1:]
    return agreement(tol_id(kid, dtype), _k5_wide_emulated(
        kid, q, k, v, dout, lse, delta, heads, scale, fault), ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kid,d,n,fault", [
    # clean: the first width past 320 (two groups of 168, the last ragged:
    # 328 = 168 + 160), one head's 640 and 1280 at the 24^2 gated sites'
    # length (606 = 18 x 32 + 30 = 37 x 16 + 14: ragged last tiles)
    *((kid, d, n, None) for kid in ("K5a", "K5b")
      for d, n in ((328, 606), (640, 606), (1280, 200))),
    # each planted fault at d 640 (300 = 9 x 32 + 12 = 18 x 16 + 12)
    *((kid, 640, 300, f) for kid, faults in _FAULTS.items() for f in faults),
    # a dropped last item at d 328, where it holds 8 of the 328 columns
    *((kid, 328, 300, f) for kid in ("K5a", "K5b")
      for f in ("drop_s_item", "drop_dp_item")),
])
def test_k5_wide_tolerance_separates_rounding_from_faults(kid, d, n, fault, dtype):
    got = _case(kid, dtype, d, n, fault)
    assert got["ok"] == (fault is None), got


@pytest.mark.parametrize("kid", ["K5a", "K5b"])
def test_k5_wide_f32_one_tf32_pass_falls_outside(kid):
    # the f32 forms' products are 3xTF32: one TF32 pass (operands rounded
    # once to 10 mantissa bits) is another function, outside the f32 row
    got = _case(kid, torch.float32, 640, 300, "tf32_one_pass")
    assert not got["ok"], got
