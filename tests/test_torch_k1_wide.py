"""K1 past head dim 512 on the CPU (num_heads 1: d 640 at 512^2's 32^2
sites, 640 and 1280 at 768^2's 48^2 and 24^2 sites).

The Pallas forward kernels take any head dim, zero-padded to 128 lanes;
the port runs d past 512 on its column-group kernels
(``csrc/flash_attention.cu`` ``flash_fwd_wide_kernel`` in bf16,
``flash_fwd_f32_wide_kernel`` in f32). On a CPU tensor the wrapper takes
the plain version, so here:

* the plain forward and its lse against the Pallas forward in interpret
  mode at d 520, 640 and 1280, B 1, H 2, N 160, M 200, inputs from a numpy
  seed; tolerance 2e-5 (both f32, differing in summation order over a
  contraction past 512 features, as for d >= 128 in
  ``tests/test_torch_kernels.py``);
* CPU emulations of both kernels' arithmetic (the output columns split
  into groups that each compute the same scores, the scores' depth in
  items, the ragged KV tail masked, P in bf16 (bf16) or split for 3xTF32
  products (f32)) hold K1's unchanged rows of ``kernels/tolerance.py``
  against the plain version, and planted faults fall outside them: a
  column group never written, a group reading V or writing O at another
  group's columns, the last depth item of the scores dropped, the ragged
  KV tail scoring 0, a 0.5 % scale error, and in f32 one TF32 pass.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas.flash_attention import _flash_fwd_rule
from layoutllm_t2i_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.kernels.tolerance import agreement
from test_torch_f32_kernels import _packed, _split, chain, split, tc_products
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FA = importlib.import_module("layoutllm_t2i_torch.kernels.flash_attention")
ATOL = 2e-5
LOG2E = 1.4426950408889634
# csrc/flash_attention.cu FwdWide160 and FwdWideW: keys a tile, columns a
# score item, the most O columns of a consumer warpgroup, warpgroups a
# column group (bf16: both warpgroups of a block; f32: one a block), and
# the columns of a P V part (f32)
WIDE = {torch.bfloat16: dict(bk=64, depth=64, on=160, per_group=2),
        torch.float32: dict(bk=32, depth=32, on=256, per_group=1, part=64)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("d", [520, 640, 1280])
def test_plain_forward_and_lse_match_pallas_past_512(rng, d):
    heads, n, m = 2, 160, 200
    q = rng.standard_normal((1, heads, n, d), dtype=np.float32)
    k = rng.standard_normal((1, heads, m, d), dtype=np.float32)
    v = rng.standard_normal((1, heads, m, d), dtype=np.float32)
    scale = d ** -0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    ref = np.asarray(jax_flash(jq, jk, jv, scale, 256, 512, True))
    ref_lse = np.asarray(_flash_fwd_rule(jq, jk, jv, scale, 256, 512, True)[1][4])
    ref_lse = ref_lse[:, 0, :n].reshape(1, heads, n)
    packed = lambda a: _t(a.transpose(0, 2, 1, 3).reshape(1, a.shape[2], -1))
    unpacked = lambda t: t.numpy().reshape(1, n, heads, d).transpose(0, 2, 1, 3)
    out = K.flash_attention(packed(q), packed(k), packed(v), heads, scale)
    np.testing.assert_allclose(unpacked(out), ref, atol=ATOL)
    out, lse = K.flash_attention_lse_plain(packed(q), packed(k), packed(v),
                                           heads, scale)
    np.testing.assert_allclose(unpacked(out), ref, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL)
    # and the wrapper takes the head dim: the column-group kernel's width
    for dtype in (torch.bfloat16, torch.float32):
        assert FA.kernel_width("K1", dtype, d) == d


def wide_layout(d, dtype):
    """(groups, the columns of a consumer warpgroup, the column blocks it
    owns): csrc/flash_attention.cu launch_wide and launch_fwd_f32_wide, G
    = ceil(d / 320) (bf16, two warpgroups a group) or ceil(d / 256) (f32),
    each warpgroup ceil(d / warpgroups) columns rounded up to 8
    (wide_cols)."""
    w = WIDE[dtype]
    groups = -(-d // (w["on"] * w["per_group"]))
    parts = groups * w["per_group"]
    ow = -(-(-(-d // parts)) // 8) * 8
    assert ow <= w["on"]
    return groups, ow, [(j * ow, min((j + 1) * ow, d)) for j in range(parts)]


@pytest.mark.parametrize("d,groups,ow", [
    (520, 2, 136), (640, 2, 160), (1280, 4, 160), (1272, 4, 160)])
def test_bf16_column_groups_split_d_evenly(d, groups, ow):
    # d 640 runs as 2 x 320 (not 512 + 128), every warpgroup's columns
    # whole 8-column blocks, no column of d left to no warpgroup
    g, w, blocks = wide_layout(d, torch.bfloat16)
    assert (g, w) == (groups, ow)
    assert blocks[0][0] == 0 and blocks[-1][1] == d
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(blocks, blocks[1:]))


def test_wide_tiles_are_the_c_configs():
    # the emulations' tiles are the kernels' (csrc/flash_attention.cu)
    src = (Path(FA.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()
    bk, _, _, on = map(int, re.search(
        r"using FwdWide160 = FwdWide<(\d+), (\d+), (\d+), (\d+)>;", src).groups())
    assert dict(bk=bk, on=on) == {k: WIDE[torch.bfloat16][k] for k in ("bk", "on")}
    # G and ow as wide_layout computes them
    assert ("const int G = (D + 2 * C::kON - 1) / (2 * C::kON), "
            "ow = wide_cols(D, 2 * G);") in src
    assert "const int G = (D + C::kON - 1) / C::kON, ow = wide_cols(D, G);" in src
    assert "return ((D + parts - 1) / parts + 7) / 8 * 8;" in src
    on, bk, _, _, part = map(int, re.search(
        r"using FwdWideW = FwdF32Wide<(\d+), (\d+), (\d+), (\d+), (\d+)>;",
        src).groups())
    assert dict(on=on, bk=bk, part=part) == {
        k: WIDE[torch.float32][k] for k in ("on", "bk", "part")}
    # bf16 score items of 64 columns (one swizzle chunk), f32 of 32
    assert "const int items = (D + 63) / 64;" in src
    assert "const int items = (D + 31) / 32;" in src


def _wide_emulated(q, k, v, heads, scale, fault=None):
    """K1 past 512 on the CPU as the column-group kernels compute it, in
    the operands' dtype's form: per tile of ``bk`` keys (zeros past M) the
    scores in items of ``depth`` columns (bf16: one chain in f32; f32: each
    item's 3xTF32 products truncating into a fresh accumulator added in
    round-to-nearest, ``chain``), the ragged tail -inf, the online softmax
    in f32 with p = exp2(s c - m c); O += P V on each warpgroup's columns
    (bf16: P rounded to bf16; f32: P split, each part's products into a
    fresh accumulator added to the rescaled O in RN); O times the f32
    reciprocal of the row sum, lse = m scale + ln(sum). Every group computes
    the same scores, so they are computed once here. ``fault``: "unwritten"
    (the last column group never writes O: zeros), "v_offset" (the last
    warpgroup reads V at the first one's columns), "o_offset" (the last
    warpgroup writes its O over the first one's columns), "drop_item" (the
    scores' last depth item dropped), "tail_zero" (the zero-filled keys
    past M score 0), "scale" (c 0.5 % off), "tf32_one_pass" (f32: one TF32
    pass). Returns (out, lse)."""
    dtype = q.dtype
    w = WIDE[dtype]
    f32 = dtype is torch.float32
    bk, depth = w["bk"], w["depth"]
    passes = 1 if fault == "tf32_one_pass" else 3
    qh, kh, vh = (_split(t, heads).float() for t in (q, k, v))
    b, h, n, d = qh.shape
    m = kh.shape[2]
    groups, ow, blocks = wide_layout(d, dtype)
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    if fault == "scale":
        c = c * 1.005
    items = list(range(0, d, depth))
    if fault == "drop_item":
        items = items[:-1]
    m_run = torch.full((b, h, n, 1), -torch.inf)
    den = torch.zeros(b, h, n, 1)
    acc = torch.zeros(b, h, n, d)
    for k0 in range(0, m, bk):
        rows = min(bk, m - k0)
        kt, vt = torch.zeros(b, h, bk, d), torch.zeros(b, h, bk, d)
        kt[:, :, :rows], vt[:, :, :rows] = kh[:, :, k0:k0 + rows], vh[:, :, k0:k0 + rows]
        s = torch.zeros(b, h, n, bk)
        for c0 in items:
            cols = slice(c0, c0 + depth)
            if f32:
                q_hi, q_lo = split(qh[..., cols])
                k_hi, k_lo = split(kt[..., cols].transpose(-1, -2))
                s = s + chain(None, tc_products(q_hi, q_lo, k_hi, k_lo,
                                                passes=passes)).float()
            else:
                s = s + qh[..., cols] @ kt[..., cols].transpose(-1, -2)
        if fault != "tail_zero":
            s[..., rows:] = -torch.inf
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        p = torch.exp2(s * c - m_new * c)
        alpha = torch.exp2((m_run - m_new) * c)
        den = den * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        p_hi, p_lo = split(p)
        for j, (a0, a1) in enumerate(blocks):
            src = blocks[0][0] if fault == "v_offset" and j == len(blocks) - 1 else a0
            vs = vt[..., src:src + (a1 - a0)]
            if not f32:
                acc[..., a0:a1] += p.to(torch.bfloat16).float() @ vs
                continue
            for p0 in range(0, a1 - a0, w["part"]):
                v_hi, v_lo = split(vs[..., p0:p0 + w["part"]])
                part = chain(None, tc_products(p_hi, p_lo, v_hi, v_lo,
                                               passes=passes)).float()
                acc[..., a0 + p0:a0 + p0 + part.shape[-1]] += part
        m_run = m_new
    out = acc * (1.0 / den)
    last = blocks[-1]
    if fault == "unwritten":
        per_group = len(blocks) // groups
        out[..., blocks[-per_group][0]:] = 0
    elif fault == "o_offset":
        width = last[1] - last[0]
        out[..., :width] = out[..., last[0]:last[1]].clone()
        out[..., last[0]:last[1]] = 0
    lse = (m_run * scale + torch.log(den))[..., 0]
    return _packed(out).to(dtype), lse


FAULTS = [None, "unwritten", "v_offset", "o_offset", "drop_item", "tail_zero",
          "scale"]


@pytest.mark.parametrize("d,n,fault", [
    *((640, 1054, f) for f in FAULTS), (520, 1054, None), (520, 1054, "drop_item"),
    (1280, 606, None), (1280, 606, "unwritten"), (1280, 606, "o_offset")])
def test_bf16_wide_tolerance_separates_rounding_from_faults(d, n, fault):
    # one head, N = M = 1054 = 16 * 64 + 30 (the 32^2 gated sites) or 606 =
    # 9 * 64 + 30 (768^2's 24^2 ones): the last key tile ragged; at d 520
    # the last depth item holds 8 columns and the last warpgroup 112 of its
    # 136
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, n, d, generator=g).to(torch.bfloat16)
               for _ in range(3))
    scale = d ** -0.5
    ref = K.flash_attention_lse_plain(q, k, v, 1, scale)
    got = agreement(("K1", "lse"), _wide_emulated(q, k, v, 1, scale, fault), ref)
    assert got["ok"] == (fault is None), got


@pytest.mark.parametrize("d,n,fault", [
    *((640, 1054, f) for f in FAULTS + ["tf32_one_pass"]), (520, 1054, None),
    (520, 1054, "drop_item"), (1280, 606, None), (1280, 606, "tf32_one_pass")])
def test_f32_wide_tolerance_separates_rounding_from_faults(d, n, fault):
    # N = M = 1054 = 32 * 32 + 30 and 606 = 18 * 32 + 30: the last 32-key
    # tile ragged; d 640 runs 3 blocks of 216 columns (the last 208), 1280
    # 5 of 256, 520 3 of 176 (the last 168); the f32 rows of K1 and its lse
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, n, d, generator=g) for _ in range(3))
    scale = d ** -0.5
    ref = K.flash_attention_lse_plain(q, k, v, 1, scale)
    got = agreement(("K1/f32", "lse/f32"), _wide_emulated(q, k, v, 1, scale, fault),
                    ref)
    assert got["ok"] == (fault is None), got
