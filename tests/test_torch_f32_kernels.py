"""The f32 forms of K1, K5a/K5b, K4, K6, K7, K8a and K8b on the CPU: their
stated tolerances against CPU emulations of the kernels' arithmetic, and
the plain versions against the Pallas kernels at the f32 block choices.

The CUDA kernels run only on the card. Their f32 products are 3xTF32 on
TF32 wgmma (K1, K5a, K5b; ``csrc/tf32_gemm.cuh``: K4, K6, K8a and K8b):
each operand split into hi = tf32(x) and lo = tf32(x - hi) (round to
nearest, ties away, to 10 mantissa bits, as ``cvt.rna.tf32.f32``), three
TF32 products hi*hi + hi*lo + lo*hi summed in f32. K7's weights are int8,
exact in TF32 (tested), so on the same mainloop's int8 B mode its products
are two TF32 passes, a_lo q + a_hi q. The emulations below repeat that
split and each kernel's tiling (K1's online softmax over K/V tiles with P
in f32, S's chain and each tile's P V truncating into a fresh accumulator,
K5's stages and output products at its tiles, with its transposed operands
at P's slots, the wgmma mainloop's 32-deep stages truncating into a fresh
accumulator, f32 LN(x) and h): they must pass the f32 rows of
``kernels/tolerance.py`` against the plain versions, and a single TF32
pass (operands rounded once: a different function, about 4e-4 off), a
dropped ragged K/V tail or k step, a missing rescale, K4's s applied after
the residual, K6's residual added twice, K8a's bias dropped, K4's, K6's,
K7's and K8b's gate read from the first half's rows, a stale B lo, int8 B
or V stage, V^T's keys off P's permuted k, K1's partial last chunk of d
dropped, an unzeroed fresh accumulator or one accumulator over the
5120-deep down product (K4, K6), K5's transposed operands off the slots, a
stale K5 stage, K7's bytes converted as unsigned, and K7's scale missing or
folded into its weights before the dot must fail them (one K5 accumulator
over the whole stream, and one K7 accumulator over the down product, stay
inside their rows at the main path's lengths, tested as such).

The Pallas kernels run in interpret mode, as the JAX package's own tests
run them, at the shapes where f32 picks other blocks than bf16 (K4's
``_blocks`` halves its row block at item size 4; the GroupNorm kernels'
``_gn_group_chunks`` and ``_gn_rows_block`` budget bytes, so f32 cuts a
sample into more channel chunks or fewer rows), and the f32 plain versions
of K6, K7, K8a and K8b against their Pallas kernels with f32 operands at
m = 1024 rows.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas import matmul as jmm
from layoutllm_t2i_tpu.ops.pallas.ffn import _blocks as jax_blocks
from layoutllm_t2i_tpu.ops.pallas.ffn import (_ffn_ln_call, ffn_geglu_fused,
                                              ffn_ln_geglu_scaled_q)
from layoutllm_t2i_tpu.ops.pallas.norms import (_gn_group_chunks, _gn_pallas,
                                                _gn_pallas_rows, _gn_rows_block)

from layoutllm_t2i_torch.kernels import (
    attention_delta, ffn_geglu, ffn_geglu_plain, ffn_ln_geglu,
    ffn_ln_geglu_plain, ffn_ln_geglu_q, ffn_ln_geglu_q_plain,
    flash_attention_bwd_plain, flash_attention_lse_plain, geglu_fused,
    geglu_plain, group_norm, linear_fused, linear_plain,
)
from layoutllm_t2i_torch.kernels.ffn import _blocks, ffn_eligible
from layoutllm_t2i_torch.ops.quant import quantize_tensor
from layoutllm_t2i_torch.kernels.tolerance import TOLERANCE, agreement, tol_id
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

F32 = torch.float32
BYTES = (torch.int8, torch.uint8)   # B operands exact in TF32


def tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from 0."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def mm(a, b, passes=3):
    """a @ b as the tensor cores take f32 operands: 3xTF32 (hi*hi + hi*lo +
    lo*hi, f32 sums), or one TF32 pass (``passes=1``, the fault)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_q(a, q, passes=2):
    """a @ q for an int8 q (exact in TF32) as the int8 B mode of
    tf32_gemm.cuh takes it: a_lo q + a_hi q, or one TF32 pass
    (``passes=1``, the fault)."""
    ah = tf32(a)
    return ah @ q if passes == 1 else tf32(a - ah) @ q + ah @ q


def split(x):
    """(hi, lo) = (tf32(x), tf32(x - hi)), as f32_tiles.cuh split."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def rz(x):
    """x (float64) as f32 rounded toward zero: how the tensor cores add a
    product into their accumulator. They truncate there (the finding of the
    f32 forms' first card runs, f32_tiles.cuh mma3); an 8-deep product of
    TF32 values is exact in float64."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def chain(acc, products):
    """The products (a, b) added one after another into the accumulator
    ``acc`` as a tensor-core chain adds them: a @ b exactly, then truncated
    into acc. acc None: a fresh accumulator, which the first product
    overwrites (wgmma's scale-d 0, or mma3's zeroed fragment)."""
    for a, b in products:
        t = a.double() @ b.double()
        acc = rz(t if acc is None else acc.double() + t)
    return acc


def tc_products(ah, al, bh, bl, drop_lo_hi=False, passes=3):
    """The 3xTF32 products of a @ b (a (..., n, K), b (..., K, N), split
    into hi and lo) in the order of the TF32 wgmma chains: lo*hi and hi*lo
    of each 8-deep step, then hi*hi of each. ``bl`` None: b is exact in
    TF32 (int8 weights), and the products are lo*b of each step, then hi*b
    of each. ``drop_lo_hi`` leaves lo*hi out, ``passes=1`` keeps hi*hi
    alone (the faults)."""
    steps = [slice(k0, k0 + 8) for k0 in range(0, ah.shape[-1], 8)]
    small = []
    for s in steps if passes == 3 else ():
        if not drop_lo_hi:
            small.append((al[..., s], bh[..., s, :]))
        if bl is not None:
            small.append((ah[..., s], bl[..., s, :]))
    return small + [(ah[..., s], bh[..., s, :]) for s in steps]


def gemm(a, w, passes=3, k_tail=False, stage=32, fault=None):
    """a w^T as tf32_gemm.cuh gemm_tile sums it: ``stage``-deep slices
    (zeros past K), each slice's products (``tc_products``: A split in
    registers, B's hi and lo tiles, or the values of an int8 (or, the
    fault, uint8) w as they are, its int8 B mode) truncating into a fresh accumulator (``chain``) that is
    added to the sum in round-to-nearest f32. Faults: ``never_zeroed`` (the
    fresh accumulator carried into the next slice), ``stale_lo`` (a slice
    read against the previous slice's B lo), ``stale_b`` (an int8 w's slice
    read as the previous slice's bytes converted), ``lo_hi_dropped``,
    ``one_chain`` (the whole contraction in one accumulator), ``k_tail``
    (a ragged last slice dropped) and ``passes=1`` (one TF32 pass)."""
    kd = a.shape[1]
    end = kd - kd % stage if k_tail else kd
    acc = torch.zeros(a.shape[0], w.shape[0])
    part, prev_b = None, None
    for k0 in range(0, end, stage):
        ah, al = split(a[:, k0:k0 + stage])
        b = w[:, k0:k0 + stage].float().t()
        bh, bl = (b, None) if w.dtype in BYTES else split(b)
        prev, prev_b = prev_b, (bh if bl is None else bl)
        if fault == "stale_lo":
            bl = torch.zeros_like(bl) if prev is None else prev[:bl.shape[0]]
        if fault == "stale_b":
            bh = torch.zeros_like(bh) if prev is None else prev[:bh.shape[0]]
        carried = part if fault in ("never_zeroed", "one_chain") else None
        part = chain(carried, tc_products(ah, al, bh, bl,
                                          fault == "lo_hi_dropped", passes))
        if fault != "one_chain":
            acc = acc + part
    return part if fault == "one_chain" else acc


def _split(t, heads):
    b, n, hc = t.shape
    return t.view(b, n, heads, hc // heads).transpose(1, 2)


def _packed(t):
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def test_tf32_split_is_exact_to_2_22():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 10
    hi = tf32(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float(((hi - x) / x).abs().max()) <= 2.0 ** -11
    err = (hi + tf32(x - hi) - x).abs() / x.abs()
    assert float(err.max()) <= 2.0 ** -21
    # ties away from zero, as cvt.rna
    half = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32(half).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


# ---------------------------------------------------------------------------
# K1 and its lse


def _k1_emulated(q, k, v, heads, scale, bk, fault=None, width=None):
    """K1/f32 on the CPU: up to the 160 width ``_k1_ss_emulated``
    (flash_fwd_f32_ss_kernel), at d = 512 ``_k1_wgmma_emulated``
    (flash_fwd_f32_wgmma_kernel). Returns (out, lse)."""
    if q.shape[-1] // heads == 512:
        return _k1_wgmma_emulated(q, k, v, heads, scale, bk, fault)
    return _k1_ss_emulated(q, k, v, heads, scale, bk, fault, width)


def _slot_rows(t):
    """t's key rows (dim -2) as V^T's key slots hold them when V is taken
    without the transposition's permutation: row r of each 8-key block
    replaced by row p_key_slot(r) (key 2 t at slot t, 2 t + 1 at t + 4)."""
    r = torch.arange(t.shape[-2])
    slot = (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1)
    return t[..., slot.clamp(max=t.shape[-2] - 1), :]


def _k1_ss_emulated(q, k, v, heads, scale, bk, fault=None, width=None):
    """flash_fwd_f32_ss_kernel (K1/f32 at widths up to 160) on the CPU. Q, K
    and V in chunks of 32 values, zeros past d (the k loop stops at d); K
    and V split once (the pre-pass), Q once a block. Per tile of ``bk`` keys
    (zeros past M): S's d / 8 k steps' products (``tc_products``: lo*hi and
    hi*lo of each, then hi*hi) truncating into one fresh accumulator
    (``chain``); the ragged tail scores -inf; the online softmax in f32, P
    unrounded; O += P V, P split once, V's transposed hi and lo tiles, the
    tile's products truncating into a fresh accumulator added to the
    rescaled O in round-to-nearest f32. Faults: ``stale_v`` (the previous
    tile's V stage), ``v_slots`` (V^T's keys not at P's permuted k),
    ``d_tail_dropped`` (the partial last 32-value chunk of d), ``drop_chunk``
    (the ``width``'s last 64 columns of Q K^T), ``pad_nonzero`` (the
    width's columns past d read from the next head), ``lo_hi_dropped``,
    ``never_zeroed`` (P V's fresh accumulator carried into the next tile),
    ``tf32_one_pass``, ``kv_tail`` (the ragged last tile), ``rescale`` (the
    row sum not rescaled). Returns (out, lse)."""
    passes = 1 if fault == "tf32_one_pass" else 3
    qh, kh, vh = (_split(t, heads) for t in (q, k, v))
    b, h, n, d = qh.shape
    m, d0 = kh.shape[2], d
    if fault == "d_tail_dropped":   # d 40: columns 32..39; d 80: 64..79
        qh = qh.clone()
        qh[..., d - d % 32:] = 0
    elif fault == "drop_chunk":     # d 160: columns 128..159
        qh = qh.clone()
        qh[..., 64 * ((width - 1) // 64):] = 0
    elif fault == "pad_nonzero":    # the pre-pass's zeros past d not written
        nb = lambda t: torch.cat([t, t.roll(-1, 1)[..., :width - d]], dim=-1)
        qh, kh = nb(qh), nb(kh)
        vh = torch.cat([vh, torch.zeros_like(vh[..., :width - d])], dim=-1)
    c = torch.tensor(scale, dtype=F32) * torch.tensor(1.4426950408889634, dtype=F32)
    d = qh.shape[-1]       # the width under "pad_nonzero"
    m_run = torch.full((b, h, n, 1), -torch.inf)
    den = torch.zeros(b, h, n, 1)
    acc = torch.zeros(b, h, n, d)
    q_hi, q_lo = split(qh)
    part, prev_v = None, torch.zeros(b, h, bk, d)
    end = m - m % bk if fault == "kv_tail" else m
    for k0 in range(0, end, bk):
        rows = min(bk, m - k0)
        kt, vt = torch.zeros(b, h, bk, d), torch.zeros(b, h, bk, d)
        kt[:, :, :rows], vt[:, :, :rows] = kh[:, :, k0:k0 + rows], vh[:, :, k0:k0 + rows]
        k_hi, k_lo = split(kt.transpose(-1, -2))
        s = chain(None, tc_products(q_hi, q_lo, k_hi, k_lo,
                                    fault == "lo_hi_dropped", passes))
        s[..., rows:] = -torch.inf
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        p = torch.exp2(s * c - m_new * c)
        alpha = torch.exp2((m_run - m_new) * c)
        den = (den if fault == "rescale" else den * alpha) + p.sum(-1, keepdim=True)
        vs = {"stale_v": prev_v, "v_slots": _slot_rows(vt)}.get(fault, vt)
        prev_v = vt
        p_hi, p_lo = split(p)
        v_hi, v_lo = split(vs)
        part = chain(part if fault == "never_zeroed" else None,
                     tc_products(p_hi, p_lo, v_hi, v_lo,
                                 fault == "lo_hi_dropped", passes))
        acc = acc * alpha + part
        m_run = m_new
    out = (acc * (1.0 / den))[..., :d0]   # the columns of the true d
    return _packed(out), (m_run * scale + torch.log(den))[..., 0]


def _k1_wgmma_emulated(q, k, v, heads, scale, bk, fault=None):
    """flash_fwd_f32_wgmma_kernel (K1/f32 at d = 512) on the CPU. Per tile
    of ``bk`` keys (zeros past M) S is computed once: warpgroup g sums d's
    32-wide chunks 8 g .. 8 g + 7, each chunk's products (``tc_products``:
    Q split as it is read, K's hi and lo tiles) truncating into a fresh
    accumulator (``chain``) added in round-to-nearest f32; S = S_0 + S_1
    through shared memory. The ragged tail scores -inf; the online softmax
    runs in f32, P unrounded; O += P V on wgmma too, the tile's products
    (P split once, V's transposed hi and lo tiles) truncating into a fresh
    accumulator added to O in RN. Faults: ``stale_partial`` (S_1 of the previous tile, a
    stale shared-memory stage), ``stale_k_lo`` (the previous chunk's K lo),
    ``d_chunk_dropped``, ``lo_hi_dropped``, ``never_zeroed`` (a chunk's
    accumulator carried into the next), ``tf32_one_pass``, ``kv_tail``.
    Returns (out, lse)."""
    passes = 1 if fault == "tf32_one_pass" else 3
    qh, kh, vh = (_split(t, heads) for t in (q, k, v))
    b, h, n, d = qh.shape
    m = kh.shape[2]
    c = torch.tensor(scale, dtype=F32) * torch.tensor(1.4426950408889634, dtype=F32)
    m_run = torch.full((b, h, n, 1), -torch.inf)
    den = torch.zeros(b, h, n, 1)
    acc = torch.zeros(b, h, n, d)
    prev_s1 = torch.zeros(b, h, n, bk)
    end = m - m % bk if fault == "kv_tail" else m
    for k0 in range(0, end, bk):
        rows = min(bk, m - k0)
        kt, vt = torch.zeros(b, h, bk, d), torch.zeros(b, h, bk, d)
        kt[:, :, :rows], vt[:, :, :rows] = kh[:, :, k0:k0 + rows], vh[:, :, k0:k0 + rows]
        halves = []
        for g in (0, 1):
            sp, part, prev_kl = torch.zeros(b, h, n, bk), None, None
            for ch in range(8 * g, 8 * g + 8):
                if fault == "d_chunk_dropped" and ch == 11:
                    continue
                cols = slice(32 * ch, 32 * ch + 32)
                q_hi, q_lo = split(qh[..., cols])
                k_hi, k_lo = split(kt[..., cols].transpose(-1, -2))
                lo = k_lo
                if fault == "stale_k_lo":
                    lo = torch.zeros_like(k_lo) if prev_kl is None else prev_kl
                prev_kl = k_lo
                part = chain(part if fault == "never_zeroed" else None,
                             tc_products(q_hi, q_lo, k_hi, lo,
                                         fault == "lo_hi_dropped", passes))
                sp = sp + part
            halves.append(sp)
        s = halves[0] + (prev_s1 if fault == "stale_partial" else halves[1])
        prev_s1 = halves[1]
        s[..., rows:] = -torch.inf
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        p = torch.exp2(s * c - m_new * c)
        alpha = torch.exp2((m_run - m_new) * c)
        den = den * alpha + p.sum(-1, keepdim=True)
        p_hi, p_lo = split(p)
        v_hi, v_lo = split(vt)
        acc = acc * alpha + chain(None, tc_products(p_hi, p_lo, v_hi, v_lo,
                                                    passes=passes))
        m_run = m_new
    out = acc * (1.0 / den)
    return _packed(out), (m_run * scale + torch.log(den))[..., 0]


# csrc/flash_attention.cu Fwd40W, Fwd64W, Fwd80W, Fwd128W, Fwd160W, Fwd512W:
# keys a stage (d 144 runs Fwd160W, the 160 width)
K1_BK = {40: 64, 64: 32, 80: 32, 128: 32, 144: 32, 160: 32, 512: 32}
K1_WIDTH = {144: 160}


@pytest.mark.parametrize("d,fault", [
    *((d, f) for d in (40, 80, 512) for f in (None, "tf32_one_pass")),
    (80, "kv_tail"), (80, "rescale"), (40, "kv_tail"), (512, "kv_tail"),
    # d = 512 on wgmma: a stale shared-memory stage (the other warpgroup's
    # partial S, or K's lo tile), a dropped chunk of d, no lo*hi term, a
    # fresh accumulator never zeroed
    *((512, f) for f in ("stale_partial", "stale_k_lo", "d_chunk_dropped",
                         "lo_hi_dropped", "never_zeroed")),
    # d = 40 and 80 on wgmma: a stale V stage, V^T's keys off P's permuted
    # k, the partial last chunk of d dropped, no lo*hi term, P V's fresh
    # accumulator never zeroed
    *((d, f) for d in (40, 80) for f in ("stale_v", "v_slots", "d_tail_dropped",
                                         "lo_hi_dropped", "never_zeroed")),
    # the widths past 80 (num_heads 5's 64 and 128, 768^2's 160; d 144 on
    # the 160 width): a dropped ragged tail, the width's last 64 columns
    # dropped from the scores, its pad columns not zeroed, a stale V stage
    *((d, f) for d in (64, 128, 160) for f in (None, "tf32_one_pass", "kv_tail")),
    (128, "drop_chunk"), (160, "drop_chunk"), (160, "stale_v"),
    (144, None), (144, "pad_nonzero"), (144, "drop_chunk"),
])
def test_k1_f32_tolerance_separates_rounding_from_faults(d, fault):
    # M = 1054 (the 32^2 gated sites' length) leaves a ragged last stage at
    # every BK; the output and the lse are held to their f32 rows
    heads = 1 if d == 512 else 2
    n = 300 if d == 512 else 1054
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, n, heads * d, generator=g)
    k, v = (torch.randn(1, 1054, heads * d, generator=g) for _ in range(2))
    scale = d ** -0.5
    ref = flash_attention_lse_plain(q, k, v, heads, scale)
    kids = (tol_id("K1", F32), tol_id("lse", F32))
    assert kids == ("K1/f32", "lse/f32")
    got = agreement(kids, _k1_emulated(q, k, v, heads, scale, K1_BK[d], fault,
                                       K1_WIDTH.get(d, d)), ref)
    assert got["ok"] == (fault is None), got


# ---------------------------------------------------------------------------
# K5a and K5b


# csrc/flash_attention.cu DqF40, DqF80, DkvF40, DkvF80: rows a streamed
# stage, and whether the two warpgroups share the resident rows and take the
# stages in turns (their sums added at the end, warpgroup 0's first). Past
# d 80: DqF64/DkvF64 as d 80's; DqF128, DqF160 and K5b's two passes
# (DvF128 then DkF128, DvF160 then DkF160: the same products in the same
# order as one pass) one warpgroup on every stage; d 144 runs the 160s
K5_TILES = {("K5a", 40): (48, False), ("K5a", 80): (16, True),
            ("K5b", 40): (32, False), ("K5b", 80): (16, True),
            ("K5a", 64): (32, True), ("K5b", 64): (16, True),
            **{(kid, d): (16, False) for kid in ("K5a", "K5b")
               for d in (128, 144, 160, 168, 256, 300, 320)}}
# the width a head dim runs at, where it is not d itself
K5_WIDTH = {144: 160, 168: 256, 300: 320}
# past 160 (widths 256 and 320, flash_bwd_f32_stream_kernel) the scores'
# depth streams in items of this many columns: each item's k steps' lo*hi
# and hi*lo, then their hi*hi, chained on into one accumulator
K5_STREAM_COLS = 32


def _stage(t, r0, bs):
    """Rows r0 .. r0 + bs - 1 of t (..., rows, d), zeros past its end."""
    out = torch.zeros(*t.shape[:-2], bs, t.shape[-1])
    rows = min(bs, t.shape[-2] - r0)
    out[..., :rows, :] = t[..., r0:r0 + rows, :]
    return out


def _stage_next(t, r0, bs):
    """As ``_stage``, but rows past t's end read on into the next (batch,
    head)'s first rows (dim 1 rolled; with one head, its own): a stage read
    past N."""
    out = _stage(t, r0, bs)
    rows = t.shape[-2] - r0
    if rows < bs:
        out[..., rows:, :] = t.roll(-1, 1)[..., :bs - rows, :]
    return out


def _score_products(ah, al, y, width, drop, passes):
    """The products of A B^T, B = y^T, in the order of the kernels' chain:
    one chain over the whole depth up to 160; past it (``width`` 256, 320)
    the d-streamed kernel's items of K5_STREAM_COLS columns, one after
    another."""
    bh, bl = split(y.transpose(-1, -2))
    if width <= 160:
        return tc_products(ah, al, bh, bl, drop, passes)
    items = [slice(c0, c0 + K5_STREAM_COLS)
             for c0 in range(0, ah.shape[-1], K5_STREAM_COLS)]
    return [p for i in items for p in tc_products(
        ah[..., i], al[..., i], bh[..., i, :], bl[..., i, :], drop, passes)]


def _k5_wgmma_emulated(kid, q, k, v, dout, lse, delta, heads, scale, fault=None):
    # (faults past d 80: ``drop_chunk``, the width's last 64 columns dropped
    # from the scores (past 160 its last item, K5_STREAM_COLS); ``pad_nonzero``,
    # the width's columns past d read from the next head in the scores'
    # operands; past 160: ``q_tail`` (K5b's last stage read past N, its
    # statistics too), ``skip_dv`` and ``skip_dk`` (a pass of K5b not run:
    # its output left unwritten, zeros here))
    """flash_bwd_dq_f32_ss_kernel (K5a: dQ over K/V stages) or
    flash_bwd_dkv_f32_ss_kernel (K5b: dK and dV over Q/dO stages) on the CPU,
    at the kernels' tiles (``K5_TILES``). Every operand split once into hi
    and lo (the pre-pass). A stage (zeros past the stream's end): S and dP
    (K5b: S^T = K Q^T, dP^T = V dO^T), each the d / 8 k steps' lo*hi and
    hi*lo, then hi*hi, truncating into a fresh accumulator (``chain``); P =
    exp2(S c - lse log2 e) masked to 0 past the ragged edge, dS = P (dP -
    delta), both f32; each output product (dQ += dS K; dV += P^T dO, dK +=
    dS^T Q) with the score fragment split as register A and the transposed
    operand's hi and lo tiles as B, its kBS / 8 k steps' products
    truncating into a fresh accumulator, added to the warpgroup's running
    sum in round-to-nearest f32. With the split tiles (d 80) the two
    warpgroups take the stages in turns and their sums meet at the end.
    Faults: ``t_slots`` (the transposed operand at unpermuted slots, not
    the key slots of the A fragment's permuted k), ``stale_stage`` (the
    previous stage's transposed tiles), ``lo_hi_dropped``, ``never_zeroed``
    (an output product's fresh accumulator carried into the next stage),
    ``kv_tail`` (the ragged last stage dropped), ``one_chain`` (each running
    sum the tensor cores' own accumulator over the whole stream),
    ``tf32_one_pass``. Returns dQ, or (dK, dV)."""
    passes = 1 if fault == "tf32_one_pass" else 3
    drop = fault == "lo_hi_dropped"
    bs, two = K5_TILES[kid, q.shape[-1] // heads]
    qh, kh, vh, doh = (_split(t, heads) for t in (q, k, v, dout))
    log2e = torch.tensor(1.4426950408889634, dtype=F32)
    c = torch.tensor(scale, dtype=F32) * log2e
    l2, dl = lse[..., None] * log2e, delta[..., None]     # (b, h, n, 1)
    dqa = kid == "K5a"
    ra, rb = (qh, doh) if dqa else (kh, vh)               # resident: A of S, dP
    sa, sb = (kh, vh) if dqa else (qh, doh)               # streamed: B of S, dP
    outs = 1 if dqa else 2                                # dQ; dV, dK
    d = qh.shape[-1]
    width = K5_WIDTH.get(d, d)
    xa, xb, ya, yb = ra, rb, sa, sb                       # the scores' operands
    if fault == "drop_chunk":
        chunk = 64 if width <= 160 else K5_STREAM_COLS
        xa, xb = ra.clone(), rb.clone()
        xa[..., chunk * ((width - 1) // chunk):] = 0
        xb[..., chunk * ((width - 1) // chunk):] = 0
    elif fault == "pad_nonzero":
        nb = lambda t: torch.cat([t, t.roll(-1, 1)[..., :width - d]], dim=-1)
        xa, xb, ya, yb = nb(ra), nb(rb), nb(sa), nb(sb)
    a_hi, a_lo = split(xa)
    b_hi, b_lo = split(xb)
    length = sa.shape[2]
    end = length - length % bs if fault == "kv_tail" else length
    sums = [[None] * outs for _ in range(2)]              # [warpgroup][output]
    parts, prev = [None] * outs, [torch.zeros(*sa.shape[:2], bs, sa.shape[-1])] * 2
    q_tail = fault == "q_tail" and not dqa
    stage = _stage_next if q_tail else _stage
    for t, r0 in enumerate(range(0, end, bs)):
        g = t % 2 if two else 0
        rows = bs if q_tail else min(bs, length - r0)
        st_a, st_b = stage(sa, r0, bs), stage(sb, r0, bs)
        s = chain(None, _score_products(a_hi, a_lo, stage(ya, r0, bs), width,
                                        drop, passes))
        dp = chain(None, _score_products(b_hi, b_lo, stage(yb, r0, bs), width,
                                         drop, passes))
        if dqa:   # the rows' statistics: (b, h, n, 1)
            p = torch.exp2(s * c - l2)
            p[..., rows:] = 0
            ds = p * (dp - dl)
            prods = [(ds, st_a)]                          # dQ += dS K
        else:     # the stage's columns: (b, h, 1, bs), zero past N
            l2t = stage(l2, r0, bs).transpose(-1, -2)
            dlt = stage(dl, r0, bs).transpose(-1, -2)
            p = torch.exp2(s * c - l2t)
            p[..., rows:] = 0
            ds = p * (dp - dlt)
            prods = [(p, st_b), (ds, st_a)]               # dV += P^T dO, dK += dS^T Q
        for i, (a, bt) in enumerate(prods):
            if fault == "t_slots":
                bt = _slot_rows(bt)
            elif fault == "stale_stage":
                bt, prev[i] = prev[i], bt
            carried = parts[i] if fault in ("never_zeroed", "one_chain") else None
            parts[i] = chain(carried, tc_products(*split(a), *split(bt), drop,
                                                  passes))
            if fault == "one_chain":
                sums[g][i] = parts[i]
            else:
                sums[g][i] = parts[i] if sums[g][i] is None else sums[g][i] + parts[i]
            if fault == "one_chain" and two:
                parts[i] = sums[1 - g][i]                 # the other warpgroup's chain
    got = [sums[0][i] if sums[1][i] is None else sums[0][i] + sums[1][i]
           for i in range(outs)]
    if dqa:
        return _packed(got[0] * scale)
    if fault in ("skip_dv", "skip_dk"):
        got[fault == "skip_dk"] = torch.zeros_like(got[0])
    return _packed(got[1] * scale), _packed(got[0])


# the faults of the wgmma design that the f32 rows catch
K5_FAULTS = ("t_slots", "stale_stage", "lo_hi_dropped", "never_zeroed",
             "kv_tail")


def _k5_case(kid, d, fault, n=1054, heads=2):
    """The emulated K5a or K5b at N = M = n against the plain backward,
    under the f32 row (``agreement``)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, n, heads * d, generator=g) for _ in range(3))
    dout = 0.1 * torch.randn(1, n, heads * d, generator=g)
    scale = d ** -0.5
    out, lse = flash_attention_lse_plain(q, k, v, heads, scale)
    delta = attention_delta(out, dout, heads)
    ref = flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, scale)
    ref = ref[0] if kid == "K5a" else ref[1:]
    return agreement(tol_id(kid, F32), _k5_wgmma_emulated(
        kid, q, k, v, dout, lse, delta, heads, scale, fault=fault), ref)


@pytest.mark.parametrize("d,kid,fault", [
    *((d, kid, f) for d in (40, 80) for kid in ("K5a", "K5b")
      for f in (None, "tf32_one_pass") + K5_FAULTS),
    # the widths past 80 (d 144 on the 160 width): a dropped ragged tail, a
    # stale stage, the width's last 64 columns dropped from the scores, its
    # pad columns not zeroed
    *((d, kid, f) for d in (64, 128, 160) for kid in ("K5a", "K5b")
      for f in (None, "kv_tail", "stale_stage")),
    *((d, kid, "drop_chunk") for d in (128, 160) for kid in ("K5a", "K5b")),
    *((144, kid, f) for kid in ("K5a", "K5b") for f in (None, "pad_nonzero")),
    # the d-streamed widths 256 and 320 (one head: the emulation walks every
    # 8-deep step of the scores' chain): a dropped ragged tail, the last
    # 32-column item dropped from the scores, K5b's last stage read past N
    # and a pass not run; d 168 and 300 inside the widths, their pad
    # columns not zeroed
    *((d, kid, f) for d in (256, 320) for kid in ("K5a", "K5b")
      for f in (None, "kv_tail", "drop_chunk")
      + (("q_tail", "skip_dv", "skip_dk") if kid == "K5b" else ())),
    *((d, kid, f) for d in (168, 300) for kid in ("K5a", "K5b")
      for f in (None, "pad_nonzero")),
    *((300, kid, "drop_chunk") for kid in ("K5a", "K5b")),
])
def test_k5_f32_tolerance_separates_rounding_from_faults(d, kid, fault):
    # N = M = 1054 (the 32^2 gated sites' length), past d 80 606 (768^2's
    # 24^2 gated sites): a ragged last stage at every tile (48, 32, 16 rows)
    got = _k5_case(kid, d, fault, n=606 if d > 80 else 1054,
                   heads=1 if d > 160 else 2)
    assert got["ok"] == (fault is None), got


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("kid", ["K5a", "K5b"])
def test_k5_f32_one_chain_drifts_within_the_row(kid, d):
    # One tensor-core accumulator over the whole stream (no fresh one a
    # stage) truncates at every product: at N = M = 1054 it drifts 5-13x
    # as far as the fresh accumulators (1.0e-5 of rms(b) at d 40, 5.6e-6
    # at d 80, where each warpgroup sums half the stages), and 3.9e-5 and
    # 2.0e-5 at the 64^2 sites' 4126: inside the 5e-5 row, which cannot
    # catch it at the main path's lengths (K1's chained sums read 3e-5 on
    # the card over 4096 keys). The kernels keep a fresh accumulator a stage.
    clean, chained = _k5_case(kid, d, None), _k5_case(kid, d, "one_chain")
    assert clean["ok"] and chained["ok"], (clean, chained)
    assert chained["rms_rel_err"] >= 4 * clean["rms_rel_err"], (clean, chained)


# ---------------------------------------------------------------------------
# K4


def _ff_f32_up(a, w1, b1, fault=None):
    """The up GEMM of csrc/ffn.cu's f32 K4 and K6 and of K8b/f32 on
    tf32_gemm.cuh's TF32 wgmma mainloop (``gemm(..., stage=32)``): Wa's and
    Wg's rows as two B boxes of one tile, h = (a + ba) * gelu_erf(g + bg)
    kept in f32 (K8b's bias b1 may be None). Faults: ``tf32_one_pass`` and
    ``k_tail``; ``gate_from_wa`` (the second box read at Wa's rows); ``up_``
    with ``never_zeroed``, ``stale_lo`` or ``one_chain``
    (``gemm``'s)."""
    inner = w1.shape[0] // 2
    gate_rows = w1[:inner] if fault == "gate_from_wa" else w1[inner:]
    up = lambda w: gemm(a, w, **_ff_gemm_kw(fault, "up"))
    a_, g_ = up(w1[:inner]), up(gate_rows)
    if b1 is not None:
        a_, g_ = a_ + b1[:inner], g_ + b1[inner:]
    return a_ * torch.nn.functional.gelu(g_)


def _ff_gemm_kw(fault, which):
    """``gemm`` arguments of the up or down GEMM (``which``) under
    ``fault``: ``tf32_one_pass`` and ``k_tail`` reach both, ``up_<f>`` and
    ``down_<f>`` one of them."""
    own = fault[len(which) + 1:] if fault and fault.startswith(which + "_") else None
    return dict(stage=32, passes=1 if fault == "tf32_one_pass" else 3,
                k_tail=fault == "k_tail", fault=own)


def _ff_f32_products(a, w1, w2, b1, fault=None):
    """The f32 K4's and K6's two GEMMs on a: ``_ff_f32_up``, then h W2^T on
    the same mainloop. Returns the down product's sum (before b2)."""
    return gemm(_ff_f32_up(a, w1, b1, fault), w2, **_ff_gemm_kw(fault, "down"))


def _k4_f32_emulated(x, lw, lb, w1, b1, w2, b2, s, fault=None, eps=1e-5):
    """csrc/ffn.cu's f32 K4: LN(x) in f32 once per row (mean, then the
    centred variance), the up and down GEMMs as ``_ff_f32_products`` sums
    them, then x + s (acc + b2)."""
    m = x.shape[0]
    xn = _ln_f32(x, lw, lb, eps)
    y = _ff_f32_products(xn, w1, w2, b1, fault) + b2
    if fault == "s_after_residual":
        return (y + x) * s
    out = x + y * s
    if fault == "rows_tail":   # the last, ragged 128-row block unwritten
        out[m - m % 128:] = 0
    return out


def _ln_f32(x, lw, lb, eps=1e-5):
    """The f32 LN pre-pass: the mean, then the centred variance, a row."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    return (x - mean) * rstd * lw + lb


def _k4_inputs(m, k, inner, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape, scale=1.0, shift=0.0: (
        torch.randn(*shape, generator=g) * scale + shift)
    return (rnd(m, k, scale=2.0, shift=0.5), rnd(k, scale=0.2, shift=1.0),
            rnd(k, scale=0.2), rnd(2 * inner, k, scale=k ** -0.5),
            rnd(2 * inner, scale=0.1), rnd(k, inner, scale=inner ** -0.5),
            rnd(k, scale=0.1))


@pytest.mark.parametrize("k,s,fault", [
    *((k, s, None) for k in (320, 640) for s in (1.0, 0.5)),
    (320, 0.5, "tf32_one_pass"), (640, 1.0, "tf32_one_pass"),
    (320, 0.5, "s_after_residual"), (72, 0.5, None), (72, 0.5, "k_tail"),
    (320, 1.0, "rows_tail"),
])
def test_k4_f32_tolerance_separates_rounding_from_faults(k, s, fault):
    # M = 200 = 128 + 72: a ragged last row block; K = 72 (inner 288): both
    # contractions end in a ragged 32-deep step
    m, inner = 200, 4 * k
    args = _k4_inputs(m, k, inner)
    ref = ffn_ln_geglu_plain(*args, s)
    got = agreement(tol_id("K4", F32), _k4_f32_emulated(*args, s, fault=fault), ref)
    assert got["ok"] == (fault is None), got


def _ff_f32_case(kid, m, k, inner, fault):
    """(emulated, plain) of K4/f32 (s = 0.5) or K6/f32 at (m, k, inner), or
    of K8b/f32 ("K8b", "K8b nobias": its GEGLU GEMM on x to inner
    columns)."""
    x, lw, lb, w1, b1, w2, b2 = _k4_inputs(m, k, inner)
    if kid.startswith("K8b"):
        b = None if kid.endswith("nobias") else b1
        return _ff_f32_up(x, w1, b, fault), geglu_plain(x, w1, b)
    if kid == "K4":
        args = (x, lw, lb, w1, b1, w2, b2, 0.5)
        return _k4_f32_emulated(*args, fault=fault), ffn_ln_geglu_plain(*args)
    r = torch.randn(m, k, generator=torch.Generator().manual_seed(1))
    return (_k6_f32_emulated(x, w1, b1, w2, b2, r, fault),
            ffn_geglu_plain(x, w1, b1, w2, b2, r))


_FF_WGMMA_CASES = [
    (72, 200, None), (72, 200, "gate_from_wa"), (72, 200, "k_tail"),
    (72, 288, "up_never_zeroed"), (72, 288, "down_never_zeroed"),
    (320, 1280, "up_stale_lo"), (320, 1280, "down_stale_lo"),
]


@pytest.mark.parametrize("k,inner,fault,kid", [
    *(pytest.param(k, inner, f, kid, id=f"{k}-{inner}-{f}-{kid}")
      for k, inner, f in _FF_WGMMA_CASES for kid in ("K4", "K6")),
    # K8b/f32 runs the up GEMM alone, its bias given or absent
    *(pytest.param(k, inner, f, kid, id=f"{k}-{inner}-{f}-{kid}")
      for k, inner, f in _FF_WGMMA_CASES if not (f or "").startswith("down_")
      for kid in ("K8b", "K8b nobias")),
])
def test_ff_f32_wgmma_faults_leave_the_row(kid, k, inner, fault):
    # the up GEMM's B tile is 64 Wa rows over the same 64 Wg rows from two
    # tensor maps: inner 200 (not a multiple of 64) ends each in a ragged
    # box, zero past its own rows; a second box read at Wa's rows, a stage
    # summed against the previous stage's B lo and a fresh accumulator
    # never zeroed, in either GEMM, must fail the row. M = 200: a ragged
    # last row block; K = 72: a ragged 32-deep stage
    out, ref = _ff_f32_case(kid, 200, k, inner, fault)
    got = agreement(tol_id(kid.split()[0], F32), out, ref)
    assert got["ok"] == (fault is None), got


@pytest.mark.parametrize("kid", ["K4", "K6"])
def test_ff_f32_one_chain_down_product_leaves_the_row(kid):
    # inner 5120 (K = 1280), the longest down contraction of the f32 paths:
    # a fresh accumulator a 32-deep stage holds the row, one accumulator
    # over the whole contraction drifts out of it (toward zero). s = 1 and
    # x of rms 1, as phase `kernels` draws K4's x: a residual of rms 2 (the
    # other tests' x) at s = 0.5 dilutes the drift to within the row. (K7's
    # two products a product drift less: test_ff_f32_down_chain_lengths_...)
    m, k, inner = 16, 1280, 5120
    x, lw, lb, w1, b1, w2, b2 = _k4_inputs(m, k, inner)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(2))
    if kid == "K4":
        h = _ff_f32_up(_ln_f32(x, lw, lb), w1, b1)
        ref = ffn_ln_geglu_plain(x, lw, lb, w1, b1, w2, b2, 1.0)
        res = x
    else:
        h = _ff_f32_up(x, w1, b1)
        res = torch.randn(m, k, generator=torch.Generator().manual_seed(1))
        ref = ffn_geglu_plain(x, w1, b1, w2, b2, res)
    fresh, long = (agreement(tol_id(kid, F32),
                             res + (gemm(h, w2, stage=32, fault=f) + b2), ref)
                   for f in (None, "one_chain"))
    assert fresh["ok"], fresh
    assert not long["ok"] and long["rms_rel_err"] > 10 * fresh["rms_rel_err"], (
        long, fresh)


# ---------------------------------------------------------------------------
# K6, K7, K8a and K8b


def _k6_f32_emulated(x, w1, b1, w2, b2, r, fault=None):
    """csrc/ffn.cu's f32 K6: K4/f32's up GEMM on x (no LN), h in f32, its
    down GEMM with r in place of x and s = 1: (acc + b2) + r."""
    y = _ff_f32_products(x, w1, w2, b1, fault) + b2
    return y + r + (r if fault == "residual_twice" else 0.0)


@pytest.mark.parametrize("k,fault", [
    (320, None), (640, None), (72, None), (320, "tf32_one_pass"),
    (72, "k_tail"), (320, "residual_twice"),
])
def test_k6_f32_tolerance_separates_rounding_from_faults(k, fault):
    # M = 200: a ragged last row block; K = 72: a ragged 32-deep step
    m, inner = 200, 4 * k
    x, _, _, w1, b1, w2, b2 = _k4_inputs(m, k, inner)
    r = torch.randn(m, k, generator=torch.Generator().manual_seed(1))
    ref = ffn_geglu_plain(x, w1, b1, w2, b2, r)
    got = agreement(tol_id("K6", F32), _k6_f32_emulated(x, w1, b1, w2, b2, r, fault), ref)
    assert got["ok"] == (fault is None), got


def _k7_f32_emulated(x, lw, lb, q1, s1, b1, q2, s2, b2, s, fault=None):
    """csrc/ffn.cu's f32 K7: K4/f32's LN pre-pass, then its up GEMM against
    Qa and Qg and its down GEMM against Q2 on tf32_gemm.cuh's TF32 wgmma
    mainloop with int8 B operands (``gemm``: 32-deep stages, each a_lo q,
    then a_hi q, truncating into a fresh accumulator added in
    round-to-nearest), a = acc sa + ba and y = acc s2 + b2 on the f32 sums,
    h in f32, out = x + s y. Faults: ``scale_before_dot`` folds the scales
    into the weights before the dot (q s is not exact in TF32, so the tensor
    cores read it rounded and two products lose its low half);
    ``scale_missing`` drops s2; ``int8_unsigned`` converts the bytes as
    unsigned; ``gate_from_qa`` reads the gate box at Qa's rows; ``up_<f>``
    and ``down_<f>`` plant ``gemm``'s fault f in one GEMM, ``k_tail`` and
    ``tf32_one_pass`` in both (``_ff_gemm_kw``)."""
    inner = q1.shape[0] // 2
    xn = _ln_f32(x, lw, lb)
    if fault == "scale_before_dot":
        # the dequantized weights, which TF32 does not hold, read rounded:
        # their lo part is zero, as the int8 B mode has none
        dq = lambda q, sc: tf32(q.float() * sc[:, None])
        a = gemm(xn, dq(q1[:inner], s1[:inner])) + b1[:inner]
        g = gemm(xn, dq(q1[inner:], s1[inner:])) + b1[inner:]
        y = gemm(a * torch.nn.functional.gelu(g), dq(q2, s2)) + b2
        return x + s * y
    if fault == "int8_unsigned":
        q1, q2 = q1.view(torch.uint8), q2.view(torch.uint8)
    gate_rows = q1[:inner] if fault == "gate_from_qa" else q1[inner:]
    up = lambda q: gemm(xn, q, **_ff_gemm_kw(fault, "up"))
    a = up(q1[:inner]) * s1[:inner] + b1[:inner]
    g = up(gate_rows) * s1[inner:] + b1[inner:]
    acc = gemm(a * torch.nn.functional.gelu(g), q2, **_ff_gemm_kw(fault, "down"))
    y = acc + b2 if fault == "scale_missing" else acc * s2 + b2
    return x + s * y


def _k7_inputs(m, k, inner):
    """K4's inputs with w1 and w2 quantized as quantize_unet_int8 quantizes
    them: (x, lw, lb, q1, s1, b1, q2, s2, b2)."""
    x, lw, lb, w1, b1, w2, b2 = _k4_inputs(m, k, inner)
    qw1, qw2 = quantize_tensor(w1), quantize_tensor(w2)
    assert qw1.scale.dtype is F32 and qw1.dtype is F32
    return x, lw, lb, qw1.q, qw1.scale, b1, qw2.q, qw2.scale, b2


@pytest.mark.parametrize("k,s,fault", [
    (320, 1.0, None), (320, 0.37, None), (640, 1.0, None), (80, 0.5, None),
    (320, 1.0, "tf32_one_pass"), (80, 0.5, "k_tail"),
    (320, 1.0, "scale_before_dot"), (320, 0.37, "scale_missing"),
])
def test_k7_f32_tolerance_separates_rounding_from_faults(k, s, fault):
    # M = 200: a ragged last row block; K = 80 (K % 16 == 0): a ragged
    # 32-deep stage of 16 in the up GEMM; weights quantized as
    # quantize_unet_int8 quantizes them
    m, inner = 200, 4 * k
    args = (*_k7_inputs(m, k, inner), s)
    ref = ffn_ln_geglu_q_plain(*args)
    got = agreement(tol_id("K7", F32), _k7_f32_emulated(*args, fault=fault), ref)
    assert got["ok"] == (fault is None), got


@pytest.mark.parametrize("k,inner,fault", [
    (80, 208, None), (80, 208, "int8_unsigned"), (80, 208, "gate_from_qa"),
    (80, 208, "up_never_zeroed"), (80, 208, "down_never_zeroed"),
    (320, 1280, "up_stale_b"), (320, 1280, "down_stale_b"),
    (80, 208, "k_tail"),
])
def test_k7_f32_wgmma_faults_leave_the_row(k, inner, fault):
    # the int8 B mode of the TF32 wgmma mainloop: the up GEMM's B tile is
    # 64 Qa rows over the same 64 Qg rows from two int8 tensor maps, inner
    # 208 (not a multiple of 64) ends each in a ragged box; K = 80 ends the
    # up contraction in a 16-deep stage, inner 208 the down one. Bytes
    # converted as unsigned, a gate box read at Qa's rows, a fresh
    # accumulator never zeroed, a stage converted from the previous stage's
    # bytes and a dropped ragged stage must fail the row. M = 200: a
    # ragged last row block
    args = (*_k7_inputs(200, k, inner), 0.5)
    ref = ffn_ln_geglu_q_plain(*args)
    got = agreement(tol_id("K7", F32), _k7_f32_emulated(*args, fault=fault), ref)
    assert got["ok"] == (fault is None), got


def test_int8_values_split_exactly_in_tf32():
    # the ground for the int8 B mode: every int8 value is its own TF32 hi,
    # with a zero lo, so a_lo q + a_hi q is the 3xTF32 product of a and q
    q = torch.arange(-128, 128, dtype=torch.int8).float()
    hi = tf32(q)
    assert torch.equal(hi, q) and torch.equal(tf32(q - hi), torch.zeros_like(q))
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 256, generator=g)
    qs = torch.randint(-127, 128, (256, 96), generator=g, dtype=torch.int8).float()
    np.testing.assert_array_equal(mm(a, qs).numpy(), mm_q(a, qs).numpy())


def _k8_f32_emulated(kid, x, w, b, r=None, fault=None):
    """csrc/matmul.cu's f32 K8a (acc + b, then + r) and K8b ((acc_a + ba)
    gelu(acc_g + bg), K4/f32's up GEMM: ``_ff_f32_up``) on the TF32 wgmma
    mainloop (32-deep stages)."""
    if kid == "K8b":
        return _ff_f32_up(x, w, b, fault)
    kw = dict(passes=1 if fault == "tf32_one_pass" else 3,
              k_tail=fault == "k_tail")
    y = gemm(x, w, stage=32, fault=fault, **kw)
    if b is not None and fault != "bias_dropped":
        y = y + b
    return y if r is None else y + r


@pytest.mark.parametrize("kid,k,n,extras,fault", [
    ("K8a", 1280, 320, "b", None), ("K8a", 1280, 320, "br", None),
    ("K8a", 72, 96, "", None), ("K8a", 1280, 320, "b", "tf32_one_pass"),
    ("K8a", 72, 96, "br", "k_tail"), ("K8a", 1280, 320, "br", "bias_dropped"),
    ("K8a", 1280, 320, "b", "stale_lo"), ("K8a", 1280, 320, "br", "lo_hi_dropped"),
    ("K8a", 72, 96, "b", "never_zeroed"), ("K8a", 1280, 320, "b", "never_zeroed"),
    ("K8b", 320, 1280, "b", None), ("K8b", 72, 96, "", None),
    ("K8b", 320, 1280, "b", "tf32_one_pass"), ("K8b", 72, 96, "b", "k_tail"),
])
def test_k8_f32_tolerance_separates_rounding_from_faults(kid, k, n, extras, fault):
    # M = 200: a ragged last row block; K = 72: a ragged 32-deep step;
    # (1280, 320) and (320, 1280) the down and up projections' widths
    m = 200
    g = torch.Generator().manual_seed(0)
    rnd = lambda *shape, scale=1.0: torch.randn(*shape, generator=g) * scale
    x = rnd(m, k)
    rows = n if kid == "K8a" else 2 * n
    w = rnd(rows, k, scale=k ** -0.5)
    b = rnd(rows, scale=0.1) if "b" in extras else None
    r = rnd(m, n) if "r" in extras else None
    ref = linear_plain(x, w, b, r) if kid == "K8a" else geglu_plain(x, w, b)
    out = _k8_f32_emulated(kid, x, w, b, r, fault)
    got = agreement(tol_id(kid, F32), out, ref)
    assert got["ok"] == (fault is None), got


def test_truncating_add_rounds_toward_zero():
    # rz: float64 to f32 toward zero where round-to-nearest rounds away;
    # chain: a fresh accumulator takes its first product as it is, then
    # truncates each sum into itself
    up = 1.0 + 2.0 ** -23 - 2.0 ** -30   # nearest f32: 1 + 2^-23
    x = torch.tensor([up, -up, 3.0], dtype=torch.float64)
    assert x.float().tolist() == [1.0 + 2.0 ** -23, -(1.0 + 2.0 ** -23), 3.0]
    assert rz(x).tolist() == [1.0, -1.0, 3.0]
    one = torch.ones(1, 1)
    tiny = torch.full((1, 1), 2.0 ** -23 - 2.0 ** -30)
    assert chain(None, [(one, one), (tiny, one)]).item() == 1.0
    assert chain(None, [(-one, one), (-tiny, one)]).item() == -1.0


@pytest.mark.parametrize("k", [1280, 2560, 5120])
def test_k8a_f32_chain_lengths_stay_within_the_row(k):
    # the routes-f32 down-projections' contractions (K = 1280, 2560, 5120)
    # under the truncation model: a fresh accumulator a 32-deep stage (12
    # products) holds the unchanged K8a/f32 row; one accumulator over the
    # whole contraction drifts several times further (toward zero)
    m, n = 64, 96
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=g)
    w = torch.randn(n, k, generator=g) * k ** -0.5
    ref = linear_plain(x, w)
    fresh = agreement("K8a/f32", gemm(x, w, stage=32), ref)
    assert fresh["ok"], fresh
    long = agreement("K8a/f32", gemm(x, w, stage=32, fault="one_chain"), ref)
    assert long["rms_rel_err"] > 3 * fresh["rms_rel_err"], (long, fresh)


@pytest.mark.parametrize("kid", ["K4", "K6", "K7"])
@pytest.mark.parametrize("inner", [1280, 2560, 5120])
def test_ff_f32_down_chain_lengths_stay_within_the_row(kid, inner):
    # the down products of K4/f32, K6/f32 and K7/f32 (h W2^T over inner =
    # 1280, 2560, 5120, then + b2 and the residual; K7: h Q2^T s2 on its
    # int8 B mode, two products a product) under the truncation model: a
    # fresh accumulator a 32-deep stage holds the row; one accumulator over
    # the whole contraction drifts several times further (K7 at 5120:
    # 1.6e-5 of rms(b) against 2.4e-7, still inside the row: two products a
    # product truncate into the chain less often than K4's and K6's three,
    # whose one chain leaves it)
    m, k = 16, inner // 4
    g = torch.Generator().manual_seed(0)
    h = torch.randn(m, inner, generator=g) * torch.nn.functional.gelu(
        torch.randn(m, inner, generator=g))
    w2 = torch.randn(k, inner, generator=g) * inner ** -0.5
    b2, res = torch.randn(k, generator=g) * 0.1, torch.randn(m, k, generator=g)
    s = 0.5 if kid == "K4" else 1.0
    if kid == "K7":
        qw2 = quantize_tensor(w2)
        w2, s2 = qw2.q, qw2.scale
        ref = res + s * ((h @ w2.float().t()) * s2 + b2)
    else:
        s2 = torch.ones(k)
        ref = res + s * linear_plain(h, w2, b2)
    rows = {fault: agreement(tol_id(kid, F32),
                             res + s * (gemm(h, w2, stage=32, fault=fault) * s2
                                        + b2), ref)
            for fault in (None, "one_chain")}
    assert rows[None]["ok"], rows
    assert rows["one_chain"]["rms_rel_err"] > 3 * rows[None]["rms_rel_err"], rows


def test_f32_rows_bound_the_whole_tensor_under_one_tf32_pass():
    # r no looser than 1e-4; the element-wise bounds are the kernels' own
    for kid in ("K1", "K4", "K5a", "K5b", "K6", "K7", "K8a", "K8b"):
        assert TOLERANCE[f"{kid}/f32"][2] <= 1e-4
    assert TOLERANCE["K2/f32"][2] <= 1e-4


# ---------------------------------------------------------------------------
# the plain f32 versions against the Pallas kernels at their f32 blocks


def test_k4_f32_sites_stay_eligible():
    # the training FF sites (rows at batch 8, K, inner): at item size 4 the
    # JAX package halves the row block, and every site still takes the
    # kernel (ops/nn.py routes as ffn_eligible says)
    for m, k, inner in ((32768, 320, 1280), (8192, 640, 2560), (2048, 1280, 5120)):
        assert _blocks(m, k, inner, 4) == jax_blocks(m, k, inner, 4)
        assert _blocks(m, k, inner, 4)[0] == _blocks(m, k, inner, 2)[0] // 2
        assert ffn_eligible(m, k, inner, 4) and ffn_eligible(m, k, inner)


@pytest.mark.parametrize("s", [1.0, 0.37])
def test_ffn_f32_plain_matches_pallas_at_f32_blocks(rng, s):
    # 2048 rows: the f32 row block (512) splits them in four where bf16's
    # (1024) would take two
    m, k, inner = 2048, 128, 512
    assert jax_blocks(m, k, inner, 4)[0] == 512 != jax_blocks(m, k, inner, 2)[0]
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f(m, k)
    wa, wg, w2 = f(k, inner) * 0.1, f(k, inner) * 0.1, f(inner, k) * 0.1
    ba, bg, b2 = f(inner) * 0.1, f(inner) * 0.1, f(k) * 0.1
    gamma = rng.uniform(0.5, 1.5, k).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, k).astype(np.float32)
    ref = np.asarray(_ffn_ln_call(
        *(jnp.asarray(a) for a in (x, wa, wg, ba, bg, w2, b2, gamma, beta)),
        s, 1e-5, interpret=True))
    w1 = np.concatenate([wa, wg], axis=1).T
    b1 = np.concatenate([ba, bg])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = ffn_ln_geglu(t(x), t(gamma), t(beta), t(w1), t(b1), t(w2.T), t(b2),
                       torch.tensor(s)).numpy()
    # f32 on both sides, differing in summation order (outputs up to ~10)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=2e-6)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("kind", ["chunks", "rows"])
def test_group_norm_f32_plain_matches_pallas_at_f32_blocks(rng, kind, silu):
    # chunks: 64 x 64 x 256 fits one VMEM block in bf16, two channel chunks
    # in f32; rows: 64 x 128 x 320 streams 2048-row blocks in bf16, 1024 in
    # f32
    if kind == "chunks":
        n, h, w, c = 1, 64, 64, 256
        k = _gn_group_chunks(h * w, c, 32, 4)
        assert k == 2 != _gn_group_chunks(h * w, c, 32, 2)
    else:
        n, h, w, c = 1, 64, 128, 320
        rb = _gn_rows_block(h * w, c, 4)
        assert rb == 1024 != _gn_rows_block(h * w, c, 2)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32) * 2.0 + 0.5
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32, 1e-6, silu)
    ref = (_gn_pallas(*args, interpret=True, k=k) if kind == "chunks"
           else _gn_pallas_rows(*args, interpret=True, rb=rb))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = group_norm(t(x.reshape(n, h * w, c)), t(gamma), t(beta), 32, 1e-6, silu)
    # f32 on both sides, differing in summation order only
    np.testing.assert_allclose(out.numpy(), np.asarray(ref).reshape(n, h * w, c),
                               atol=2e-5)


# the f32 plain versions of K6, K7, K8a and K8b against the Pallas kernels
# with f32 operands, at a shape every one of them takes (m = 1024 rows)

M_PALLAS, INNER_PALLAS = 1024, 256


def _rms_close(out, ref, rel=1e-5):
    """f32 on both sides, in another summation order: max |a - b| within
    ``rel`` of rms(b)."""
    ref = np.asarray(ref)
    rms = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
    err = float(np.abs(np.asarray(out) - ref).max())
    assert err <= rel * rms, (err, rms)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k", [128, 256])
def test_ffn_geglu_f32_plain_matches_pallas(rng, k):
    m, inner = M_PALLAS, INNER_PALLAS
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, r = f(m, k), f(m, k)
    wa, wg, w2 = f(k, inner) * k ** -0.5, f(k, inner) * k ** -0.5, f(inner, k) * inner ** -0.5
    ba, bg, b2 = f(inner) * 0.1, f(inner) * 0.1, f(k) * 0.1
    ref = ffn_geglu_fused(*(jnp.asarray(a) for a in (x, wa, wg, ba, bg, w2, b2, r)))
    out = ffn_geglu(_t(x), _t(np.concatenate([wa, wg], 1).T),
                    _t(np.concatenate([ba, bg])), _t(w2.T), _t(b2), _t(r))
    assert out.dtype is F32
    _rms_close(out.numpy(), ref)


@pytest.mark.parametrize("k,s", [(128, 1.0), (256, 0.37)])
def test_ffn_int8_f32_plain_matches_pallas(rng, k, s):
    m, inner = M_PALLAS, INNER_PALLAS
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f(m, k) * 2.0 + 0.5
    gamma = rng.uniform(0.5, 1.5, k).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, k).astype(np.float32)
    qw1 = quantize_tensor(torch.from_numpy(f(2 * inner, k) * k ** -0.5))
    qw2 = quantize_tensor(torch.from_numpy(f(k, inner) * inner ** -0.5))
    b1, b2 = f(2 * inner) * 0.1, f(k) * 0.1
    q1, s1 = qw1.q.numpy().T, qw1.scale.numpy()     # the JAX (in, out) layout
    ref = ffn_ln_geglu_scaled_q(
        jnp.asarray(x), jnp.asarray(q1[:, :inner]), jnp.asarray(q1[:, inner:]),
        jnp.asarray(s1[:inner]), jnp.asarray(s1[inner:]), jnp.asarray(b1[:inner]),
        jnp.asarray(b1[inner:]), jnp.asarray(qw2.q.numpy().T),
        jnp.asarray(qw2.scale.numpy()), jnp.asarray(b2), jnp.asarray(gamma),
        jnp.asarray(beta), jnp.float32(s))
    out = ffn_ln_geglu_q(_t(x), _t(gamma), _t(beta), qw1.q, qw1.scale, _t(b1),
                         qw2.q, qw2.scale, _t(b2), torch.tensor(s))
    assert out.dtype is F32
    _rms_close(out.numpy(), ref)


@pytest.mark.parametrize("bias,residual", [(False, False), (True, False),
                                           (True, True), (False, True)])
def test_linear_f32_plain_matches_pallas(rng, bias, residual):
    m, k, n = M_PALLAS, 256, INNER_PALLAS
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, w = f(m, k), f(k, n) * k ** -0.5          # the JAX (in, out) layout
    b, r = f(n) * 0.1, f(m, n)
    dummy = jnp.zeros((1, 1), jnp.float32)
    ref = jmm._mm_call(jnp.asarray(x), jnp.asarray(w),
                       jnp.asarray(b).reshape(1, -1) if bias else dummy,
                       jnp.asarray(r) if residual else dummy, interpret=True,
                       has_bias=bias, has_res=residual)
    if not residual:   # the public entry, as ops/nn.py calls it
        want = jmm.linear_fused(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b) if bias else None)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(ref))
    out = linear_fused(_t(x), _t(w.T), _t(b) if bias else None,
                       _t(r) if residual else None)
    assert out.dtype is F32
    _rms_close(out.numpy(), ref)


@pytest.mark.parametrize("k,bias", [(128, True), (256, False)])
def test_geglu_f32_plain_matches_pallas(rng, k, bias):
    m, n = M_PALLAS, INNER_PALLAS
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, wa, wg = f(m, k), f(k, n) * k ** -0.5, f(k, n) * k ** -0.5
    ba, bg = f(n) * 0.1, f(n) * 0.1
    ref = jmm.geglu_fused(jnp.asarray(x), jnp.asarray(wa), jnp.asarray(wg),
                          jnp.asarray(ba) if bias else None,
                          jnp.asarray(bg) if bias else None)
    out = geglu_fused(_t(x), _t(np.concatenate([wa, wg], 1).T),
                      _t(np.concatenate([ba, bg])) if bias else None)
    assert out.dtype is F32
    _rms_close(out.numpy(), ref)
