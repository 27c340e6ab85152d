"""The f32 forms of K1, K5a/K5b and K4 on the CPU: their stated tolerances
against CPU emulations of the kernels' arithmetic, and the plain versions
against the Pallas kernels at the f32 block choices.

The CUDA kernels run only on the card. Their f32 products are 3xTF32 on
mma.sync (``csrc/f32_tiles.cuh``): each operand split into hi = tf32(x) and
lo = tf32(x - hi) (round to nearest, ties away, to 10 mantissa bits, as
``cvt.rna.tf32.f32``), three TF32 products hi*hi + hi*lo + lo*hi summed in
f32. The emulations below repeat that split and each kernel's tiling
(K1's online softmax over K/V stages with P in f32, K5's stages, K4's
32-deep k steps, 128-row blocks and f32 LN(x) and h): they must pass the
f32 rows of ``kernels/tolerance.py`` against the plain versions, and a
single TF32 pass (operands rounded once: a different function, about
4e-4 off), a dropped ragged K/V tail, a missing rescale and K4's s applied
after the residual must fail them.

The Pallas kernels run in interpret mode, as the JAX package's own tests
run them, at the shapes where f32 picks other blocks than bf16 (K4's
``_blocks`` halves its row block at item size 4; the GroupNorm kernels'
``_gn_group_chunks`` and ``_gn_rows_block`` budget bytes, so f32 cuts a
sample into more channel chunks or fewer rows).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas.ffn import _blocks as jax_blocks
from layoutllm_t2i_tpu.ops.pallas.ffn import _ffn_ln_call
from layoutllm_t2i_tpu.ops.pallas.norms import (_gn_group_chunks, _gn_pallas,
                                                _gn_pallas_rows, _gn_rows_block)

from layoutllm_t2i_torch.kernels import (
    attention_delta, ffn_ln_geglu, ffn_ln_geglu_plain,
    flash_attention_bwd_plain, flash_attention_lse_plain, group_norm,
)
from layoutllm_t2i_torch.kernels.ffn import _blocks, ffn_eligible
from layoutllm_t2i_torch.kernels.tolerance import TOLERANCE, agreement, tol_id
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

F32 = torch.float32


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


def _k1_emulated(q, k, v, heads, scale, bk, fault=None):
    """csrc/flash_attention.cu flash_fwd_f32_kernel on the CPU: K/V in
    BK-row stages zero-filled past M, the ragged tail scored -inf, the row
    max over the raw scores, p = exp2(s c - m c) in f32 (P never rounded),
    O += P V, O / l; lse = m scale + ln l. Returns (out, lse)."""
    passes = 1 if fault == "tf32_one_pass" else 3
    qh, kh, vh = (_split(t, heads) for t in (q, k, v))
    b, h, n, d = qh.shape
    m = kh.shape[2]
    c = torch.tensor(scale, dtype=F32) * torch.tensor(1.4426950408889634, dtype=F32)
    m_run = torch.full((b, h, n, 1), -torch.inf)
    den = torch.zeros(b, h, n, 1)
    acc = torch.zeros(b, h, n, d)
    end = m - m % bk if fault == "kv_tail" else m
    for k0 in range(0, end, bk):
        s = mm(qh, kh[:, :, k0:k0 + bk].transpose(-1, -2), passes)
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        p = torch.exp2(s * c - m_new * c)
        alpha = torch.exp2((m_run - m_new) * c)
        den = (den if fault == "rescale" else den * alpha) + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vh[:, :, k0:k0 + bk], passes)
        m_run = m_new
    out = acc * (1.0 / den)
    return _packed(out), (m_run * scale + torch.log(den))[..., 0]


# csrc/flash_attention.cu Fwd40F, Fwd80F, Fwd512F: K/V rows a stage
K1_BK = {40: 64, 80: 32, 512: 16}


@pytest.mark.parametrize("d,fault", [
    *((d, f) for d in (40, 80, 512) for f in (None, "tf32_one_pass")),
    (80, "kv_tail"), (80, "rescale"), (40, "kv_tail"), (512, "kv_tail"),
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
    got = agreement(kids, _k1_emulated(q, k, v, heads, scale, K1_BK[d], fault), ref)
    assert got["ok"] == (fault is None), got


# ---------------------------------------------------------------------------
# K5a and K5b


def _k5_emulated(kid, q, k, v, dout, lse, delta, heads, scale, bs=32,
                 fault=None):
    """csrc/flash_attention.cu's f32 K5a (dQ over K/V stages) or K5b (dK
    and dV over q/dO stages) on the CPU: P = exp2(S c - lse log2 e) masked
    past the ragged edge, dS = P (dP - delta), P and dS in f32, every
    product 3xTF32."""
    passes = 1 if fault == "tf32_one_pass" else 3
    qh, kh, vh, doh = (_split(t, heads) for t in (q, k, v, dout))
    n, m = qh.shape[2], kh.shape[2]
    log2e = torch.tensor(1.4426950408889634, dtype=F32)
    c = torch.tensor(scale, dtype=F32) * log2e
    l2, dl = lse[..., None] * log2e, delta[..., None]
    if kid == "K5a":
        dq = torch.zeros_like(qh)
        end = m - m % bs if fault == "kv_tail" else m
        for k0 in range(0, end, bs):
            kt, vt = kh[:, :, k0:k0 + bs], vh[:, :, k0:k0 + bs]
            p = torch.exp2(mm(qh, kt.transpose(-1, -2), passes) * c - l2)
            ds = p * (mm(doh, vt.transpose(-1, -2), passes) - dl)
            dq += mm(ds, kt, passes)
        return _packed(dq * scale)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    end = n - n % bs if fault == "kv_tail" else n   # the ragged q stage
    for q0 in range(0, end, bs):
        qt, dot = qh[:, :, q0:q0 + bs], doh[:, :, q0:q0 + bs]
        p = torch.exp2(mm(qt, kh.transpose(-1, -2), passes) * c - l2[:, :, q0:q0 + bs])
        ds = p * (mm(dot, vh.transpose(-1, -2), passes) - dl[:, :, q0:q0 + bs])
        dv += mm(p.transpose(-1, -2), dot, passes)
        dk += mm(ds.transpose(-1, -2), qt, passes)
    return _packed(dk * scale), _packed(dv)


@pytest.mark.parametrize("d,kid,fault", [
    *((d, kid, f) for d in (40, 80) for kid in ("K5a", "K5b")
      for f in (None, "tf32_one_pass")),
    (80, "K5a", "kv_tail"), (80, "K5b", "kv_tail"), (40, "K5a", "kv_tail"),
])
def test_k5_f32_tolerance_separates_rounding_from_faults(d, kid, fault):
    # N = M = 1054 = 32 * 32 + 30: ragged last stages of 30 rows
    b, heads, n = 1, 2, 1054
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, n, heads * d, generator=g) for _ in range(3))
    dout = 0.1 * torch.randn(b, n, heads * d, generator=g)
    scale = d ** -0.5
    out, lse = flash_attention_lse_plain(q, k, v, heads, scale)
    delta = attention_delta(out, dout, heads)
    ref = flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, scale)
    ref = ref[0] if kid == "K5a" else ref[1:]
    got = agreement(tol_id(kid, F32), _k5_emulated(
        kid, q, k, v, dout, lse, delta, heads, scale, fault=fault), ref)
    assert got["ok"] == (fault is None), got


# ---------------------------------------------------------------------------
# K4


def _k4_f32_emulated(x, lw, lb, w1, b1, w2, b2, s, fault=None, eps=1e-5):
    """csrc/ffn.cu's f32 K4: LN(x) in f32 once per row (mean, then the
    centred variance), the up GEMM against Wa and Wg and the down GEMM in
    3xTF32 over 32-deep k steps, (a + ba) * gelu_erf(g + bg) kept in f32,
    then x + s (acc + b2)."""
    passes = 1 if fault == "tf32_one_pass" else 3
    m, inner = x.shape[0], w1.shape[0] // 2
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    xn = (x - mean) * rstd * lw + lb

    def gemm(a, w):
        kd = a.shape[1]
        end = kd - kd % 32 if fault == "k_tail" else kd
        acc = torch.zeros(a.shape[0], w.shape[0])
        for k0 in range(0, end, 32):
            acc += mm(a[:, k0:k0 + 32], w[:, k0:k0 + 32].t(), passes)
        return acc

    a = gemm(xn, w1[:inner]) + b1[:inner]
    gate = gemm(xn, w1[inner:]) + b1[inner:]
    h = a * torch.nn.functional.gelu(gate)
    y = gemm(h, w2) + b2
    if fault == "s_after_residual":
        return (y + x) * s
    out = x + y * s
    if fault == "rows_tail":   # the last, ragged 128-row block unwritten
        out[m - m % 128:] = 0
    return out


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


def test_f32_rows_bound_the_whole_tensor_under_one_tf32_pass():
    # r no looser than 1e-4; the element-wise bounds are the kernels' own
    for kid in ("K1", "K4", "K5a", "K5b"):
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
