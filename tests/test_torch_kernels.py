"""The port's plain kernel versions against the Pallas kernels they replace.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own kernel tests run them; the port's wrappers take their plain PyTorch
versions for CPU tensors. Both sides see the same f32 inputs from a numpy
seed. Tolerance: 1e-5 absolute (f32, differing only in summation order),
2e-5 where a contraction over 512 features adds rounding.

The last seven tests hold K1's, K5's, K4's, K6's, K8a's and K8b's stated
bf16 tolerances on the card (``kernels/tolerance.py``) against CPU
emulations of the CUDA kernels' algorithms (K1 in its first, WMMA design
and in its wgmma design): the kernels' own rounding must pass them, small
faults must not.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas.ffn import _ffn_ln_call
from layoutllm_t2i_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from layoutllm_t2i_tpu.ops.pallas.norms import _gn_pallas, _gn_pallas_rows, _ln_pallas

from layoutllm_t2i_torch.kernels import (
    attention_delta, ffn_geglu_plain, ffn_ln_geglu, ffn_ln_geglu_plain,
    flash_attention, flash_attention_bwd_plain, flash_attention_lse_plain,
    flash_attention_plain, geglu_plain, group_norm, layer_norm, linear_plain,
)
from layoutllm_t2i_torch.kernels.tolerance import agreement
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-5
# the module (the package exports its function under the same name)
FA = importlib.import_module("layoutllm_t2i_torch.kernels.flash_attention")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("heads,n,m,d", [
    (2, 600, 630, 40),    # 64^2 head dim, ragged q and kv tails
    (2, 600, 630, 80),    # 32^2 head dim
    (1, 520, 600, 512),   # VAE mid attention: one head of 512
    (2, 600, 630, 20),    # 16 heads at 320 channels (the padded copy's d)
    (2, 600, 630, 64),    # num_heads 5 at the 64^2 sites
    (2, 600, 630, 128),   # num_heads 5 at the 32^2 sites
    (2, 576, 606, 160),   # SD-1.4's 24^2 sites at 768^2
    (1, 520, 600, 256),   # num_heads 5's 24^2 sites at 768^2
])
def test_flash_attention_plain_matches_pallas(rng, heads, n, m, d):
    q = rng.standard_normal((1, heads, n, d), dtype=np.float32)
    k = rng.standard_normal((1, heads, m, d), dtype=np.float32)
    v = rng.standard_normal((1, heads, m, d), dtype=np.float32)
    scale = d ** -0.5
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale, 256, 512, True))
    packed = lambda a: _t(a.transpose(0, 2, 1, 3).reshape(1, a.shape[2], -1))
    out = flash_attention(packed(q), packed(k), packed(v), heads, scale)
    out = out.numpy().reshape(1, n, heads, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out, ref, atol=2e-5 if d >= 128 else ATOL)


@pytest.mark.parametrize("kid,dtype,d,width", [
    ("K1", torch.bfloat16, 20, 48), ("K1", torch.bfloat16, 40, 48),
    ("K1", torch.bfloat16, 56, 64), ("K1", torch.bfloat16, 64, 64),
    ("K1", torch.bfloat16, 72, 80), ("K1", torch.bfloat16, 96, 128),
    ("K1", torch.bfloat16, 144, 160), ("K1", torch.bfloat16, 160, 160),
    ("K1", torch.bfloat16, 168, 512), ("K1", torch.bfloat16, 256, 512),
    ("K1", torch.bfloat16, 512, 512), ("K1", torch.float32, 20, 40),
    ("K1", torch.float32, 44, 64), ("K1", torch.float32, 96, 128),
    ("K1", torch.float32, 161, 512), ("K5a", torch.bfloat16, 20, 48),
    ("K5a", torch.bfloat16, 144, 160), ("K5b", torch.bfloat16, 96, 128),
    ("K5b", torch.float32, 20, 40), ("K5a", torch.float32, 64, 64),
    ("K5b", torch.float32, 157, 160), ("K5a", torch.bfloat16, 168, 256),
    ("K5b", torch.bfloat16, 256, 256), ("K5a", torch.bfloat16, 300, 320),
    ("K5b", torch.bfloat16, 320, 320), ("K5b", torch.float32, 168, 256),
    ("K5a", torch.float32, 256, 256), ("K5b", torch.float32, 300, 320),
    ("K5a", torch.float32, 320, 320),
    # K1 past 512: the column-group kernels, each d at its own width
    ("K1", torch.bfloat16, 520, 520), ("K1", torch.bfloat16, 636, 640),
    ("K1", torch.bfloat16, 1280, 1280), ("K1", torch.float32, 520, 520),
    ("K1", torch.float32, 638, 640), ("K1", torch.float32, 1280, 1280),
])
def test_kernel_width_is_the_smallest_that_holds_d(kid, dtype, d, width):
    # the instantiation a head dim runs on, after the padding copy to whole
    # 16-byte vectors (d 20 -> 24 in bf16; 157 -> 160 in f32; 300 -> 304
    # and 636 -> 640 in bf16)
    assert FA.kernel_width(kid, dtype, d) == width
    assert FA.padded_head_dim(d, dtype) <= width


def test_kernel_widths_are_the_c_entry_points():
    # the widths the C entry points switch on (csrc/flash_attention.cu):
    # bf16 K1 and K5 by `D <= w`, each past the last on the column-group
    # kernels, the f32 forms through f32_width (K1/f32 past 160 on its
    # 512-wide kernel, past 512 on its column groups) and K5's through
    # bwd_f32_width, which adds the d-streamed 256 and 320, then D itself
    src = (Path(FA.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()

    def body_of(start):
        body = src[src.index(start):]
        return body[:body.index("\n}\n")]

    def widths(start):
        return tuple(int(w) for w in re.findall(r"D <= (\d+)", body_of(start))
                     if int(w))

    assert widths("LLT2I_API int llt2i_flash_fwd(") == FA.K1_WIDTHS[torch.bfloat16]
    assert ": launch_wide;" in body_of("LLT2I_API int llt2i_flash_fwd(")
    f32_fwd = body_of("LLT2I_API int llt2i_flash_fwd_f32(")
    assert "D > 512) return run(launch_fwd_f32_wide)" in f32_fwd
    assert "D > 512" not in f32_fwd.split("switch")[0]
    assert FA.kernel_width("K1", torch.float32, 516) == 516
    assert widths("int flash_bwd(const void* q") == FA.K5_WIDTHS[torch.bfloat16]
    assert "launch_bwd_wide<DqWide>" in body_of("int flash_bwd(const void* q")
    assert "D <= 320 ? 320 : D;" in body_of("int bwd_f32_width(int D)")
    assert "launch_bwd_f32<DqSW>" in body_of("int flash_bwd_f32(const void* q")
    assert FA.kernel_width("K5b", torch.float32, 324) == 324
    assert widths("int f32_width(int D)") == FA.K1_WIDTHS[torch.float32][:-1]
    assert widths("int f32_width(int D)") + widths("int bwd_f32_width(int D)") \
        == FA.K5_WIDTHS[torch.float32] == (40, 64, 80, 128, 160, 256, 320)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 20), (torch.float32, 22),
                                     (torch.bfloat16, 100)])
def test_padded_copy_computes_the_true_head_dim(dtype, d):
    # the wrapper's path for a d that is not whole 16-byte vectors: q, k, v
    # (and dO) zero-padded per head, the scale of the true d, each head's
    # first d columns of the outputs. The zero columns add nothing to the
    # scores, and their outputs are dropped: the f32 plain versions on the
    # copies equal them on the operands, forward and backward
    heads, n, m = 3, 40, 56
    dp = FA.padded_head_dim(d, dtype)
    assert dp > d and dp % (8 if dtype is torch.bfloat16 else 4) == 0
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(2, r, heads * d, generator=g)
                     for r in (n, m, m, n))
    scale = d ** -0.5
    pad = lambda t: FA.pad_heads(t, heads, dp)
    assert torch.equal(FA.unpad_heads(pad(q), heads, d), q)
    out, lse = flash_attention_lse_plain(q, k, v, heads, scale)
    out_p, lse_p = flash_attention_lse_plain(pad(q), pad(k), pad(v), heads, scale)
    torch.testing.assert_close(FA.unpad_heads(out_p, heads, d), out,
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(lse_p, lse, rtol=0, atol=1e-6)
    assert not FA.unpad_heads(out_p, heads, d).equal(out_p[..., :heads * d])
    delta = attention_delta(out, dout, heads)
    ref = flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, scale)
    got = flash_attention_bwd_plain(pad(q), pad(k), pad(v), pad(dout), lse,
                                    delta, heads, scale)
    for a, b in zip(got, ref):
        torch.testing.assert_close(FA.unpad_heads(a, heads, d), b, rtol=0,
                                   atol=1e-6)


def _gn_inputs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32) * 2.0 + 0.5
    gamma = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    return x, gamma, beta


def _port_gn(x, gamma, beta, eps, silu):
    n, h, w, c = x.shape
    out = group_norm(_t(x.reshape(n, h * w, c)), _t(gamma), _t(beta), 32,
                     eps, silu)
    return out.numpy().reshape(x.shape)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("shape,k", [((2, 8, 8, 128), 1), ((1, 16, 16, 256), 2)])
def test_group_norm_plain_matches_pallas(rng, shape, k, eps, silu):
    x, gamma, beta = _gn_inputs(rng, shape)
    ref = np.asarray(_gn_pallas(jnp.asarray(x), jnp.asarray(gamma),
                                jnp.asarray(beta), 32, eps, silu,
                                interpret=True, k=k))
    np.testing.assert_allclose(_port_gn(x, gamma, beta, eps, silu), ref,
                               atol=ATOL)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_plain_matches_pallas_rows(rng, eps, silu):
    x, gamma, beta = _gn_inputs(rng, (2, 16, 16, 128))
    ref = np.asarray(_gn_pallas_rows(jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta), 32, eps, silu,
                                     interpret=True, rb=64))
    np.testing.assert_allclose(_port_gn(x, gamma, beta, eps, silu), ref,
                               atol=ATOL)


@pytest.mark.parametrize("rows,c", [(64, 320), (256, 640), (8, 768)])
def test_layer_norm_plain_matches_pallas(rng, rows, c):
    x = rng.standard_normal((rows, c)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    ref = np.asarray(_ln_pallas(jnp.asarray(x), jnp.asarray(gamma),
                                jnp.asarray(beta), 1e-5, interpret=True))
    out = layer_norm(_t(x), _t(gamma), _t(beta), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("s", [1.0, 0.37])
def test_ffn_plain_matches_pallas(rng, s):
    m, k, inner = 256, 64, 256
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f(m, k)
    wa, wg, w2 = f(k, inner) * 0.1, f(k, inner) * 0.1, f(inner, k) * 0.1
    ba, bg, b2 = f(inner) * 0.1, f(inner) * 0.1, f(k) * 0.1
    gamma = rng.uniform(0.5, 1.5, k).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, k).astype(np.float32)
    ref = np.asarray(_ffn_ln_call(
        *(jnp.asarray(a) for a in (x, wa, wg, ba, bg, w2, b2, gamma, beta)),
        s, 1e-5, interpret=True))
    # the port keeps the torch layouts: w1 = [Wa; Wg] as (2*inner, K)
    w1 = np.concatenate([wa, wg], axis=1).T
    b1 = np.concatenate([ba, bg])
    out = ffn_ln_geglu(_t(x), _t(gamma), _t(beta), _t(w1), _t(b1), _t(w2.T),
                       _t(b2), torch.tensor(s)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def _flash_emulated(q, k, v, heads, scale, fault=None, bk=64):
    """K1's first (WMMA) design in f32 on the CPU: K/V in BK-row tiles,
    online softmax on the scaled scores with exp, exp'd scores cast to bf16
    before P V, bf16 output; ``fault`` injects a mistake the kernel could
    make."""
    b, n, hc = q.shape
    m, d = k.shape[1], hc // heads
    split = lambda t: t.float().view(b, -1, heads, d).transpose(1, 2)
    qh, kh, vh = split(q), split(k), split(v)
    if fault == "scale":
        scale *= 1.005
    m_run = torch.full((b, heads, n, 1), -1e30)
    den = torch.zeros(b, heads, n, 1)
    acc = torch.zeros(b, heads, n, d)
    end = m - m % bk if fault == "kv_tail" else m
    for k0 in range(0, end, bk):
        k1 = min(k0 + bk, end)
        s = qh @ kh[:, :, k0:k1].transpose(-1, -2) * scale
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_run - m_new)
        den = (den if fault == "rescale" else den * alpha) + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vh[:, :, k0:k1]
        m_run = m_new
    out = (acc / den).transpose(1, 2).reshape(b, n, hc)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("fault", [None, "kv_tail", "rescale", "scale"])
def test_k1_tolerance_separates_rounding_from_faults(fault):
    # the 32^2 gated sites' shape at one batch: M = 1054 = 16 * 64 + 30
    # leaves a ragged KV tail of 30 rows; "scale" is a 0.5 % scale error
    heads, n, d = 2, 1054, 80
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, n, heads * d, generator=g).to(torch.bfloat16)
               for _ in range(3))
    ref = flash_attention_plain(q, k, v, heads, d ** -0.5)
    got = agreement("K1", _flash_emulated(q, k, v, heads, d ** -0.5, fault), ref)
    assert got["ok"] == (fault is None), got


def _flash_wgmma_emulated(q, k, v, heads, scale, fault=None, bk=128, width=48):
    """The wgmma design of csrc/flash_attention.cu in f32 on the CPU: K/V in
    BK-row tiles zero-filled past M (TMA), the ragged tail masked to -inf,
    the row max over the raw scores, p = exp2(s c - m c) with c =
    scale log2(e) rounded to f32 as the host rounds it, row sums of the f32
    p, P cast to bf16 before P V, O times the f32 reciprocal of the sum,
    bf16 output; lse = m scale + ln(sum). Returns (out, lse). ``fault``
    injects a mistake the kernel could make."""
    b, n, hc = q.shape
    m, d = k.shape[1], hc // heads
    split = lambda t: t.float().view(b, -1, heads, d).transpose(1, 2)
    qh, kh, vh = split(q), split(k), split(v)
    qs = qh
    if fault == "pad_neighbour":
        # the pad columns of the instantiation's ``width`` (8 at d = 40)
        # read from the next head, not zeros
        nb = lambda t: torch.cat([t, t.roll(-1, 1)[..., :width - d]], dim=-1)
        qs, kh = nb(qh), nb(kh)
    elif fault == "drop_chunk":
        # the width's last 64-column chunk of Q K^T dropped
        qs = qh.clone()
        qs[..., 64 * ((width - 1) // 64):] = 0
    pad = -m % bk
    kh = torch.cat([kh, torch.zeros(b, heads, pad, kh.shape[-1])], dim=2)
    vh = torch.cat([vh, torch.zeros(b, heads, pad, d)], dim=2)
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    if fault == "scale":
        c = c * 1.005
    m_run = torch.full((b, heads, n, 1), -torch.inf)
    den = torch.zeros(b, heads, n, 1)
    acc = torch.zeros(b, heads, n, d)
    end = m - m % bk if fault == "kv_tail" else m
    for k0 in range(0, end, bk):
        s = qs @ kh[:, :, k0:k0 + bk].transpose(-1, -2)
        if fault != "mask_zero":   # zero-filled rows would score 0
            s[..., max(0, m - k0):] = -torch.inf
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        p = torch.exp2(s * c - m_new * c)
        alpha = torch.exp2((m_run - m_new) * c)
        den = (den if fault == "rescale" else den * alpha) + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vh[:, :, k0:k0 + bk]
        m_run = m_new
    out = (acc * (1.0 / den)).transpose(1, 2).reshape(b, n, hc)
    lse = (m_run * scale + torch.log(den))[..., 0]
    if fault == "lse_log2":     # left in the exponent's base-2 units
        lse = (m_run * c + torch.log2(den))[..., 0]
    return out.to(torch.bfloat16), lse


# csrc/flash_attention.cu's bf16 K1 instantiation of each head dim: its
# width and its K/V rows a stage (Fwd40, Fwd64, Fwd80, Fwd128, Fwd160,
# Fwd512; d 144 runs Fwd160 with 16 zero columns)
K1_TILES = {40: (48, 64), 64: (64, 64), 80: (80, 128), 128: (128, 64),
            144: (160, 64), 160: (160, 64), 512: (512, 32)}


@pytest.mark.parametrize("d,fault", [
    (80, None), (80, "kv_tail"), (80, "rescale"), (80, "scale"),
    (80, "mask_zero"), (80, "lse_log2"),
    (40, None), (40, "mask_zero"), (40, "pad_neighbour"),
    (512, None), (512, "kv_tail"), (512, "scale"),
    (64, None), (64, "kv_tail"), (64, "mask_zero"),
    (128, None), (128, "kv_tail"), (128, "drop_chunk"),
    (160, None), (160, "kv_tail"), (160, "drop_chunk"), (160, "scale"),
    (144, None), (144, "pad_neighbour"), (144, "drop_chunk"),
])
def test_k1_wgmma_tolerance_separates_rounding_from_faults(d, fault):
    # K1's tolerance, unchanged, against the rounding of the wgmma design,
    # at each head dim's K/V tile (K1_TILES): M = 1054 = 16 * 64 + 30
    # (BK = 64), 8 * 128 + 30 (d 80; BK = 128) and 32 * 32 + 30 (d 512; BK
    # = 32) leaves the last tile ragged. "mask_zero" lets the zero-filled
    # rows past M score 0 instead of -inf, "pad_neighbour" reads the next
    # head's columns as the pad of d's width (8 at d = 40, 16 at d = 144),
    # "drop_chunk" drops the width's last 64-column chunk from the scores,
    # "lse_log2" leaves the lse in base-2 units; the others as for the
    # first design.
    heads = 1 if d == 512 else 2
    n = 600 if d == 512 else 1054
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, n, heads * d, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(1, 1054, heads * d, generator=g).to(torch.bfloat16)
            for _ in range(2))
    scale = d ** -0.5
    ref = flash_attention_lse_plain(q, k, v, heads, scale)
    width, bk = K1_TILES[d]
    got = agreement(("K1", "lse"), _flash_wgmma_emulated(
        q, k, v, heads, scale, fault, bk=bk, width=width), ref)
    assert got["ok"] == (fault is None), got


def _flash_bwd_emulated(kid, q, k, v, dout, lse, delta, heads, scale,
                        fault=None, bq=64, bk=64, width=48):
    """csrc/flash_attention.cu's K5a (dQ) or K5b (dK, dV) algorithm in f32
    on the CPU: K5a streams K/V in BK-row tiles, K5b streams q/dO in
    BQ-row tiles (csrc Dq40, Dkv40, Dq80, Dkv80: 64 rows a stage at d 40
    and 80);
    P = exp2(S c - lse log2 e) on the raw scores S, with c = scale log2(e)
    rounded to f32 as the host rounds it and the lse times log2(e) in f32
    as the kernels take it; dS = P o (dO V^T - delta); P and dS cast to
    bf16 before their products; outputs in bf16. ``fault`` injects a
    mistake the kernels could make (``width``: the instantiation's, whose
    pad columns "pad_neighbour" writes and whose last 64-column chunk
    "drop_chunk" drops from the scores)."""
    b, n, hc = q.shape
    m, d = k.shape[1], hc // heads
    split = lambda t: t.float().view(b, -1, heads, d).transpose(1, 2)
    qh, kh, vh, doh = split(q), split(k), split(v), split(dout)
    qs, ds_ = qh, doh      # the operands of the scores S and dP
    if fault == "drop_chunk":
        qs, ds_ = qh.clone(), doh.clone()
        qs[..., 64 * ((width - 1) // 64):] = 0
        ds_[..., 64 * ((width - 1) // 64):] = 0
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    c = torch.tensor(scale, dtype=torch.float32) * log2e
    if fault == "scale":                                  # 0.5 % logit scale
        c = c * 1.005
    # the lse as the exponent takes it; "lse_log2" skips the change of base
    l2 = lse[..., None] if fault == "lse_log2" else lse[..., None] * log2e
    delta = delta[..., None]
    out_mul = 1.0 if fault == "out_scale" else scale      # dropped final scale
    bf = lambda t: t.to(torch.bfloat16).float()

    def packed(t, rows):
        t = t.transpose(1, 2).reshape(b, rows, hc).to(torch.bfloat16)
        if fault == "pad_neighbour":
            # d's width-column tile written whole: its pad columns (zero: Q
            # and K read zeros past d) over the next head's first ones (8
            # at d = 40)
            flat = t.reshape(-1, d)
            flat[1:, :width - d] = 0
        return t

    if kid == "K5a":
        dq = torch.zeros(b, heads, n, d)
        end = m - m % bk if fault == "kv_tail" else m
        for k0 in range(0, end, bk):
            kt, vt = kh[:, :, k0:k0 + bk], vh[:, :, k0:k0 + bk]
            p = torch.exp2(qs @ kt.transpose(-1, -2) * c - l2)
            dq += bf(p * (ds_ @ vt.transpose(-1, -2) - delta)) @ kt
        dq = dq * out_mul * (1.005 if fault == "skew" else 1.0)
        return packed(dq, n)
    if fault == "q_tail":
        # the last q tile reads past N: the rows that follow in memory (the
        # next batch element's first rows, the next (b, h) row's lse/delta)
        pad = bq - n % bq
        nxt = lambda t: torch.cat([t, t.roll(-1, 0)[:, :, :pad]], dim=2)
        qh, doh, qs, ds_ = nxt(qh), nxt(doh), nxt(qs), nxt(ds_)
        flat = lambda t: torch.cat(
            [t, t.reshape(b * heads, n, 1).roll(-1, 0)[:, :pad]
             .reshape(b, heads, pad, 1)], dim=2)
        l2, delta = flat(l2), flat(delta)
    dk = torch.zeros(b, heads, m, d)
    dv = torch.zeros(b, heads, m, d)
    for q0 in range(0, qh.shape[2], bq):
        qt, dot = qh[:, :, q0:q0 + bq], doh[:, :, q0:q0 + bq]
        lt, dt = l2[:, :, q0:q0 + bq], delta[:, :, q0:q0 + bq]
        p = torch.exp2(qs[:, :, q0:q0 + bq] @ kh.transpose(-1, -2) * c - lt)
        ds = bf(p * (ds_[:, :, q0:q0 + bq] @ vh.transpose(-1, -2) - dt))
        dv += bf(p).transpose(-1, -2) @ dot
        dk += ds.transpose(-1, -2) @ qt
    dk = dk * out_mul * (1.005 if fault == "skew" else 1.0)
    if fault == "kv_tail":   # the last, ragged k tile is never written
        dk[:, :, m - m % bk:] = 0
        dv[:, :, m - m % bk:] = 0
    return packed(dk, m), packed(dv, m)


# csrc/flash_attention.cu's bf16 K5 instantiations past d 80: K5b's q rows
# a stage, each kernel's K/V rows (K5a: a stage, K5b: the block's resident
# rows), the width (Dq64/Dkv64, Dq128/Dkv128, Dq160/Dkv160; Dq256 and
# Dv256/Dk256, Dq320 and Dv320/Dk320, K5b's two passes the same products in
# the same order as one; d 168 on the 256 width, 300 on the 320)
K5_TILES = {**{("K5a", d): (64, 64, w) for d, w in ((64, 64), (128, 128),
                                                    (144, 160), (160, 160))},
            ("K5b", 64): (64, 128, 64), ("K5b", 128): (32, 128, 128),
            ("K5b", 144): (16, 128, 160), ("K5b", 160): (16, 128, 160),
            **{("K5a", d): (64, bk, w) for d, bk, w in (
                (168, 32, 256), (256, 32, 256), (300, 16, 320), (320, 16, 320))},
            **{("K5b", d): (bq, 128, w) for d, bq, w in (
                (168, 32, 256), (256, 32, 256), (300, 16, 320), (320, 16, 320))}}

_K5_FAULTS = {"K5a": (None, "kv_tail", "scale", "out_scale", "skew"),
              "K5b": (None, "kv_tail", "q_tail", "scale", "out_scale", "skew")}


@pytest.mark.parametrize("d,kid,fault", [
    # d 80: the first cases, under their first ids
    *(pytest.param(80, kid, fault, id=f"{kid}-{fault}")
      for kid, faults in _K5_FAULTS.items() for fault in faults),
    *(pytest.param(80, kid, "lse_log2", id=f"d80-{kid}-lse_log2")
      for kid in _K5_FAULTS),
    *(pytest.param(40, kid, fault, id=f"d40-{kid}-{fault}")
      for kid, faults in _K5_FAULTS.items()
      for fault in faults + ("pad_neighbour", "lse_log2")),
    # the widths past 80: each kernel's stages (K5_TILES), a dropped
    # ragged tail, the width's last 64-column chunk dropped from the scores
    # (not at d 64, a single chunk), K5b's q tail; d 144 on the 160 width
    *(pytest.param(d, kid, fault, id=f"d{d}-{kid}-{fault}")
      for d in (64, 128, 160) for kid in _K5_FAULTS
      for fault in (None, "kv_tail") + (("drop_chunk",) if d > 64 else ())
      + (("q_tail",) if kid == "K5b" else ())),
    *(pytest.param(144, kid, fault, id=f"d144-{kid}-{fault}")
      for kid in _K5_FAULTS for fault in (None, "pad_neighbour", "drop_chunk")),
    # the widths 256 and 320, and d 168 and 300 inside them (300 runs at
    # 304, the padded copy's d): a dropped ragged tail, the width's last
    # 64-column chunk dropped from the scores, K5b's q tail, the pad
    # columns written over the next head
    *(pytest.param(d, kid, fault, id=f"d{d}-{kid}-{fault}")
      for d in (256, 320) for kid in _K5_FAULTS
      for fault in (None, "kv_tail", "drop_chunk")
      + (("q_tail",) if kid == "K5b" else ())),
    *(pytest.param(d, kid, fault, id=f"d{d}-{kid}-{fault}")
      for d in (168, 300) for kid in _K5_FAULTS
      for fault in (None, "pad_neighbour") + (("drop_chunk",) if d == 300 else ())),
])
def test_k5_tolerance_separates_rounding_from_faults(d, kid, fault):
    # the 32^2 gated sites at two batch elements, and the 64^2 sites' head
    # dim at the same length: N = M = 1054 = 16 * 64 + 30 leaves ragged q
    # and KV tails of 30 rows; "scale" is a 0.5 % error of the softmax
    # scale, "out_scale" drops the final scale of dQ or dK, "skew" is a
    # 0.5 % error of dQ or dK, "q_tail" reads past N, "pad_neighbour"
    # writes d = 40's padded tile over the next head, "lse_log2" takes the
    # natural-log lse as if it were in base 2
    b, heads, n = 2, 2, 1054
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, n, heads * d, generator=g).to(torch.bfloat16)
               for _ in range(3))
    dout = (0.1 * torch.randn(b, n, heads * d, generator=g)).to(torch.bfloat16)
    scale = d ** -0.5
    out, lse = flash_attention_lse_plain(q, k, v, heads, scale)
    delta = attention_delta(out, dout, heads)
    ref = flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, scale)
    ref = ref[0] if kid == "K5a" else ref[1:]
    bq, bk, width = K5_TILES.get((kid, d), (64, 64, 48))
    got = agreement(kid, _flash_bwd_emulated(kid, q, k, v, dout, lse, delta,
                                             heads, scale, fault, bq, bk,
                                             width), ref)
    assert got["ok"] == (fault is None), got


# ---------------------------------------------------------------------------
# K4, K6, K8a and K8b on gemm_tiles.cuh's wgmma mainloop

_BF = torch.bfloat16


def _gemm_emulated(a, b, drop_k_tail=False):
    """a b^T as csrc/gemm_tiles.cuh sums it: f32 over 64-deep chunks of the
    contraction (one TMA stage each), the last one zero-filled past K;
    ``drop_k_tail`` drops that ragged last chunk."""
    k = a.shape[1]
    end = k - k % 64 if drop_k_tail else k
    acc = torch.zeros(a.shape[0], b.shape[0])
    for k0 in range(0, end, 64):
        acc += a[:, k0:k0 + 64].float() @ b[:, k0:k0 + 64].float().t()
    return acc


def _unwritten_tail(out, m):
    """The last ragged 128-row block of the output left unwritten (zero)."""
    out[m - m % 128:] = 0
    return out


def _k4_emulated(x, lw, lb, w1, b1, w2, b2, s, fault=None, eps=1e-5):
    """csrc/ffn.cu's K4: bf16(LN(x)) once per row (mean, then the centred
    variance, in f32), the up GEMM against Wa and Wg with (a + ba) *
    gelu_erf(g + bg) in f32 rounded once to bf16 h, the down GEMM with
    bf16((acc + b2) * s) + x. ``fault`` plants a mistake the kernels could
    make."""
    m, inner = x.shape[0], w1.shape[0] // 2
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    if fault == "ln_no_rstd":
        rstd = torch.ones_like(rstd)
    xn = ((xf - mean) * rstd * lw.float() + lb.float()).to(_BF)
    wa, wg = (w1[inner:], w1[:inner]) if fault == "swap_wa_wg" else (w1[:inner], w1[inner:])
    tail = fault == "k_tail"
    ba, bg = b1[:inner].float(), b1[inner:].float()
    a = _gemm_emulated(xn, wa, tail) + ba * (2 if fault == "bias_twice" else 1)
    g = _gemm_emulated(xn, wg, tail) + bg * (2 if fault == "bias_twice" else 1)
    h = a * torch.nn.functional.gelu(g)
    if fault != "h_unrounded":
        h = h.to(_BF)
    y = _gemm_emulated(h, w2, tail)
    if fault != "bias_dropped":
        y = y + b2.float()
    if fault == "s_after_residual":
        out = ((y.to(_BF).float() + xf) * s).to(_BF)
    else:
        out = ((y * s).to(_BF).float() + xf).to(_BF)
    return _unwritten_tail(out, m) if fault == "rows_tail" else out


def _k4_inputs(m, k, inner, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape, scale=1.0, shift=0.0: (
        torch.randn(*shape, generator=g) * scale + shift).to(_BF)
    # activations off unit variance, as a LayerNorm sees them
    return (rnd(m, k, scale=2.0, shift=0.5), rnd(k, scale=0.2, shift=1.0),
            rnd(k, scale=0.2), rnd(2 * inner, k, scale=k ** -0.5),
            rnd(2 * inner, scale=0.1), rnd(k, inner, scale=inner ** -0.5),
            rnd(k, scale=0.1))


# K4's faults the tolerance must catch, and those it cannot see: h left in
# f32 is one bf16 rounding of an intermediate, within the rounding the
# tolerance allows. ("s_after_residual" is caught at s = 0.5, the fusers'
# gate, and is no fault at s = 1, the norm3 sites.)
K4_CAUGHT = ("k_tail", "rows_tail", "swap_wa_wg", "bias_dropped",
             "bias_twice", "s_after_residual", "ln_no_rstd")
K4_UNSEEN = ("h_unrounded",)


@pytest.mark.parametrize("k,s,fault", [
    # the three widths of the UNet's LN + FF sites (inner 4K), at s = 1 (the
    # norm3 sites) and 0.5 (a fuser's gate)
    *(pytest.param(k, s, None, id=f"K{k}-s{s:g}")
      for k in (320, 640, 1280) for s in (1.0, 0.5)),
    # K = 72 (inner 288): both contractions end in a ragged 64-deep chunk
    pytest.param(72, 0.5, None, id="K72-s0.5"),
    pytest.param(72, 0.5, "k_tail", id="K72-k_tail"),
    *(pytest.param(320, 0.5, fault, id=f"K320-{fault}")
      for fault in K4_CAUGHT[1:] + K4_UNSEEN),
])
def test_k4_tolerance_separates_rounding_from_faults(k, s, fault):
    # M = 200 = 128 + 72 leaves a ragged last row block
    m, inner = 200, 4 * k
    args = _k4_inputs(m, k, inner)
    ref = ffn_ln_geglu_plain(*args, s)
    got = agreement("K4", _k4_emulated(*args, s, fault=fault), ref)
    assert got["ok"] == (fault is None or fault in K4_UNSEEN), got


def _k8a_emulated(x, w, b, r, fault=None):
    """csrc/matmul.cu's K8a: the mainloop's f32 sums, then bf16(acc + b + r)
    with bias and residual added in f32. ``fault`` plants a mistake."""
    y = _gemm_emulated(x, w, fault == "k_tail")
    if fault != "bias_dropped":
        y = y + b.float() * (2 if fault == "bias_twice" else 1)
    if fault == "round_before_residual":
        y = y.to(_BF).float()
    out = (y + r.float()).to(_BF)
    return _unwritten_tail(out, x.shape[0]) if fault == "rows_tail" else out


# a second rounding of the sum before the residual is one bf16 ulp, within
# the tolerance
K8A_CAUGHT = ("k_tail", "rows_tail", "bias_dropped", "bias_twice")
K8A_UNSEEN = ("round_before_residual",)


@pytest.mark.parametrize("k,n,fault", [
    # the three shapes of the split routes' down-projections (K = 4N)
    *(pytest.param(4 * n, n, None, id=f"K{4 * n}-N{n}") for n in (320, 640, 1280)),
    pytest.param(72, 200, None, id="K72-N200"),
    pytest.param(72, 200, "k_tail", id="K72-k_tail"),
    *(pytest.param(1280, 320, fault, id=f"K1280-{fault}")
      for fault in K8A_CAUGHT[1:] + K8A_UNSEEN),
])
def test_k8a_tolerance_separates_rounding_from_faults(k, n, fault):
    m = 200
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=g).to(_BF)
    w = (torch.randn(n, k, generator=g) * k ** -0.5).to(_BF)
    b = (torch.randn(n, generator=g) * 0.1).to(_BF)
    r = torch.randn(m, n, generator=g).to(_BF)
    got = agreement("K8a", _k8a_emulated(x, w, b, r, fault),
                    linear_plain(x, w, b, r))
    assert got["ok"] == (fault is None or fault in K8A_UNSEEN), got


def _geglu_emulated(x, w, b, fault=None):
    """The GEGLU GEMM of csrc/gemm_tiles.cuh (K8b, and K6's up kernel):
    a = x Wa^T and g = x Wg^T as the mainloop sums them, then (a + ba) *
    gelu_erf(g + bg) in f32 (Geglu), before any rounding; w = [Wa; Wg],
    b = [ba; bg] or None. ``fault`` plants a mistake."""
    n = w.shape[0] // 2
    wa, wg = (w[n:], w[:n]) if fault == "swap_wa_wg" else (w[:n], w[n:])
    tail = fault == "k_tail"
    a, g = _gemm_emulated(x, wa, tail), _gemm_emulated(x, wg, tail)
    if b is not None and fault != "bias_dropped":
        twice = 2 if fault == "bias_twice" else 1
        a = a + b[:n].float() * twice
        g = g + b[n:].float() * twice
    return a * torch.nn.functional.gelu(g)


def _k6_emulated(x, w1, b1, w2, b2, r, fault=None):
    """csrc/ffn.cu's K6: the up GEMM on x into bf16 h, the down GEMM with
    bf16(bf16(acc + b2) + r) (ScaledResidual at s = 1). ``fault`` plants a
    mistake: the up-kernel faults and "rows_tail" as K4's, "bias_dropped"
    drops b2, "bias_twice" adds b1 twice, "residual_scaled" halves r,
    "residual_unrounded" adds r before the FF output's rounding."""
    up_fault = {"bias_dropped": None}.get(fault, fault)
    h = _geglu_emulated(x, w1, b1, up_fault)
    if fault != "h_unrounded":
        h = h.to(_BF)
    y = _gemm_emulated(h, w2, fault == "k_tail")
    if fault != "bias_dropped":
        y = y + b2.float()
    rf = r.float() * (0.5 if fault == "residual_scaled" else 1)
    if fault == "residual_unrounded":
        out = (y + rf).to(_BF)
    else:
        out = (y.to(_BF).float() + rf).to(_BF)
    return _unwritten_tail(out, x.shape[0]) if fault == "rows_tail" else out


def _k6_inputs(m, k, inner, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g)
                                     * scale).to(_BF)
    return (rnd(m, k), rnd(2 * inner, k, scale=k ** -0.5),
            rnd(2 * inner, scale=0.1), rnd(k, inner, scale=inner ** -0.5),
            rnd(k, scale=0.1), rnd(m, k))


# K6's faults the tolerance must catch, and those it cannot see: h left in
# f32 and the residual added before the FF output's rounding are each one
# bf16 rounding of an intermediate, within the rounding the tolerance
# allows
K6_CAUGHT = ("k_tail", "rows_tail", "swap_wa_wg", "bias_dropped",
             "bias_twice", "residual_scaled")
K6_UNSEEN = ("h_unrounded", "residual_unrounded")


@pytest.mark.parametrize("k,fault", [
    # the three widths of the split routes' norm3 sites (inner 4K)
    *(pytest.param(k, None, id=f"K{k}") for k in (320, 640, 1280)),
    # K = 72 (inner 288): both contractions end in a ragged 64-deep chunk
    pytest.param(72, None, id="K72"),
    pytest.param(72, "k_tail", id="K72-k_tail"),
    *(pytest.param(320, fault, id=f"K320-{fault}")
      for fault in K6_CAUGHT[1:] + K6_UNSEEN),
])
def test_k6_tolerance_separates_rounding_from_faults(k, fault):
    # M = 200 = 128 + 72 leaves a ragged last row block
    m, inner = 200, 4 * k
    args = _k6_inputs(m, k, inner)
    got = agreement("K6", _k6_emulated(*args, fault=fault),
                    ffn_geglu_plain(*args))
    assert got["ok"] == (fault is None or fault in K6_UNSEEN), got


def _k8b_emulated(x, w, b, fault=None):
    """csrc/matmul.cu's K8b: the Geglu epilogue's f32 value rounded once to
    bf16. ``fault`` plants a mistake."""
    out = _geglu_emulated(x, w, b, fault).to(_BF)
    return _unwritten_tail(out, x.shape[0]) if fault == "rows_tail" else out


# every K8b fault planted is caught; with the bias absent, those that do
# not touch a bias
K8B_CAUGHT = ("k_tail", "rows_tail", "swap_wa_wg", "bias_dropped",
              "bias_twice")


@pytest.mark.parametrize("k,n,bias,fault", [
    # the three shapes of the split routes' up-projections (N = 4K)
    *(pytest.param(k, 4 * k, bias, None, id=f"K{k}-N{4 * k}-{tag}")
      for k in (320, 640, 1280) for bias, tag in ((True, "b"), (False, "nob"))),
    # K = 72, N = 200: a ragged 64-deep chunk and a partial 128-wide tile
    *(pytest.param(72, 200, bias, fault, id=f"K72-N200-{tag}-{fault}")
      for bias, tag in ((True, "b"), (False, "nob"))
      for fault in (None, "k_tail")),
    *(pytest.param(320, 1280, True, fault, id=f"K320-b-{fault}")
      for fault in K8B_CAUGHT[1:]),
    *(pytest.param(320, 1280, False, fault, id=f"K320-nob-{fault}")
      for fault in ("rows_tail", "swap_wa_wg")),
])
def test_k8b_tolerance_separates_rounding_from_faults(k, n, bias, fault):
    m = 200
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=g).to(_BF)
    w = (torch.randn(2 * n, k, generator=g) * k ** -0.5).to(_BF)
    b = (torch.randn(2 * n, generator=g) * 0.1).to(_BF) if bias else None
    got = agreement("K8b", _k8b_emulated(x, w, b, fault), geglu_plain(x, w, b))
    assert got["ok"] == (fault is None), got
