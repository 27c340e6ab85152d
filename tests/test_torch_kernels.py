"""The port's plain kernel versions against the Pallas kernels they replace.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own kernel tests run them; the port's wrappers take their plain PyTorch
versions for CPU tensors. Both sides see the same f32 inputs from a numpy
seed. Tolerance: 1e-5 absolute (f32, differing only in summation order),
2e-5 where a contraction over 512 features adds rounding.

The last two tests hold K1's and K5's stated bf16 tolerances on the card
(``kernels/tolerance.py``) against CPU emulations of the CUDA kernels'
algorithms: the kernels' own rounding must pass them, small faults must
not.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas.ffn import _ffn_ln_call
from layoutllm_t2i_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from layoutllm_t2i_tpu.ops.pallas.norms import _gn_pallas, _gn_pallas_rows, _ln_pallas

from layoutllm_t2i_torch.kernels import (
    attention_delta, ffn_ln_geglu, flash_attention, flash_attention_bwd_plain,
    flash_attention_lse_plain, flash_attention_plain, group_norm, layer_norm,
)
from layoutllm_t2i_torch.kernels.tolerance import agreement

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("heads,n,m,d", [
    (2, 600, 630, 40),    # 64^2 head dim, ragged q and kv tails
    (2, 600, 630, 80),    # 32^2 head dim
    (1, 520, 600, 512),   # VAE mid attention: one head of 512
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
    np.testing.assert_allclose(out, ref, atol=2e-5 if d == 512 else ATOL)


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
    """csrc/flash_attention.cu's algorithm in f32 on the CPU: K/V in BK-row
    tiles, online softmax, exp'd scores cast to bf16 before P V, bf16
    output; ``fault`` injects a mistake the kernel could make."""
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


def _flash_bwd_emulated(kid, q, k, v, dout, lse, delta, heads, scale,
                        fault=None, bq=64, bk=64):
    """csrc/flash_attention.cu's K5a (dQ) or K5b (dK, dV) algorithm in f32
    on the CPU: K5a streams K/V in BK-row tiles, K5b streams q/dO in
    BQ-row tiles; P = exp(S * scale - lse), dS = P o (dO V^T - delta), both
    cast to bf16 before their products; outputs in bf16. ``fault`` injects
    a mistake the kernels could make."""
    b, n, hc = q.shape
    m, d = k.shape[1], hc // heads
    split = lambda t: t.float().view(b, -1, heads, d).transpose(1, 2)
    qh, kh, vh, doh = split(q), split(k), split(v), split(dout)
    lse, delta = lse[..., None], delta[..., None]
    s_p = scale * 1.005 if fault == "scale" else scale    # 0.5 % logit scale
    out_mul = 1.0 if fault == "out_scale" else scale      # dropped final scale
    bf = lambda t: t.to(torch.bfloat16).float()
    if kid == "K5a":
        dq = torch.zeros(b, heads, n, d)
        end = m - m % bk if fault == "kv_tail" else m
        for k0 in range(0, end, bk):
            kt, vt = kh[:, :, k0:k0 + bk], vh[:, :, k0:k0 + bk]
            p = torch.exp(qh @ kt.transpose(-1, -2) * s_p - lse)
            dq += bf(p * (doh @ vt.transpose(-1, -2) - delta)) @ kt
        dq = dq * out_mul * (1.005 if fault == "skew" else 1.0)
        return dq.transpose(1, 2).reshape(b, n, hc).to(torch.bfloat16)
    if fault == "q_tail":
        # the last q tile reads past N: the rows that follow in memory (the
        # next batch element's first rows, the next (b, h) row's lse/delta)
        pad = bq - n % bq
        nxt = lambda t: torch.cat([t, t.roll(-1, 0)[:, :, :pad]], dim=2)
        qh, doh = nxt(qh), nxt(doh)
        flat = lambda t: torch.cat(
            [t, t.reshape(b * heads, n, 1).roll(-1, 0)[:, :pad]
             .reshape(b, heads, pad, 1)], dim=2)
        lse, delta = flat(lse), flat(delta)
    dk = torch.zeros(b, heads, m, d)
    dv = torch.zeros(b, heads, m, d)
    for q0 in range(0, qh.shape[2], bq):
        qt, dot = qh[:, :, q0:q0 + bq], doh[:, :, q0:q0 + bq]
        lt, dt = lse[:, :, q0:q0 + bq], delta[:, :, q0:q0 + bq]
        p = torch.exp(qt @ kh.transpose(-1, -2) * s_p - lt)
        ds = bf(p * (dot @ vh.transpose(-1, -2) - dt))
        dv += bf(p).transpose(-1, -2) @ dot
        dk += ds.transpose(-1, -2) @ qt
    dk = dk * out_mul * (1.005 if fault == "skew" else 1.0)
    if fault == "kv_tail":   # the last, ragged k tile is never written
        dk[:, :, m - m % bk:] = 0
        dv[:, :, m - m % bk:] = 0
    packed = lambda t: t.transpose(1, 2).reshape(b, m, hc).to(torch.bfloat16)
    return packed(dk), packed(dv)


@pytest.mark.parametrize("kid,fault", [
    ("K5a", None), ("K5a", "kv_tail"), ("K5a", "scale"), ("K5a", "out_scale"),
    ("K5a", "skew"),
    ("K5b", None), ("K5b", "kv_tail"), ("K5b", "q_tail"), ("K5b", "scale"),
    ("K5b", "out_scale"), ("K5b", "skew"),
])
def test_k5_tolerance_separates_rounding_from_faults(kid, fault):
    # the 32^2 gated sites at two batch elements: N = M = 1054 = 16 * 64 + 30
    # leaves ragged q and KV tails of 30 rows; "scale" is a 0.5 % error of
    # the softmax scale, "out_scale" drops the final scale of dQ or dK,
    # "skew" is a 0.5 % error of dQ or dK, "q_tail" reads past N
    b, heads, n, d = 2, 2, 1054, 80
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, n, heads * d, generator=g).to(torch.bfloat16)
               for _ in range(3))
    dout = (0.1 * torch.randn(b, n, heads * d, generator=g)).to(torch.bfloat16)
    scale = d ** -0.5
    out, lse = flash_attention_lse_plain(q, k, v, heads, scale)
    delta = attention_delta(out, dout, heads)
    ref = flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, scale)
    ref = ref[0] if kid == "K5a" else ref[1:]
    got = agreement(kid, _flash_bwd_emulated(kid, q, k, v, dout, lse, delta,
                                             heads, scale, fault), ref)
    assert got["ok"] == (fault is None), got
