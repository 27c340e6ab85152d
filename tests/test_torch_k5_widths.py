"""K5a/K5b at head dims 168-320 on the CPU.

The Pallas backward kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) take
any head dim, zero-padded to 128 lanes; the port's K5 kernels take every
d up to 320 on its 256- and 320-wide instantiations, K5b there as two
launches (a dV pass, then a dK pass), K5's f32 forms streaming the scores'
depth. On a CPU tensor the wrappers take the plain versions, so here:

* the plain backward and the autograd path (``FlashAttention.backward``)
  against ``jax.vjp`` through the Pallas VJP in interpret mode, at d 256
  and 320 (num_heads 5's 24^2 sites at 768^2, num_heads 2's 32^2 sites at
  512^2), B 1, H 2, N 160, M 200, inputs from a numpy seed; tolerance
  1e-5 of the largest gradient (both f32, differing in summation order);
* K5b's two passes in bf16, each emulated alone at the new tiles: together
  they give ``tests/test_torch_kernels.py``'s one-pass emulation bit for
  bit, inside K5b's row; a pass not run, the dV pass fed dS^T, dV scaled
  or dK unscaled falls outside it (the f32 forms' cases are in
  ``tests/test_torch_f32_kernels.py``). Past 320 the column-group kernels
  take over: ``tests/test_torch_k5_wide.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.kernels.tolerance import agreement
from test_torch_kernels import K5_TILES, _flash_bwd_emulated
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GRAD_REL = 1e-5   # of the largest gradient


def _packed(a):
    """(B, H, N, d) -> (B, N, H*d)."""
    b, h, n, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, n, h * d))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, order="C")).requires_grad_(grad)


@pytest.mark.parametrize("d", [256, 320])
def test_k5_backward_matches_pallas_vjp(rng, d):
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


def _k5b_pass(which, q, k, v, dout, lse, delta, heads, scale, bq, fault=None):
    """One pass of csrc/flash_attention.cu's K5b past d 160 in f32 on the
    CPU (``_flash_bwd_emulated``'s arithmetic): the dV pass (``which``
    "dv": S^T alone, dV = sum of P^T dO, stored unscaled) or the dK pass
    ("dk": S^T and dP^T, dK = scale * sum of dS^T Q), over q/dO stages of
    ``bq`` rows. ``fault``: "dv_from_ds" feeds the dV pass dS^T in place of
    P^T, "dv_scaled" stores dV times the scale, "dk_unscaled" stores dK
    without it; "skip" leaves the pass's output unwritten (zeros)."""
    b, n, hc = q.shape
    m, d = k.shape[1], hc // heads
    split = lambda t: t.float().view(b, -1, heads, d).transpose(1, 2)
    qh, kh, vh, doh = split(q), split(k), split(v), split(dout)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    c = torch.tensor(scale, dtype=torch.float32) * log2e
    l2, delta = lse[..., None] * log2e, delta[..., None]
    bf = lambda t: t.to(torch.bfloat16).float()
    acc = torch.zeros(b, heads, m, d)
    for q0 in range(0, 0 if fault == "skip" else n, bq):
        qt, dot = qh[:, :, q0:q0 + bq], doh[:, :, q0:q0 + bq]
        p = torch.exp2(qt @ kh.transpose(-1, -2) * c - l2[:, :, q0:q0 + bq])
        if which == "dv" and fault != "dv_from_ds":
            acc += bf(p).transpose(-1, -2) @ dot
            continue
        ds = bf(p * (dot @ vh.transpose(-1, -2) - delta[:, :, q0:q0 + bq]))
        acc += ds.transpose(-1, -2) @ (dot if which == "dv" else qt)
    mul = scale if (which == "dk") != (fault in ("dk_unscaled", "dv_scaled")) else 1.0
    return acc.transpose(1, 2).reshape(b, m, hc).mul(mul).to(torch.bfloat16)


_PASS_FAULTS = {"skip_dv": ("dv", "skip"), "skip_dk": ("dk", "skip"),
                "dv_from_ds": ("dv", "dv_from_ds"), "dv_scaled": ("dv", "dv_scaled"),
                "dk_unscaled": ("dk", "dk_unscaled")}


@pytest.mark.parametrize("fault", [None, *_PASS_FAULTS])
@pytest.mark.parametrize("d", [256, 320])
def test_k5b_passes_each_write_their_output(d, fault):
    # N = M = 1054 (the 32^2 gated sites' length): K5b's dV pass and dK
    # pass, each run alone over the q/dO stages, give the one-pass
    # algorithm's outputs bit for bit and stay inside K5b's row; a pass
    # left out, the dV pass fed dS^T, dV scaled or dK left unscaled leaves
    # it
    b, heads, n = 2, 2, 1054
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, n, heads * d, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    dout = (0.1 * torch.randn(b, n, heads * d, generator=gen)).to(torch.bfloat16)
    scale = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, heads, scale)
    delta = K.attention_delta(out, dout, heads)
    ref = K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, heads, scale)[1:]
    bq = K5_TILES["K5b", d][0]
    planted = _PASS_FAULTS.get(fault, (None, None))
    dk, dv = (_k5b_pass(which, q, k, v, dout, lse, delta, heads, scale, bq,
                        planted[1] if planted[0] == which else None)
              for which in ("dk", "dv"))
    if fault is None:
        one = _flash_bwd_emulated("K5b", q, k, v, dout, lse, delta, heads,
                                  scale, None, *K5_TILES["K5b", d])
        assert torch.equal(dk, one[0]) and torch.equal(dv, one[1])
    got = agreement("K5b", (dk, dv), ref)
    assert got["ok"] == (fault is None), got

