"""The training slice's kernel backward and VAE encode against the JAX package.

* K5: ``flash_attention_bwd_plain`` (the math of the CUDA K5a/K5b, given the
  lse of the port's plain forward) against ``jax.vjp`` of the Pallas
  ``flash_attention`` custom VJP, whose backward kernels run in interpret
  mode on the CPU, as tests/test_attention.py runs them. Atol 2e-4, that
  test's tolerance for the same kernels against XLA.
* The K2/K3/K4 ``autograd.Function``s on CPU tensors against the JAX VJPs
  of ``group_norm_silu``, ``layer_norm_fused`` and ``ffn_ln_geglu_scaled`` /
  ``ffn_ln_geglu_fused``, the gradient with respect to the FF scale ``s``
  included. Both sides recompute through f32 reference math: atol 1e-4.
* VAE encode, the posterior mean and a posterior sample with the noise
  injected, at module parity (1e-4).

Inputs come from a numpy seed; both sides run in f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.models import vae as jvae
from layoutllm_t2i_tpu.ops.pallas.ffn import ffn_ln_geglu_fused, ffn_ln_geglu_scaled
from layoutllm_t2i_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from layoutllm_t2i_tpu.ops.pallas.norms import group_norm_silu, layer_norm_fused

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.checkpoint.from_jax import param_tree_from_jax
from layoutllm_t2i_torch.models import vae as pvae
from layoutllm_t2i_torch.ops import nn as pnn
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FLASH_ATOL = 2e-4
ATOL = 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, order="C")).requires_grad_(grad)


def _packed(a):
    """(B, H, N, d) -> (B, N, H*d)."""
    b, h, n, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b, n, h * d))


@pytest.mark.parametrize("n,m,d", [
    (300, 280, 40),   # 64^2 head dim, q and kv rows off the 128-row blocks
    (200, 150, 80),   # 32^2 head dim, ragged
])
def test_flash_backward_plain_matches_pallas_vjp(rng, n, m, d):
    b, h = 1, 2
    q, k, v = (rng.standard_normal((b, h, r, d), dtype=np.float32)
               for r in (n, m, m))
    g = rng.standard_normal((b, h, n, d), dtype=np.float32)
    scale = d ** -0.5
    out_j, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, scale, 128, 128, True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))

    qp, kp, vp, gp = (_t(_packed(a)) for a in (q, k, v, g))
    out, lse = K.flash_attention_lse_plain(qp, kp, vp, h, scale)
    np.testing.assert_allclose(out.numpy(), _packed(np.asarray(out_j)), atol=2e-5)
    delta = K.attention_delta(out, gp, h)
    got = K.flash_attention_bwd_plain(qp, kp, vp, gp, lse, delta, h, scale)
    for a, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), _packed(np.asarray(w)),
                                   atol=FLASH_ATOL, err_msg=f"d{name}")
    # the autograd Function takes the same route on CPU tensors
    leaves = [_t(_packed(a), grad=True) for a in (q, k, v)]
    fn_grads = torch.autograd.grad(K.flash_attention(*leaves, h, scale), leaves, gp)
    for a, c in zip(fn_grads, got):
        torch.testing.assert_close(a, c)


def _vjp_pair(jax_fn, jax_args, port_fn, port_args, g):
    """(JAX grads, port grads) of the same function at the same inputs."""
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in jax_args))
    want = vjp(jnp.asarray(g))
    leaves = [_t(a, grad=True) for a in port_args]
    out = port_fn(*leaves)
    got = torch.autograd.grad(out, leaves, _t(g.reshape(out.shape)))
    return [np.asarray(w) for w in want], [a.numpy() for a in got]


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_vjp_matches_jax(rng, silu):
    n, h, w, c = 2, 8, 8, 64
    x = rng.standard_normal((n, h, w, c), dtype=np.float32) * 2 + 0.5
    gamma = rng.standard_normal(c, dtype=np.float32) * 0.5 + 1
    beta = rng.standard_normal(c, dtype=np.float32) * 0.5
    g = rng.standard_normal((n, h, w, c), dtype=np.float32)
    want, got = _vjp_pair(
        lambda x_, g_, b_: group_norm_silu(x_, g_, b_, 32, 1e-6, silu),
        (x, gamma, beta),
        lambda x_, g_, b_: K.group_norm(x_, g_, b_, 32, 1e-6, silu),
        (x.reshape(n, h * w, c), gamma, beta), g)
    for a, w_, name in zip(got, want, ("x", "gamma", "beta")):
        np.testing.assert_allclose(a.reshape(w_.shape), w_, atol=ATOL, err_msg=name)


def test_layer_norm_vjp_matches_jax(rng):
    x = rng.standard_normal((4, 16, 128), dtype=np.float32) * 2 + 0.5
    gamma = rng.standard_normal(128, dtype=np.float32) * 0.5 + 1
    beta = rng.standard_normal(128, dtype=np.float32) * 0.5
    g = rng.standard_normal(x.shape, dtype=np.float32)
    want, got = _vjp_pair(
        lambda x_, g_, b_: layer_norm_fused(x_, g_, b_, 1e-5), (x, gamma, beta),
        lambda x_, g_, b_: K.layer_norm(x_, g_, b_, 1e-5),
        (x.reshape(-1, 128), gamma, beta), g)
    for a, w_, name in zip(got, want, ("x", "gamma", "beta")):
        np.testing.assert_allclose(a.reshape(w_.shape), w_, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("scaled", [True, False])
def test_ffn_ln_geglu_vjp_matches_jax(rng, scaled):
    """The fuser site (s a traced scalar, its gradient compared too) and
    the norm3 site (s = 1)."""
    m, k = 40, 64
    inner = 4 * k
    x = rng.standard_normal((m, k), dtype=np.float32)
    wa, wg = (rng.standard_normal((k, inner), dtype=np.float32) * k ** -0.5
              for _ in range(2))
    ba, bg = (rng.standard_normal(inner, dtype=np.float32) * 0.1 for _ in range(2))
    w2 = rng.standard_normal((inner, k), dtype=np.float32) * inner ** -0.5
    b2 = rng.standard_normal(k, dtype=np.float32) * 0.1
    gamma = rng.standard_normal(k, dtype=np.float32) * 0.2 + 1
    beta = rng.standard_normal(k, dtype=np.float32) * 0.2
    s = np.float32(0.37)
    g = rng.standard_normal((m, k), dtype=np.float32)
    # port layout: w1 = [Wa; Wg] (2*inner, K), w2 (K, inner), b1 = [ba; bg]
    w1 = np.concatenate([wa.T, wg.T])
    b1 = np.concatenate([ba, bg])
    if scaled:
        want, got = _vjp_pair(
            ffn_ln_geglu_scaled, (x, wa, wg, ba, bg, w2, b2, gamma, beta, s),
            lambda *a: K.ffn_ln_geglu(*a), (x, gamma, beta, w1, b1, w2.T, b2, s), g)
        jx, jwa, jwg, jba, jbg, jw2, jb2, jgm, jbt, js = want
        px, pgm, pbt, pw1, pb1, pw2, pb2, ps = got
        np.testing.assert_allclose(ps, js, atol=ATOL, err_msg="s")
    else:
        want, got = _vjp_pair(
            ffn_ln_geglu_fused, (x, wa, wg, ba, bg, w2, b2, gamma, beta),
            lambda *a: K.ffn_ln_geglu(*a, 1.0), (x, gamma, beta, w1, b1, w2.T, b2), g)
        jx, jwa, jwg, jba, jbg, jw2, jb2, jgm, jbt = want
        px, pgm, pbt, pw1, pb1, pw2, pb2 = got
    for a, w_, name in ((px, jx, "x"), (pgm, jgm, "gamma"), (pbt, jbt, "beta"),
                        (pw1, np.concatenate([jwa.T, jwg.T]), "w1"),
                        (pb1, np.concatenate([jba, jbg]), "b1"),
                        (pw2, jw2.T, "w2"), (pb2, jb2, "b2")):
        np.testing.assert_allclose(a, w_, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("sample", [False, True])
def test_vae_encode_matches_jax(rng, sample):
    # 48^2 image: the mid attention's 24^2 = 576 tokens take the flash route
    cfg_j = jvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    cfg_p = pvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    params = jvae.init_vae_params(jax.random.PRNGKey(7), cfg_j)
    x = rng.uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jvae.encode(params, cfg_j, jnp.asarray(x), rng=key, sample=sample)
    # the JAX posterior noise, injected into the port (NHWC -> NCHW)
    noise = None
    if sample:
        noise = jax.random.normal(key, ref.shape, jnp.float32)
        noise = pnn.nhwc_to_nchw(_t(noise))
    out = pvae.encode(param_tree_from_jax(params), cfg_p,
                      pnn.nhwc_to_nchw(_t(x)), sample=sample, noise=noise)
    assert out.dtype == torch.float32 and out.shape == (2, 4, 24, 24)
    np.testing.assert_allclose(pnn.nchw_to_nhwc(out).numpy(), np.asarray(ref),
                               atol=ATOL, rtol=ATOL)
