"""The port's weight-only int8 slice against the JAX package on the CPU.

* ``quantize_params`` on the bridged dense weights selects the same leaves
  as the JAX package's at the same ``min_size`` and gives bit-identical q
  and scale after the layout transpose; a quantized JAX tree crosses the
  bridge to the same ``QuantTensor``s; dequantizing, ``quantized_bytes``
  and a dtype cast of the tree behave as the JAX package's.
* K7's plain version (``ffn_ln_geglu_q_plain``) against
  ``ffn_ln_geglu_scaled_q``, whose Pallas kernel runs in interpret mode, at
  s in {1, 0.37, 0}: f32 on both sides, atol 2e-5 (sums over 512 terms
  in another order).
* K7's stated tolerance on the card (``kernels/tolerance.py``) against a
  CPU emulation of the CUDA kernel on gemm_tiles.cuh's mainloop: its
  rounding passes, six planted faults do not.
* The int8 generation slice at small geometry (``quantize_unet_int8(...,
  min_size=128)``, every UNet weight int8, the FF weights among them) of an
  f32 bundle, the port against the JAX pipeline within
  tests/parity_setup.py's gates: on the default int8 route and under
  LLT2I_FFN_INT8=1 (both packages on their kernel routes: the JAX enabler
  and the port's ``_on_card`` patched; at this geometry no FF site is
  eligible for K7, so both take their plain paths). The bundle quantizes to
  int8 values and f32 scales, its dense leaves stay f32.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from layoutllm_t2i_tpu.diffusion.samplers import plms_sample as jax_plms
from layoutllm_t2i_tpu.models import unet as junet
from layoutllm_t2i_tpu.models.vae import decode as jax_vae_decode
from layoutllm_t2i_tpu.ops import nn as jnn
from layoutllm_t2i_tpu.ops import quant as jquant
from layoutllm_t2i_tpu.ops.pallas.ffn import ffn_ln_geglu_scaled_q
from layoutllm_t2i_tpu.pipeline.inference import (
    InferencePipeline as JaxPipeline, make_cfg_denoiser, precompute_grounding_tokens,
)
from layoutllm_t2i_tpu.pipeline.loaders import quantize_unet_int8 as jax_quantize_unet_int8
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models

from parity_setup import LATENT_GATE, PSNR_GATE_DB, SSIM_GATE, psnr, ssim

from layoutllm_t2i_torch.checkpoint.from_jax import (
    load_from_jax, param_tree_from_jax, torch_layout,
)
from layoutllm_t2i_torch.kernels import ffn_ln_geglu_q, ffn_ln_geglu_q_plain
from layoutllm_t2i_torch.kernels.tolerance import agreement
from layoutllm_t2i_torch.ops import nn as pnn
from layoutllm_t2i_torch.ops import quant as pquant
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.pipeline.loaders import quantize_unet_int8, random_models
from layoutllm_t2i_torch.utils.trees import flatten_tree, override_subtree
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SMALL_UNET = dict(image_size=8, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(2, 1), channel_mult=(1, 2),
                  num_heads=2)


def _flat_leaves(tree):
    """{dotted name: leaf} of a nested dict or ParamTree, int8 leaves kept."""
    out = {}

    def rec(node, prefix):
        for k in node.keys():
            v = node[k]
            if isinstance(v, dict) or isinstance(v, torch.nn.Module):
                rec(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = v
    rec(tree, "")
    return out


@pytest.fixture(scope="module")
def unet_pair():
    """A small JAX UNet tree in f32 and the port's ParamTree of the same
    weights."""
    tree = junet.init_unet_params(jax.random.PRNGKey(5), junet.UNetConfig(**SMALL_UNET))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return tree, param_tree_from_jax(tree, device="cpu")


@pytest.mark.parametrize("min_size", [128, 4096, 1 << 16])
def test_quantize_params_bit_equal_to_jax(unet_pair, min_size):
    jtree, ptree = unet_pair
    # a NumPy tree_map reaches into the JAX QuantTensor (a pytree node)
    jq = jax.tree_util.tree_map(np.asarray, jquant.quantize_params(jtree, min_size))
    pq = pquant.quantize_params(ptree, min_size)
    jflat = flatten_tree(jq)
    pflat = _flat_leaves(pq)
    assert set(jflat) == set(pflat)
    jsel = {k for k, v in jflat.items() if jquant.is_quantized(v)}
    psel = {k for k, v in pflat.items() if pquant.is_quantized(v)}
    assert jsel == psel and jsel
    for name in jsel:
        jv, pv = jflat[name], pflat[name]
        np.testing.assert_array_equal(pv.q.numpy(), torch_layout(name, jv.q), name)
        np.testing.assert_array_equal(pv.scale.numpy(), np.asarray(jv.scale), name)
        assert pv.q.dtype == torch.int8 and pv.scale.dtype == torch.float32
    # a quantized JAX tree crosses the bridge to the same QuantTensors
    bridged = _flat_leaves(param_tree_from_jax(
        jax.tree_util.tree_map(np.asarray, jq), device="cpu"))
    for name in jsel:
        assert torch.equal(bridged[name].q, pflat[name].q)
        assert torch.equal(bridged[name].scale, pflat[name].scale)
        assert bridged[name].dtype == torch.float32
    # the footprint the JAX package reports, to the byte
    assert pquant.quantized_bytes(pq) == jquant.quantized_bytes(jq)
    assert pquant.quantized_bytes(pq) < pquant.quantized_bytes(ptree)


def test_dequantize_and_casts_match_jax(unet_pair):
    jtree, ptree = unet_pair
    jd = flatten_tree(jax.tree_util.tree_map(
        np.asarray, jquant.dequantize_params(jquant.quantize_params(jtree, 128))))
    pq = pquant.quantize_params(ptree, 128)
    pd = _flat_leaves(pquant.dequantize_params(pq))
    assert not any(pquant.is_quantized(v) for v in pd.values())
    for name, a in jd.items():
        np.testing.assert_array_equal(pd[name].detach().numpy(),
                                      torch_layout(name, a), name)
    # a dtype cast of the tree reaches the dense leaves only: the int8 values
    # and the f32 scales keep their types
    cast = pq.to(torch.bfloat16)
    leaves = _flat_leaves(cast)
    name = "input_blocks.1.1.transformer_blocks.0.ff.net.0.proj.weight"
    assert leaves[name].q.dtype == torch.int8
    assert leaves[name].scale.dtype == torch.float32
    assert torch.equal(leaves[name].scale, _flat_leaves(pq)[name].scale)
    assert leaves[name.replace("weight", "bias")].dtype == torch.bfloat16
    # the SD first-conv restore swaps a subtree of the int8 tree
    conv = {"weight": torch.zeros(32, 4, 3, 3), "bias": torch.zeros(32)}
    view = override_subtree(pq, ("input_blocks", "0", "0"), conv)
    assert view["input_blocks"]["0"]["0"] is conv
    assert pquant.is_quantized(view["input_blocks"]["1"]["0"]["in_layers"]["2"]["weight"])


def _int8_ffn_inputs(rng, m, k, inner):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    qproj = jquant.quantize_tensor(f(k, 2 * inner) * 0.05, jnp.float32)
    qout = jquant.quantize_tensor(f(inner, k) * 0.05, jnp.float32)
    return dict(x=f(m, k) * 0.5, ba=f(inner) * 0.1, bg=f(inner) * 0.1,
                b2=f(k) * 0.1, gamma=1.0 + f(k) * 0.1, beta=f(k) * 0.1,
                q1=np.asarray(qproj.q), s1=np.asarray(qproj.scale),
                q2=np.asarray(qout.q), s2=np.asarray(qout.scale))


@pytest.mark.parametrize("s", [1.0, 0.37, 0.0])
def test_ffn_int8_plain_matches_pallas(rng, s):
    m, k, inner = 256, 128, 512
    a = _int8_ffn_inputs(rng, m, k, inner)
    j = {key: jnp.asarray(v) for key, v in a.items()}
    ref = np.asarray(ffn_ln_geglu_scaled_q(
        j["x"], j["q1"][:, :inner], j["q1"][:, inner:], j["s1"][:inner],
        j["s1"][inner:], j["ba"], j["bg"], j["q2"], j["s2"], j["b2"],
        j["gamma"], j["beta"], jnp.float32(s)))
    t = lambda v: torch.from_numpy(np.array(v))
    # the port's layout: q1 (2*inner, K), q2 (K, inner), scales per row
    out = ffn_ln_geglu_q(t(a["x"]), t(a["gamma"]), t(a["beta"]), t(a["q1"].T),
                         t(a["s1"]), t(np.concatenate([a["ba"], a["bg"]])),
                         t(a["q2"].T), t(a["s2"]), t(a["b2"]), torch.tensor(s))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)


def _chunk_sums(a, q, stale=False):
    """a q^T as csrc/gemm_tiles.cuh sums it with an int8 B operand: f32 over
    64-deep chunks of the contraction (one stage each), q's int8 values
    exact in bf16, the last chunk zero-filled past the end. ``stale``
    plants a converter one chunk behind the loading thread: chunk t is
    multiplied by chunk t - 1's int8 tile (chunk 0 by its own)."""
    k = a.shape[1]
    pad = (-k) % 64
    af = F.pad(a.float(), (0, pad))
    qf = F.pad(q.float(), (0, pad))
    acc = torch.zeros(a.shape[0], q.shape[0])
    for k0 in range(0, k + pad, 64):
        b0 = max(k0 - 64, 0) if stale else k0
        acc += af[:, k0:k0 + 64] @ qf[:, b0:b0 + 64].t()
    return acc


def _k7_emulated(x, lw, lb, q1, s1, b1, q2, s2, b2, s, fault=None, eps=1e-5):
    """csrc/ffn.cu's K7 on the CPU: K4's pre-pass (bf16(LN(x)) once per row,
    the mean, then the centred variance, in f32), the up GEMM against Qa and
    Qg with (acc_a * sa + ba) * gelu_erf(acc_g * sg + bg) in f32 rounded
    once to bf16 h, the down GEMM against Q2 with bf16(bf16((acc * s2 + b2)
    * s) + x); both GEMMs summed in 64-deep chunks (``_chunk_sums``).
    ``fault`` plants a mistake the kernels could make."""
    bf = lambda t: t.to(torch.bfloat16).float()
    k, inner = x.shape[1], q1.shape[0] // 2
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    xn = (xf - mean) * rstd * lw.float() + lb.float()
    q1v, q2v = q1, q2
    if fault == "unsigned":           # the int8 bytes read as uint8
        q1v = q1.to(torch.int16) & 0xFF
        q2v = q2.to(torch.int16) & 0xFF
    stale = fault == "stale_stage"
    sa, sg = s1[:inner], s1[inner:]
    ba, bg = b1[:inner].float(), b1[inner:].float()
    if fault == "input_channel":      # the scales indexed by the input channel
        a = _chunk_sums(bf(xn * sa[:k]), q1v[:inner]) + ba
        g = _chunk_sums(bf(xn * sg[:k]), q1v[inner:]) + bg
    else:
        y1 = _chunk_sums(bf(xn), q1v, stale)
        if fault == "scale_after_bias":   # (acc + b) * s, not acc * s + b
            a, g = (y1[:, :inner] + ba) * sa, (y1[:, inner:] + bg) * sg
        else:
            a, g = y1[:, :inner] * sa + ba, y1[:, inner:] * sg + bg
    h = bf(a * F.gelu(g))
    acc = _chunk_sums(h, q2v, stale)
    if fault == "dropped_scale":
        y = acc + b2.float()
    elif fault == "scale_after_bias":
        y = (acc + b2.float()) * s2
    else:
        y = acc * s2 + b2.float()
    y = bf(y * (1.0 if fault == "s_ignored" else s))
    return (y + xf).to(torch.bfloat16)


# the planted faults of K7's design: "dropped_scale" drops s2,
# "input_channel" applies sa and sg per input channel, "unsigned" reads q as
# uint8, "s_ignored" takes s = 1, "stale_stage" converts each chunk from the
# previous chunk's int8 tile, "scale_after_bias" computes (acc + b) * s
K7_FAULTS = ("dropped_scale", "input_channel", "unsigned", "s_ignored",
             "stale_stage", "scale_after_bias")


@pytest.mark.parametrize("s,fault", [(1.0, None), (0.37, None), (0.0, None)]
                         + [(0.37, fault) for fault in K7_FAULTS])
def test_k7_tolerance_separates_rounding_from_faults(s, fault):
    # the 64^2 site's width at 512 rows, inputs drawn as chip_smoke draws
    # them
    m, k = 512, 320
    inner = 4 * k
    g = torch.Generator().manual_seed(0)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g) * scale
                                     ).to(torch.bfloat16)
    x = rnd(m, k)
    lw, lb = rnd(k, scale=0.2) + 1.0, rnd(k, scale=0.2)
    w1, b1 = rnd(2 * inner, k, scale=k ** -0.5), rnd(2 * inner, scale=0.1)
    w2, b2 = rnd(k, inner, scale=inner ** -0.5), rnd(k, scale=0.1)
    qw1, qw2 = pquant.quantize_tensor(w1), pquant.quantize_tensor(w2)
    args = (x, lw, lb, qw1.q, qw1.scale, b1, qw2.q, qw2.scale, b2, s)
    got = agreement("K7", _k7_emulated(*args, fault=fault), ffn_ln_geglu_q_plain(*args))
    assert got["ok"] == (fault is None), got


# ---------------------------------------------------------------------------
# the int8 generation slice

PROMPTS = ["a dog chasing a ball on the grass", "a cat sitting on a chair"]
LAYOUTS = [([[0.1, 0.4, 0.5, 0.9], [0.6, 0.6, 0.85, 0.85]], ["a dog", "a ball"]),
           ([[0.2, 0.1, 0.6, 0.6], [0.1, 0.4, 0.7, 0.95]], ["a cat", "a chair"])]
RELATIONS = [["dog chasing ball"], ["cat on chair"]]
SAMPLE = dict(steps=4, guidance_scale=7.5, alpha_type=(0.5, 0.0, 0.5))


@pytest.mark.parametrize("ffn_int8", ["0", "1"])
def test_int8_generation_matches_jax(monkeypatch, ffn_int8):
    monkeypatch.setenv("LLT2I_FFN_INT8", ffn_int8)
    if ffn_int8 == "1":
        monkeypatch.setattr(jnn, "_pallas_ffn_enabled", lambda: True)
        monkeypatch.setattr(pnn, "_on_card", lambda x: True)
    jm = jax_random_models(seed=0, small=True)
    jm.unet_params["input_blocks"]["1"]["1"]["transformer_blocks"]["0"][
        "fuser"]["alpha_attn"] = np.asarray(0.6, np.float32)
    pm = random_models(small=True, device="cpu", dtype=torch.float32, seed=1)
    for name in ("unet_params", "vae_params", "clip_params"):
        load_from_jax(getattr(pm, name), getattr(jm, name))
    jq = jax_quantize_unet_int8(jm, min_size=128)
    pq = quantize_unet_int8(pm, min_size=128)
    leaves = _flat_leaves(pq.unet_params)
    n_q = sum(pquant.is_quantized(v) for v in leaves.values())
    assert n_q == sum(jquant.is_quantized(v) for v in jax.tree_util.tree_leaves(
        jq.unet_params, is_leaf=jquant.is_quantized)) > 0
    # an f32 bundle: int8 values, f32 scales and logical type, every FF
    # weight quantized; the small weights, biases and norms stay f32
    ff = [v for n, v in leaves.items() if ".ff.net." in n and n.endswith("weight")]
    assert ff and all(pquant.is_quantized(v) for v in ff)
    for v in leaves.values():
        if pquant.is_quantized(v):
            assert (v.q.dtype, v.scale.dtype, v.dtype) == (
                torch.int8, torch.float32, torch.float32)
        else:
            assert v.dtype is torch.float32
    assert pq.compute_dtype is torch.float32

    jp, pp = JaxPipeline(jq, **SAMPLE), InferencePipeline(pq, **SAMPLE)
    noise = np.random.default_rng(7).standard_normal((2, 8, 8, 4)).astype(np.float32)
    cond_j = jp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    cond_p = pp.build_cond(PROMPTS, LAYOUTS, RELATIONS)
    core = make_cfg_denoiser(jq, SAMPLE["guidance_scale"])
    cj = dict(cond_j)
    cj["objs"] = precompute_grounding_tokens(jq, jq.unet_params, cj, True)
    z_j = jax.jit(lambda params, z: jax_plms(
        lambda x, t, f, u: core(params, None, cj, x, t, f, u),
        jp.tables, z, schedule=jq.schedule,
        denoise_skip_fn=lambda x, t, f, u: core(params, None, cj, x, t, f, u,
                                                skip_gated=True)))(
        jq.unet_params, jnp.asarray(noise))
    z_p = pp.run_sampler(cond_p, noise)
    lat_err = float(np.abs(z_p.numpy() - np.asarray(z_j)).max())
    assert lat_err < LATENT_GATE, lat_err

    img_j = jax.jit(lambda z: jnp.clip(jax_vae_decode(jq.vae_params, jq.vae_cfg, z),
                                       -1.0, 1.0) * 0.5 + 0.5)(z_j)
    img_p = pp.decode(z_p).numpy()
    assert img_p.shape == (2, 16, 16, 3)
    assert np.isfinite(img_p).all() and img_p.min() >= 0 and img_p.max() <= 1
    for a, b in zip(img_p, np.asarray(img_j)):
        assert psnr(a, b) >= PSNR_GATE_DB
        assert ssim(a, b) >= SSIM_GATE
