"""The opt-in FF and GEMM routes of the port against the JAX package on the
CPU.

* The plain versions of K6 (``ffn_geglu_plain``), K8a (``linear_plain``)
  and K8b (``geglu_plain``) against ``ffn_geglu_fused``, ``linear_fused``
  (and ``_mm_call`` with its residual) and ``geglu_fused``, whose Pallas
  kernels run in interpret mode; their backward (the Functions' plain VJP)
  against ``jax.vjp`` of the same functions. f32 on both sides at
  block-decomposable sizes (M = 256, K = 128, inner = 512): atol 2e-5 for
  the outputs, 1e-4 for the gradients (sums over 256 rows).
* ``ffn_eligible`` and ``_eligible`` decide as the JAX package's over a
  grid of shapes, with and without the ``LLT2I_FFN_BM/BN`` overrides.
* Route parity at one ``basic_transformer_block`` of width 128 under each
  combination of LLT2I_FFN_LN, LLT2I_PALLAS_FFN, LLT2I_PALLAS_MATMUL and
  LLT2I_FFN_INT8, dense and int8: at 2 x 512 rows (eligible) and 2 x 256
  (not). The JAX enablers are monkeypatched to take the Pallas routes off
  the TPU, and the port's ``_on_card`` to take the kernel routes for CPU
  tensors; a spy on each side records the kernel entries reached. Both
  sides reach the same entries in the same order, the attention
  projections never reach K8a, and the outputs agree to 1e-4 (f32). The
  cases marked "f32 entries" (the split routes, and LLT2I_FFN_INT8=1 on
  an f32 int8 bundle) then run the port's block again with the FF and GEMM
  wrappers on their kernel path (``torch_kernel_stub``): every call reaches
  the f32 C entry of its kernel, in the JAX package's order.
* K8a and the CLIP towers: under LLT2I_PALLAS_MATMUL=1 the reward's text
  and vision towers (full width, one layer) at B = 4 and B = 8 route no
  linear to K8a, as ``_eligible`` (the JAX package's, copied) says of B *
  77 and B * 257 rows; the copy agrees with the JAX one on every (m, k, n)
  of the reward's and of a batch-8 training step's linears.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.models import blocks as jblocks
from layoutllm_t2i_tpu.ops import nn as jnn
from layoutllm_t2i_tpu.ops import quant as jquant
from layoutllm_t2i_tpu.ops.pallas import ffn as jffn
from layoutllm_t2i_tpu.ops.pallas import matmul as jmm

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.checkpoint.from_jax import state_dict_from_jax
from layoutllm_t2i_torch.models import blocks as pblocks
from layoutllm_t2i_torch.ops import nn as pnn
from layoutllm_t2i_torch.ops.quant import quantize_params
from layoutllm_t2i_torch.utils.trees import unflatten_tree
from torch_kernel_stub import F32_ENTRY, stub_kernels
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ATOL = 2e-5
GRAD_ATOL = 1e-4


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, order="C")).requires_grad_(grad)


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out.detach()), np.asarray(ref),
                               atol=atol, rtol=1e-4)


@pytest.fixture
def ff_inputs(rng):
    m, k, inner = 256, 128, 512
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(m, k), wa=f(k, inner) * 0.1, wg=f(k, inner) * 0.1,
                ba=f(inner) * 0.1, bg=f(inner) * 0.1, w2=f(inner, k) * 0.1,
                b2=f(k) * 0.1, r=f(m, k), g=f(m, k))


def test_ffn_geglu_plain_and_vjp_match_pallas(ff_inputs):
    a = ff_inputs
    names = ("x", "wa", "wg", "ba", "bg", "w2", "b2", "r")
    ref, vjp = jax.vjp(jffn.ffn_geglu_fused, *(jnp.asarray(a[n]) for n in names))
    want = vjp(jnp.asarray(a["g"]))
    # the port's layout: w1 = [Wa; Wg] (2*inner, K), w2 (K, inner)
    x, r = _t(a["x"], True), _t(a["r"], True)
    w1 = _t(np.concatenate([a["wa"], a["wg"]], axis=1).T, True)
    b1 = _t(np.concatenate([a["ba"], a["bg"]]), True)
    w2, b2 = _t(a["w2"].T, True), _t(a["b2"], True)
    out = K.ffn_geglu(x, w1, b1, w2, b2, r)
    _close(out, ref)
    dx, dw1, db1, dw2, db2, dr = torch.autograd.grad(
        out, (x, w1, b1, w2, b2, r), _t(a["g"]))
    inner = a["wa"].shape[1]
    got = (dx, dw1[:inner].t(), dw1[inner:].t(), db1[:inner], db1[inner:],
           dw2.t(), db2, dr)
    for name, g_port, g_jax in zip(names, got, want):
        np.testing.assert_allclose(g_port.numpy(), np.asarray(g_jax),
                                   atol=GRAD_ATOL, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_plain_and_vjp_match_pallas(ff_inputs, bias):
    a = ff_inputs
    jx, jw = jnp.asarray(a["x"]), jnp.asarray(a["wa"])      # (M, K) @ (K, N)
    jb = jnp.asarray(a["ba"]) if bias else None
    ref, vjp = jax.vjp(lambda x, w, b: jmm.linear_fused(x, w, b), jx, jw, jb)
    g = np.ascontiguousarray(a["g"][:, :1].repeat(a["wa"].shape[1], 1))
    want = vjp(jnp.asarray(g))
    x, w = _t(a["x"], True), _t(a["wa"].T, True)
    b = _t(a["ba"], True) if bias else None
    out = K.linear_fused(x, w, b)
    _close(out, ref)
    got = torch.autograd.grad(out, [t for t in (x, w, b) if t is not None], _t(g))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=GRAD_ATOL)
    np.testing.assert_allclose(got[1].t().numpy(), np.asarray(want[1]), atol=GRAD_ATOL)
    if bias:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=GRAD_ATOL)


def test_linear_residual_matches_pallas(ff_inputs):
    a = ff_inputs
    n = a["wa"].shape[1]
    r = np.ascontiguousarray(a["g"][:, :1].repeat(n, 1))
    ref = jmm._mm_call(jnp.asarray(a["x"]), jnp.asarray(a["wa"]),
                       jnp.asarray(a["ba"]).reshape(1, -1), jnp.asarray(r),
                       interpret=True, has_bias=True, has_res=True)
    _close(K.linear_fused(_t(a["x"]), _t(a["wa"].T), _t(a["ba"]), _t(r)), ref)


@pytest.mark.parametrize("bias", [True, False])
def test_geglu_plain_and_vjp_match_pallas(ff_inputs, bias):
    a = ff_inputs
    args = [jnp.asarray(a[n]) for n in ("x", "wa", "wg")]
    args += [jnp.asarray(a["ba"]), jnp.asarray(a["bg"])] if bias else [None, None]
    ref, vjp = jax.vjp(jmm.geglu_fused, *args)
    g = np.ascontiguousarray(a["g"][:, :1].repeat(a["wa"].shape[1], 1))
    want = vjp(jnp.asarray(g))
    x = _t(a["x"], True)
    w = _t(np.concatenate([a["wa"], a["wg"]], axis=1).T, True)
    b = _t(np.concatenate([a["ba"], a["bg"]]), True) if bias else None
    out = K.geglu_fused(x, w, b)
    _close(out, ref)
    got = torch.autograd.grad(out, [t for t in (x, w, b) if t is not None], _t(g))
    n = a["wa"].shape[1]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=GRAD_ATOL)
    np.testing.assert_allclose(got[1][:n].t().numpy(), np.asarray(want[1]), atol=GRAD_ATOL)
    np.testing.assert_allclose(got[1][n:].t().numpy(), np.asarray(want[2]), atol=GRAD_ATOL)
    if bias:
        np.testing.assert_allclose(got[2][:n].numpy(), np.asarray(want[3]), atol=GRAD_ATOL)
        np.testing.assert_allclose(got[2][n:].numpy(), np.asarray(want[4]), atol=GRAD_ATOL)


@pytest.mark.parametrize("env,ffn_any", [
    ({}, True),
    ({"LLT2I_FFN_BM": "128"}, True),
    ({"LLT2I_FFN_BN": "64"}, False),    # inner blocks under 128: no FF site
])
def test_eligibility_matches_jax(monkeypatch, env, ffn_any):
    """The copies of ffn_eligible and _eligible decide as the JAX package's,
    with its LLT2I_FFN_BM / LLT2I_FFN_BN overrides, at the SD-1.4 sites and
    off them."""
    from layoutllm_t2i_torch.kernels.ffn import ffn_eligible
    from layoutllm_t2i_torch.kernels.matmul import _eligible

    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ffn_seen, mm_seen = set(), set()
    for m in (256, 512, 1000, 1024, 1056, 2048, 4096, 4126, 16384, 32768):
        for k in (64, 96, 128, 320, 640, 1280):
            for n in (k, 4 * k, 8 * k):
                for itemsize in (2, 4):
                    got = ffn_eligible(m, k, n, itemsize)
                    assert got == jffn.ffn_eligible(m, k, n, itemsize)
                    ffn_seen.add(got)
                got = _eligible(m, k, n)
                assert got == jmm._eligible(m, k, n)
                mm_seen.add(got)
    assert ffn_seen == ({True, False} if ffn_any else {False})
    assert mm_seen == {True, False}


# ---------------------------------------------------------------------------
# route parity at one transformer block

C, HEADS = 128, 2

# name -> (switches, int8 weights, the kernels an eligible block reaches, in
# order: the fuser's dense branch, then the norm3 site)
COMBOS = {
    "default": ({}, False, ["K4", "K4"]),
    "ffn_ln0": ({"LLT2I_FFN_LN": "0"}, False, ["K6"]),
    "matmul": ({"LLT2I_PALLAS_MATMUL": "1"}, False, ["K4", "K4"]),
    "ffn_ln0+matmul": ({"LLT2I_FFN_LN": "0", "LLT2I_PALLAS_MATMUL": "1"}, False,
                       ["K8b", "K8a", "K6"]),
    "no_fused_ffn+matmul": ({"LLT2I_PALLAS_FFN": "0", "LLT2I_PALLAS_MATMUL": "1"},
                            False, ["K8b", "K8a", "K8b", "K8a"]),
    "int8": ({}, True, []),
    "int8+ffn_int8": ({"LLT2I_FFN_INT8": "1"}, True, ["K7", "K7"]),
    "int8+matmul": ({"LLT2I_PALLAS_MATMUL": "1"}, True,
                    ["K8b", "K8a", "K8b", "K8a"]),
}
SWITCHES = ("LLT2I_FFN_LN", "LLT2I_PALLAS_FFN", "LLT2I_PALLAS_MATMUL",
            "LLT2I_FFN_INT8")


@pytest.fixture
def spies(monkeypatch):
    """Both packages on their kernel routes; every kernel entry recorded
    as (kid, rows, cols[, out cols]) on each side."""
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jnn, "_pallas_matmul_enabled",
                        lambda: os.environ.get("LLT2I_PALLAS_MATMUL", "0") == "1")
    monkeypatch.setattr(jnn, "_pallas_ffn_enabled",
                        lambda: os.environ.get("LLT2I_PALLAS_FFN", "1") == "1")
    monkeypatch.setattr(pnn, "_on_card", lambda x: True)

    def spy(module, name, calls, kid, shape):
        fn = getattr(module, name)

        def wrapped(*args):
            calls.append((kid, *shape(*args)))
            return fn(*args)
        monkeypatch.setattr(module, name, wrapped)

    rows = lambda x, *_: x.shape
    for name in ("ffn_ln_geglu_fused", "ffn_ln_geglu_scaled"):
        spy(jffn, name, jax_calls, "K4", rows)
    spy(jffn, "ffn_geglu_fused", jax_calls, "K6", rows)
    spy(jffn, "ffn_ln_geglu_scaled_q", jax_calls, "K7", rows)
    spy(jmm, "linear_fused", jax_calls, "K8a", lambda x, w, b: (*x.shape, w.shape[1]))
    spy(jmm, "geglu_fused", jax_calls, "K8b", lambda x, wa, *_: (*x.shape, wa.shape[1]))
    spy(pnn, "ffn_ln_geglu", port_calls, "K4", rows)
    spy(pnn, "ffn_geglu", port_calls, "K6", rows)
    spy(pnn, "ffn_ln_geglu_q", port_calls, "K7", rows)
    spy(pnn, "linear_fused", port_calls, "K8a",
        lambda x, w, b=None, r=None: (*x.shape, w.shape[0]))
    spy(pnn, "geglu_fused", port_calls, "K8b",
        lambda x, w, b=None: (*x.shape, w.shape[0] // 2))
    return jax_calls, port_calls


def _block_inputs(rng, h, w):
    params = jblocks.init_basic_transformer_block(
        jax.random.PRNGKey(4), C, 768, 768, HEADS, C // HEADS)
    params = jax.tree_util.tree_map(np.asarray, params)
    for p in (params["fuser"], params["rela_fuse"]):
        p["alpha_attn"] = np.asarray(0.6, np.float32)
        p["alpha_dense"] = np.asarray(0.7, np.float32)
    boxes = np.zeros((2, 30, 4), np.float32)
    masks = np.zeros((2, 30), np.float32)
    boxes[:, :2] = [[0.1, 0.2, 0.5, 0.9], [0.55, 0.1, 0.95, 0.6]]
    masks[:, :2] = 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    acts = dict(x=f(2, h * w, C), ctx=f(2, 77, 768), objs=f(2, 30, 768),
                rel=f(2, 5, 768), boxes=boxes, masks=masks)
    return params, acts


# a case that also runs the port's block on the stubbed kernel path
ENTRIES = " f32 entries"


@pytest.mark.parametrize("h,w,combo", [
    *((16, 32, name) for name in COMBOS),
    (16, 16, "ffn_ln0+matmul"), (16, 16, "int8+ffn_int8"),
    *((16, 32, name + ENTRIES) for name in ("ffn_ln0", "ffn_ln0+matmul",
                                            "no_fused_ffn+matmul",
                                            "int8+ffn_int8")),
])
def test_block_routes_match_jax(rng, spies, monkeypatch, h, w, combo):
    entries = combo.endswith(ENTRIES)
    switches, int8, kernels = COMBOS[combo.removesuffix(ENTRIES)]
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in switches.items():
        monkeypatch.setenv(name, value)
    params, a = _block_inputs(rng, h, w)
    pparams = unflatten_tree(state_dict_from_jax(params))
    if int8:
        params = jquant.quantize_params(params, min_size=128)
        pparams = quantize_params(pparams, min_size=128)
    names = ("x", "ctx", "objs", "rel", "boxes", "masks")
    ref = jblocks.basic_transformer_block(
        params, *(jnp.asarray(a[n]) for n in names), h, w, HEADS,
        fuser_scale=0.8)
    out = pblocks.basic_transformer_block(
        pparams, *(_t(a[n]) for n in names), h, w, HEADS, fuser_scale=0.8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    jax_calls, port_calls = spies
    assert port_calls == jax_calls
    eligible = 2 * h * w >= 1024
    assert [c[0] for c in port_calls] == (kernels if eligible else [])
    # K8a only ever takes the FF down-projection (inner = 4 * C columns in):
    # the attention projections are plain matmuls on both sides
    assert all(c[2] == 4 * C for c in port_calls if c[0] == "K8a")
    if entries:
        # f32 activations (and, int8, f32 scales and dense leaves): each
        # wrapper reaches its kernel's f32 entry
        assert out.dtype is torch.float32
        lib = stub_kernels(monkeypatch)
        pblocks.basic_transformer_block(
            pparams, *(_t(a[n]) for n in names), h, w, HEADS, fuser_scale=0.8)
        assert lib.calls == [F32_ENTRY[kid] for kid in kernels] != []


# ---------------------------------------------------------------------------
# K8a and the reward's f32 CLIP towers


@pytest.mark.parametrize("b", [4, 8])
def test_reward_towers_route_no_linear_to_k8a(monkeypatch, b):
    """B * 77 (text) and B * 257 (vision) rows: above 512, _pick_block(m,
    512) >= 256 asks 256 to divide m, which only B a multiple of 256 meets;
    so under LLT2I_PALLAS_MATMUL=1 no linear of the towers takes K8a."""
    from layoutllm_t2i_torch.kernels import matmul as pmm
    from layoutllm_t2i_torch.models import clip_text, clip_vision
    from layoutllm_t2i_torch.models import initializers as init

    monkeypatch.setenv("LLT2I_PALLAS_MATMUL", "1")
    monkeypatch.setattr(pnn, "_on_card", lambda x: True)
    asked, routed = [], []
    monkeypatch.setattr(pnn, "_eligible", lambda m, k, n: asked.append(
        (m, k, n)) or pmm._eligible(m, k, n))
    monkeypatch.setattr(pnn, "linear_fused", lambda *a: routed.append(a))
    ini = init.Init(torch.Generator().manual_seed(0), torch.device("cpu"))
    tcfg = clip_text.CLIPTextConfig(num_layers=1)
    tparams = clip_text.init_clip_text_params(ini, tcfg)
    tparams["text_projection"] = init.linear_p(ini, tcfg.hidden_size, 768,
                                               bias=False)
    vcfg = clip_vision.CLIPVisionConfig(num_layers=1)
    vparams = clip_vision.init_clip_vision_params(ini, vcfg)
    ids = torch.randint(0, tcfg.vocab_size, (b, tcfg.max_length),
                        generator=torch.Generator().manual_seed(1))
    pixels = torch.randn(b, vcfg.image_size, vcfg.image_size, 3,
                         generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        t = clip_text.clip_text_features(tparams, tcfg, ids)
        v = clip_vision.clip_image_features(vparams, vcfg, pixels)
    assert t.shape == v.shape == (b, 768) and t.dtype is v.dtype is torch.float32
    assert {m for m, _, _ in asked} == {b * 77, b * 257, b}
    assert routed == []
    assert all(not jmm._eligible(*mkn) for mkn in asked)


def test_eligible_matches_jax_on_reward_and_training_linears():
    """The copy of _eligible against the JAX one on every (m, k, n) of the
    reward's towers (B = 1..600) and of a batch-8 training step's linears
    (rows at the UNet's levels, with and without the 30 grounding tokens,
    and the text and time rows; every width the step's linears take)."""
    from layoutllm_t2i_torch.kernels.matmul import _eligible

    reward_rows = [b * n for b in range(1, 601) for n in (1, 77, 257)]
    reward_widths = [(768, 768), (768, 3072), (3072, 768), (1024, 1024),
                     (1024, 4096), (4096, 1024), (1024, 768)]
    unet_rows = [8 * n for hw in (4096, 1024, 256, 64)
                 for n in (hw, hw + 30)] + [8, 8 * 30, 8 * 10, 8 * 77]
    widths = (320, 640, 768, 1280, 1024, 2560, 5120, 10240)
    unet_widths = [(k, n) for k in widths for n in widths]
    eligible = set()
    for rows, pairs in ((reward_rows, reward_widths), (unet_rows, unet_widths)):
        for m in rows:
            for k, n in pairs:
                got = _eligible(m, k, n)
                assert got == jmm._eligible(m, k, n), (m, k, n)
                if got:
                    eligible.add((m, k, n))
    # the reward's rows qualify at B = 256 and 512 only; the FF sites of
    # the 64^2, 32^2 and 16^2 levels at batch 8 do
    assert {m for m, _, _ in eligible if m in reward_rows and m not in
            unet_rows} == {256 * 77, 512 * 77, 256 * 257, 512 * 257}
    assert {(8 * 4096, 320, 1280), (8 * 1024, 640, 2560),
            (8 * 256, 1280, 5120), (8 * 4096, 1280, 320)} <= eligible
    assert not any(m in (8 * 4126, 8 * 1054, 8 * 64) for m, _, _ in eligible)
