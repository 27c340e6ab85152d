"""K3 (LayerNorm) past C 2048 on the CPU.

The Pallas kernel ``_ln_kernel`` takes any C. The port runs rows up to 2048
wide one warp a row, and wider rows (C 2560 in the middle block of a
``channel_mult`` (1, 2, 4, 8) UNet) on csrc/layer_norm.cu's
``ln_wide_kernel``: one block of 256 threads a row, thread t summing the
row's 16-byte vectors t, t + 256, ... in order, then each warp's butterfly
sum, then the 8 warps' sums in order, for the mean and again for the
centred variance. On a CPU tensor the wrapper takes the plain version, so
here:

* the plain version against ``_ln_pallas`` in interpret mode at C 2176,
  2560, 3840 and 5120 over 8, 64 and 264 rows, f32 (atol 1e-5, as
  tests/test_torch_kernels.py holds the narrower rows) and bf16 (K3's row
  of kernels/tolerance.py); rows x C stays under 2^22, where
  ``layer_norm_fused`` would take ``_ln_reference`` instead;
* which C entry the wrapper launches, on a recording stub of the library;
* an emulation of the block kernel's summation order in f32, which stays
  inside K3's row in both types, and planted faults outside it: the last
  warp's partial sum dropped, the ragged tail vector of C 2056 (257
  vectors of 8 over 256 threads) skipped, an uncentred variance
  (E[x^2] - mean^2) on data shifted by 1000, gamma read one vector off.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops.pallas.norms import _ln_pallas

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.kernels.tolerance import agreement
from torch_kernel_stub import RecordingLib, _check_operand
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

LN = importlib.import_module("layoutllm_t2i_torch.kernels.layer_norm")
ATOL_F32 = 1e-5
# csrc/layer_norm.cu: ln_wide_kernel's threads a row and their warps
THREADS, WARPS = 256, 8
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(rng, rows, c, dtype, shift=0.5, scale=2.0):
    x = rng.standard_normal((rows, c)).astype(np.float32) * scale + shift
    g = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    return [torch.from_numpy(a).to(dtype) for a in (x, g, b)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [8, 64, 264])
@pytest.mark.parametrize("c", [2176, 2560, 3840, 5120])
def test_plain_matches_pallas_past_2048(c, rows, dtype):
    rng = np.random.default_rng(c + rows)
    x, g, b = _inputs(rng, rows, c, dtype)
    assert rows * c <= 1 << 22
    jd = JAX_DTYPE[dtype]
    ref = _ln_pallas(jnp.asarray(x.float().numpy(), jd),
                     jnp.asarray(g.float().numpy(), jd),
                     jnp.asarray(b.float().numpy(), jd), 1e-5, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(dtype)
    out = K.layer_norm(x, g, b, 1e-5)
    assert out.dtype == dtype and K.layer_norm.launches == 0
    if dtype is torch.float32:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL_F32)
    else:
        got = agreement("K3", out, ref)
        assert got["ok"], got


@pytest.mark.parametrize("dtype,vec", [(torch.bfloat16, 8), (torch.float32, 4)])
@pytest.mark.parametrize("c", [8, 2048, 2048 + 8, 2560, 16384])
def test_wrapper_sends_rows_past_2048_to_the_block_kernel(monkeypatch, c, dtype,
                                                          vec):
    """The wrapper's kernel path (taken for CPU tensors here, with a
    recording library): C <= 2048 reaches the one-warp entry, any wider C
    the block entry of the same type, each call one launch (and one f32
    launch in f32); a C off the 16-byte vector still raises."""
    rec = RecordingLib()
    monkeypatch.setattr(LN, "use_kernel", lambda x: True)
    monkeypatch.setattr(LN, "check_operand", _check_operand)
    monkeypatch.setattr(LN, "stream_handle", lambda device: 0)
    monkeypatch.setattr(LN, "lib", lambda name: rec)
    monkeypatch.setattr(LN.layer_norm, "launches", 0)
    monkeypatch.setattr(LN.layer_norm, "f32_launches", 0)
    x, g, b = (torch.zeros(3, c, dtype=dtype), torch.ones(c, dtype=dtype),
               torch.zeros(c, dtype=dtype))
    K.layer_norm(x, g, b, 1e-5)
    f32 = "_f32" if dtype is torch.float32 else ""
    want = (f"llt2i_layer_norm_wide{f32}" if c > 2048
            else f"llt2i_layer_norm{f32}")
    assert rec.calls == [want] == [LN.entry_point(c, dtype)]
    assert K.layer_norm.launches == 1
    assert K.layer_norm.f32_launches == (1 if f32 else 0)
    odd = c + vec // 2
    with pytest.raises(ValueError, match=f"C={odd} is unsupported"):
        K.layer_norm(torch.zeros(3, odd, dtype=dtype), torch.ones(odd, dtype=dtype),
                     torch.zeros(odd, dtype=dtype), 1e-5)
    assert rec.calls == [want]


# ---------------------------------------------------------------------------
# the block kernel's arithmetic


def _thread_sums(v, per_vec, skip_tail=False):
    """(rows, C) f32 -> (rows, THREADS): thread t's sum of its vectors t,
    t + THREADS, ... in order, each vector's values in order (a missing
    vector past the row's end adds 0, which leaves a f32 sum as it is)."""
    rows, c = v.shape
    nv = c // per_vec
    steps = -(-nv // THREADS)
    vv = torch.zeros(rows, steps * THREADS, per_vec)
    vv[:, :nv] = v.reshape(rows, nv, per_vec)
    if skip_tail:
        vv[:, nv - 1] = 0
    vv = vv.view(rows, steps, THREADS, per_vec)
    s = torch.zeros(rows, THREADS)
    for i in range(steps):
        for j in range(per_vec):
            s = s + vv[:, i, :, j]
    return s


def _block_sum(s, drop_warp=False):
    """block_sum: each warp's butterfly (__shfl_xor_sync over 16, 8, 4, 2,
    1; every lane ends with the same value), then the warps' sums in warp
    order; ``drop_warp``: the last warp's left out."""
    s = s.view(s.shape[0], WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, :, torch.arange(32) ^ o]
    t = torch.zeros(s.shape[0])
    for w in range(WARPS - (1 if drop_warp else 0)):
        t = t + s[:, w, 0]
    return t


def _k3_wide_emulated(x, g, b, eps, fault=None):
    """ln_wide_kernel's arithmetic in f32, rounded to x's type at the
    output, with one planted ``fault``."""
    per_vec = 16 // x.element_size()
    c = x.shape[1]
    xf, gf, bf = x.float(), g.float(), b.float()
    tail, drop = fault == "tail_skipped", fault == "warp_dropped"
    mean = (_block_sum(_thread_sums(xf, per_vec, tail), drop) / c)[:, None]
    if fault == "uncentred":
        var = (_block_sum(_thread_sums(xf * xf, per_vec)) / c)[:, None] - mean * mean
    else:
        d = xf - mean
        var = (_block_sum(_thread_sums(d * d, per_vec, tail), drop) / c)[:, None]
    rstd = torch.rsqrt(var + eps)
    if fault == "gamma_off":
        gf = torch.roll(gf, -per_vec)
    y = (xf - mean) * rstd * gf + bf
    if tail:
        y[:, c - per_vec:] = 0   # the output's torch.empty, here zeros
    return y.to(x.dtype)


SHAPES = [(8, 2056), (257, 2560), (64, 5120), (4, 16384)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", SHAPES)
def test_block_kernel_emulation_within_k3(rows, c, dtype):
    x, g, b = _inputs(np.random.default_rng(c), rows, c, dtype)
    got = agreement("K3", _k3_wide_emulated(x, g, b, 1e-5),
                    LN.layer_norm_plain(x, g, b, 1e-5))
    assert got["ok"], got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", ["warp_dropped", "tail_skipped", "uncentred",
                                   "gamma_off"])
def test_block_kernel_faults_fall_outside_k3(fault, dtype):
    """Each planted fault lies outside K3's row, the clean emulation of the
    same inputs inside it. The uncentred variance shows on rows shifted by
    1000 (std 1: E[x^2] - mean^2 cancels in f32); C 2056's last vector is
    the ragged tail, thread 0's second."""
    rows, c = 16, 2056
    shift, scale = (1000.0, 1.0) if fault == "uncentred" else (0.5, 2.0)
    x, g, b = _inputs(np.random.default_rng(7), rows, c, dtype, shift, scale)
    ref = LN.layer_norm_plain(x, g, b, 1e-5)
    assert agreement("K3", _k3_wide_emulated(x, g, b, 1e-5), ref)["ok"]
    got = agreement("K3", _k3_wide_emulated(x, g, b, 1e-5, fault), ref)
    assert not got["ok"], got
