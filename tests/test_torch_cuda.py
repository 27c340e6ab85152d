"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``: they carry the
``cuda`` marker and skip where no CUDA device is present. They cover edge
cases the main-path shapes of ``chip_smoke.py`` do not reach: ragged tails
off the block sizes, strided attention operands, odd group widths, wide and
narrow LayerNorm rows, a partial FF row block. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine need not have). Tolerance: the one ``chip_smoke.py`` states,
from ``layoutllm_t2i_torch/kernels/tolerance.py``.
"""
import pytest
import torch

from layoutllm_t2i_torch import kernels as K
from layoutllm_t2i_torch.kernels.tolerance import agreement

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (Hopper, sm_90)")
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return g


def _rand(gen, *shape, scale=1.0, shift=0.0):
    t = torch.randn(*shape, generator=gen, device=gen.device) * scale + shift
    return t.to(torch.bfloat16)


def _check(kid, kernel_fn, plain_fn, counter):
    before = counter.launches
    out = kernel_fn()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    got = agreement(kid, out, plain_fn())
    assert got["ok"], got


@pytest.mark.parametrize("b,n,m,heads,d", [
    (1, 600, 630, 2, 40),     # ragged q and kv tails, padded head dim
    (2, 513, 129, 8, 80),     # one row past a q block, one past a kv block
    (1, 512, 700, 2, 80),
    (1, 520, 600, 1, 512),    # the VAE's single wide head
])
def test_flash_attention(dev, gen, b, n, m, heads, d):
    q = _rand(gen, b, n, heads * d)
    k = _rand(gen, b, m, heads * d)
    v = _rand(gen, b, m, heads * d)
    s = d ** -0.5
    _check("K1", lambda: K.flash_attention(q, k, v, heads, s),
           lambda: K.flash_attention_plain(q, k, v, heads, s), K.flash_attention)


def test_flash_attention_strided_operands(dev, gen):
    b, n, heads, d = 2, 640, 4, 40
    qkv = _rand(gen, b, n, 3 * heads * d)   # q, k, v as column slices
    q, k, v = qkv.split(heads * d, dim=-1)
    _check("K1", lambda: K.flash_attention(q, k, v, heads, 0.2),
           lambda: K.flash_attention_plain(q, k, v, heads, 0.2), K.flash_attention)


def test_flash_attention_uninstantiated_head_dim_raises(dev, gen):
    # d = 160 (the 16^2 sites) stays on the plain path: no instantiation
    q = _rand(gen, 1, 512, 2 * 160)
    before = K.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.flash_attention(q, q, q, 2, 160 ** -0.5)
    assert K.flash_attention.launches == before


@pytest.mark.parametrize("n,hw,c,groups", [
    (3, 49, 96, 32),       # three channels a group, ragged row chunks
    (1, 4096, 64, 32),
    (2, 1, 2560, 32),      # one row
    (1, 16384, 128, 8),
])
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm(dev, gen, n, hw, c, groups, silu):
    x = _rand(gen, n, hw, c, scale=3.0, shift=1.5)
    w, bias = _rand(gen, c, scale=0.5, shift=1.0), _rand(gen, c, scale=0.5)
    _check("K2", lambda: K.group_norm(x, w, bias, groups, 1e-6, silu),
           lambda: K.group_norm_plain(x, w, bias, groups, 1e-6, silu), K.group_norm)


@pytest.mark.parametrize("rows,c", [(1, 8), (7, 1000), (33, 2048), (4126, 320)])
def test_layer_norm(dev, gen, rows, c):
    x = _rand(gen, rows, c, scale=2.0, shift=0.5)
    w, bias = _rand(gen, c, scale=0.5, shift=1.0), _rand(gen, c, scale=0.5)
    _check("K3", lambda: K.layer_norm(x, w, bias, 1e-5),
           lambda: K.layer_norm_plain(x, w, bias, 1e-5), K.layer_norm)


@pytest.mark.parametrize("m,k", [(100, 320), (64, 72), (130, 640)])
@pytest.mark.parametrize("scale", [1.0, "tensor"])
def test_ffn_ln_geglu(dev, gen, m, k, scale):
    inner = 4 * k
    x = _rand(gen, m, k)
    lw, lb = _rand(gen, k, scale=0.2, shift=1.0), _rand(gen, k, scale=0.2)
    w1, b1 = _rand(gen, 2 * inner, k, scale=k ** -0.5), _rand(gen, 2 * inner, scale=0.1)
    w2, b2 = _rand(gen, k, inner, scale=inner ** -0.5), _rand(gen, k, scale=0.1)
    s = torch.tensor(0.37, device=dev) if scale == "tensor" else scale
    _check("K4", lambda: K.ffn_ln_geglu(x, lw, lb, w1, b1, w2, b2, s),
           lambda: K.ffn_ln_geglu_plain(x, lw, lb, w1, b1, w2, b2, s), K.ffn_ln_geglu)


def test_cuda_tensor_never_takes_the_plain_version(dev):
    x = torch.randn(4, 16, device=dev)  # f32: no kernel takes it
    with pytest.raises(ValueError, match="dtype"):
        K.layer_norm(x, torch.ones(16, device=dev), torch.zeros(16, device=dev))
