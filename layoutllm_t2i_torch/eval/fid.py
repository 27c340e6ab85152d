"""FID: InceptionV3 pool3 features and the Fréchet distance
(layoutllm_t2i_tpu/eval/fid.py).

  * ``inception_pool3``: torchvision's ``inception_v3`` graph up to the
    2048-d pool3 features, as pure functions over a parameter tree keyed by
    the torchvision state_dict names (``Conv2d_1a_3x3.conv.weight``,
    ``Mixed_5b.branch1x1.bn.running_mean``, ...), so pytorch-fid's
    pt_inception or torchvision's weights load strictly by name
    (``load_inception_checkpoint``). Images are NHWC at the public
    functions, as in the JAX package; inside, NCHW in channels_last memory.
  * The 3x3 average pools divide by the count of valid cells
    (``count_include_pad=False``, as the JAX package's ``_avgpool3x3s1p1``
    and pytorch-fid's FID blocks do; torchvision's default counts the
    padding and drifts at the borders). Batch norm is in f32 with eps 1e-3.
  * The network runs in f32 with TF32 off: cuDNN's convolutions would
    otherwise take f32 operands through TF32 on the card
    (``torch.backends.cudnn.allow_tf32``, on by default), so the flag is
    turned off for the forward and restored after it, as the port's other
    f32 paths run with ``allow_tf32`` off. The convolutions stay cuDNN's:
    the JAX package computes them with ``lax.conv``, outside any Pallas
    kernel.
  * ``compute_stats``, ``frechet_distance`` (scipy ``sqrtm`` on the host,
    with pytorch-fid's eps retry) and ``fid_score`` are host copies.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..models.initializers import Init
from ..utils.trees import ParamTree

FEATURE_DIM = 2048
INCEPTION_SIZE = 299

# ---------------------------------------------------------------------------
# InceptionV3 (torchvision graph, aux logits unused for features)


@contextlib.contextmanager
def no_tf32():
    """cuDNN's f32 convolutions in f32, for the duration."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _bn(p, x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    c = (1, -1, 1, 1)
    mean = p["running_mean"].float().view(c)
    var = p["running_var"].float().view(c)
    w = p["weight"].float().view(c)
    b = p["bias"].float().view(c)
    y = (x.float() - mean) * torch.rsqrt(var + eps) * w + b
    return y.to(x.dtype)


def _basic_conv(p, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
    """padding: an int or (rows, columns)."""
    x = F.conv2d(x, p["conv"]["weight"].to(x.dtype), stride=stride,
                 padding=padding)
    return F.relu(_bn(p["bn"], x))


def _maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)  # VALID


def _avgpool3x3s1p1(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _cat(xs) -> torch.Tensor:
    return torch.cat(xs, dim=1)


def _inception_a(p, x):
    b1 = _basic_conv(p["branch1x1"], x)
    b5 = _basic_conv(p["branch5x5_1"], x)
    b5 = _basic_conv(p["branch5x5_2"], b5, padding=2)
    b3 = _basic_conv(p["branch3x3dbl_1"], x)
    b3 = _basic_conv(p["branch3x3dbl_2"], b3, padding=1)
    b3 = _basic_conv(p["branch3x3dbl_3"], b3, padding=1)
    bp = _basic_conv(p["branch_pool"], _avgpool3x3s1p1(x))
    return _cat([b1, b5, b3, bp])


def _inception_b(p, x):
    b3 = _basic_conv(p["branch3x3"], x, stride=2)
    bd = _basic_conv(p["branch3x3dbl_1"], x)
    bd = _basic_conv(p["branch3x3dbl_2"], bd, padding=1)
    bd = _basic_conv(p["branch3x3dbl_3"], bd, stride=2)
    return _cat([b3, bd, _maxpool3x3s2(x)])


def _inception_c(p, x):
    pad17, pad71 = (0, 3), (3, 0)
    b1 = _basic_conv(p["branch1x1"], x)
    b7 = _basic_conv(p["branch7x7_1"], x)
    b7 = _basic_conv(p["branch7x7_2"], b7, padding=pad17)
    b7 = _basic_conv(p["branch7x7_3"], b7, padding=pad71)
    bd = _basic_conv(p["branch7x7dbl_1"], x)
    bd = _basic_conv(p["branch7x7dbl_2"], bd, padding=pad71)
    bd = _basic_conv(p["branch7x7dbl_3"], bd, padding=pad17)
    bd = _basic_conv(p["branch7x7dbl_4"], bd, padding=pad71)
    bd = _basic_conv(p["branch7x7dbl_5"], bd, padding=pad17)
    bp = _basic_conv(p["branch_pool"], _avgpool3x3s1p1(x))
    return _cat([b1, b7, bd, bp])


def _inception_d(p, x):
    b3 = _basic_conv(p["branch3x3_1"], x)
    b3 = _basic_conv(p["branch3x3_2"], b3, stride=2)
    b7 = _basic_conv(p["branch7x7x3_1"], x)
    b7 = _basic_conv(p["branch7x7x3_2"], b7, padding=(0, 3))
    b7 = _basic_conv(p["branch7x7x3_3"], b7, padding=(3, 0))
    b7 = _basic_conv(p["branch7x7x3_4"], b7, stride=2)
    return _cat([b3, b7, _maxpool3x3s2(x)])


def _inception_e(p, x):
    b1 = _basic_conv(p["branch1x1"], x)
    b3 = _basic_conv(p["branch3x3_1"], x)
    b3 = _cat([_basic_conv(p["branch3x3_2a"], b3, padding=(0, 1)),
               _basic_conv(p["branch3x3_2b"], b3, padding=(1, 0))])
    bd = _basic_conv(p["branch3x3dbl_1"], x)
    bd = _basic_conv(p["branch3x3dbl_2"], bd, padding=1)
    bd = _cat([_basic_conv(p["branch3x3dbl_3a"], bd, padding=(0, 1)),
               _basic_conv(p["branch3x3dbl_3b"], bd, padding=(1, 0))])
    bp = _basic_conv(p["branch_pool"], _avgpool3x3s1p1(x))
    return _cat([b1, b3, bd, bp])


@torch.no_grad()
def inception_pool3(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 299, 299, 3) in [-1, 1] -> (B, 2048) pool3 features, in f32
    with TF32 off."""
    x = x.float().permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with no_tf32():
        x = _basic_conv(params["Conv2d_1a_3x3"], x, stride=2)
        x = _basic_conv(params["Conv2d_2a_3x3"], x)
        x = _basic_conv(params["Conv2d_2b_3x3"], x, padding=1)
        x = _maxpool3x3s2(x)
        x = _basic_conv(params["Conv2d_3b_1x1"], x)
        x = _basic_conv(params["Conv2d_4a_3x3"], x)
        x = _maxpool3x3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _inception_a(params[name], x)
        x = _inception_b(params["Mixed_6a"], x)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _inception_c(params[name], x)
        x = _inception_d(params["Mixed_7a"], x)
        x = _inception_e(params["Mixed_7b"], x)
        x = _inception_e(params["Mixed_7c"], x)
    return torch.mean(x, dim=(2, 3))  # adaptive avg pool -> (B, 2048)


# -- init (random; real FID weights load by name) ----------------------------


def _init_basic_conv(ini: Init, kh, kw, cin, cout):
    return {
        "conv": {"weight": ini.normal((cout, cin, kh, kw), 0.05)},
        "bn": {"weight": ini.full((cout,), 1.0), "bias": ini.full((cout,), 0.0),
               "running_mean": ini.full((cout,), 0.0),
               "running_var": ini.full((cout,), 1.0)},
    }


def init_inception_params(ini: Init):
    """The torchvision inception_v3 feature tree (no fc, no AuxLogits), conv
    weights N(0, 0.05) as the JAX package's init, BN at identity."""
    bc = lambda kh, kw, ci, co: _init_basic_conv(ini, kh, kw, ci, co)
    p = {
        "Conv2d_1a_3x3": bc(3, 3, 3, 32),
        "Conv2d_2a_3x3": bc(3, 3, 32, 32),
        "Conv2d_2b_3x3": bc(3, 3, 32, 64),
        "Conv2d_3b_1x1": bc(1, 1, 64, 80),
        "Conv2d_4a_3x3": bc(3, 3, 80, 192),
    }

    def inc_a(cin, pool):
        return {
            "branch1x1": bc(1, 1, cin, 64),
            "branch5x5_1": bc(1, 1, cin, 48), "branch5x5_2": bc(5, 5, 48, 64),
            "branch3x3dbl_1": bc(1, 1, cin, 64),
            "branch3x3dbl_2": bc(3, 3, 64, 96),
            "branch3x3dbl_3": bc(3, 3, 96, 96),
            "branch_pool": bc(1, 1, cin, pool),
        }

    def inc_c(cin, c7):
        return {
            "branch1x1": bc(1, 1, cin, 192),
            "branch7x7_1": bc(1, 1, cin, c7), "branch7x7_2": bc(1, 7, c7, c7),
            "branch7x7_3": bc(7, 1, c7, 192),
            "branch7x7dbl_1": bc(1, 1, cin, c7),
            "branch7x7dbl_2": bc(7, 1, c7, c7),
            "branch7x7dbl_3": bc(1, 7, c7, c7),
            "branch7x7dbl_4": bc(7, 1, c7, c7),
            "branch7x7dbl_5": bc(1, 7, c7, 192),
            "branch_pool": bc(1, 1, cin, 192),
        }

    def inc_e(cin):
        return {
            "branch1x1": bc(1, 1, cin, 320),
            "branch3x3_1": bc(1, 1, cin, 384),
            "branch3x3_2a": bc(1, 3, 384, 384), "branch3x3_2b": bc(3, 1, 384, 384),
            "branch3x3dbl_1": bc(1, 1, cin, 448),
            "branch3x3dbl_2": bc(3, 3, 448, 384),
            "branch3x3dbl_3a": bc(1, 3, 384, 384),
            "branch3x3dbl_3b": bc(3, 1, 384, 384),
            "branch_pool": bc(1, 1, cin, 192),
        }

    p["Mixed_5b"] = inc_a(192, 32)
    p["Mixed_5c"] = inc_a(256, 64)
    p["Mixed_5d"] = inc_a(288, 64)
    p["Mixed_6a"] = {
        "branch3x3": bc(3, 3, 288, 384),
        "branch3x3dbl_1": bc(1, 1, 288, 64),
        "branch3x3dbl_2": bc(3, 3, 64, 96),
        "branch3x3dbl_3": bc(3, 3, 96, 96),
    }
    p["Mixed_6b"] = inc_c(768, 128)
    p["Mixed_6c"] = inc_c(768, 160)
    p["Mixed_6d"] = inc_c(768, 160)
    p["Mixed_6e"] = inc_c(768, 192)
    p["Mixed_7a"] = {
        "branch3x3_1": bc(1, 1, 768, 192), "branch3x3_2": bc(3, 3, 192, 320),
        "branch7x7x3_1": bc(1, 1, 768, 192),
        "branch7x7x3_2": bc(1, 7, 192, 192),
        "branch7x7x3_3": bc(7, 1, 192, 192),
        "branch7x7x3_4": bc(3, 3, 192, 192),
    }
    p["Mixed_7b"] = inc_e(1280)
    p["Mixed_7c"] = inc_e(2048)
    return p


def random_inception(device: DeviceLike = None, seed: int = 0) -> ParamTree:
    """A random-init Inception on ``device`` (None: the card), f32."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return ParamTree(init_inception_params(Init(gen, dev, torch.float32)))


def load_inception_checkpoint(path: str, device: DeviceLike = None) -> ParamTree:
    """A torchvision/pytorch-fid ``inception_v3`` .pth (a state_dict or a
    module) -> the feature tree in f32 on ``device`` (None: the card),
    strictly by name: a missing, extra or misshapen tensor raises. fc,
    AuxLogits and the BN step counters are dropped: the feature path reads
    none of them."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("fc.", "AuxLogits."))
          and not k.endswith("num_batches_tracked")}
    module = ParamTree(init_inception_params(Init(None, torch.device("meta"))))
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device=dev, dtype=torch.float32)


# ---------------------------------------------------------------------------
# features + Frechet distance


def resize_bilinear(images01: torch.Tensor, size: int = INCEPTION_SIZE) -> torch.Tensor:
    """(B, H, W, 3) -> (B, size, size, 3). ``jax.image.resize(...,
    "bilinear")`` antialiases when it shrinks (the triangle kernel
    stretched by the scale, over the input's valid pixels, renormalized);
    PyTorch's bilinear matches it with ``antialias=True``."""
    x = F.interpolate(images01.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1)


def inception_features(params, images01: np.ndarray, batch: int = 16) -> np.ndarray:
    """images01: (N, H, W, 3) float in [0, 1] -> (N, 2048) f32 features on
    the host, computed on the params' device. Bilinear-resized to 299 and
    scaled to [-1, 1] (pytorch-fid preprocessing)."""
    dev = next(iter(params.parameters())).device
    feats = []
    for i in range(0, len(images01), batch):
        chunk = torch.as_tensor(np.asarray(images01[i:i + batch], np.float32),
                                device=dev)
        chunk = resize_bilinear(chunk) * 2.0 - 1.0
        feats.append(inception_pool3(params, chunk).cpu().numpy())
    return np.concatenate(feats, axis=0)


def compute_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}); standard eps jitter when
    the product is singular (same guard as pytorch-fid). ``sqrtm`` is called
    without ``disp``, which only chose between printing and returning its
    error estimate and is deprecated in SciPy 1.17: the same matrix."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_score(features_a: np.ndarray, features_b: np.ndarray) -> float:
    return frechet_distance(*compute_stats(features_a),
                            *compute_stats(features_b))
