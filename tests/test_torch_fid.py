"""The port's eval/fid.py against the JAX package's, on the CPU.

* ``compute_stats``, ``frechet_distance`` and ``fid_score``: host float64
  on both sides, within 1e-12 relative, on well-conditioned features and on
  a singular covariance that takes the eps retry.
* ``inception_pool3``: JAX weights of ``init_inception_params``' tree
  (shapes from ``jax.eval_shape``; conv weights N(0, 0.05) and BN
  statistics drawn with a numpy seed, so batch norm is not the identity)
  carried over with checkpoint/from_jax.py, within 1e-4 of max |ref| at
  107² (the graph takes 75² and up). The full 299² parity, and
  ``inception_features``, which resizes to 299², are marked slow. A planted ``count_include_pad=True`` in the 3x3
  average pools (torchvision's default) fails that bound.
* The 512 -> 299 bilinear resize within 1e-5 of ``jax.image.resize``.
* A torchvision-named ``.pth`` (with fc, AuxLogits and num_batches_tracked
  entries) loads strictly and equals JAX's ``load_inception_checkpoint``
  tree; a missing tensor raises. ``compute_fid`` refuses a random Inception.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.eval import fid as jfid

from layoutllm_t2i_torch.checkpoint.from_jax import (inception_params_from_jax,
                                                     torch_layout)
from layoutllm_t2i_torch.eval import fid as pfid
from layoutllm_t2i_torch.eval.nss1k import compute_fid
from layoutllm_t2i_torch.utils.trees import flatten_tree
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REL_TOL = 1e-12
FEATURE_TOL = 1e-4  # of max |ref|


def _close(a, b):
    assert abs(a - b) <= REL_TOL * max(abs(b), 1e-300), (a, b)


def test_stats_and_frechet_equal_jax(rng):
    fa = rng.standard_normal((300, 16))
    fb = 0.5 + 1.3 * rng.standard_normal((250, 16))
    (mu_p, s_p), (mu_j, s_j) = pfid.compute_stats(fa), jfid.compute_stats(fa)
    np.testing.assert_array_equal(mu_p, mu_j)
    np.testing.assert_array_equal(s_p, s_j)
    got = pfid.frechet_distance(mu_p, s_p, *pfid.compute_stats(fb))
    _close(got, jfid.frechet_distance(mu_j, s_j, *jfid.compute_stats(fb)))
    _close(pfid.fid_score(fa, fb), jfid.fid_score(fa, fb))
    assert pfid.fid_score(fa, fa) < 1e-8 < pfid.fid_score(fa, fb)


def test_singular_covariance_takes_the_eps_path(monkeypatch):
    """Two samples of 3-d features a set: rank-1 covariances whose product
    has sqrtm not finite, so both retry with eps on the diagonal, and
    agree."""
    from scipy import linalg

    fa = np.array([[-2.0, 0.0, 0.0], [2.0, 0.0, -1.0]])
    fb = np.array([[0.0, -2.0, -2.0], [2.0, 1.0, -1.0]])
    results = []
    sqrtm = linalg.sqrtm
    monkeypatch.setattr(linalg, "sqrtm", lambda a, *args, **kw: (
        results.append(np.asarray(sqrtm(a)).copy()), sqrtm(a, *args, **kw))[1])
    got = pfid.fid_score(fa, fb)
    assert len(results) == 2 and not np.isfinite(results[0]).all(), (
        "the eps retry did not run")
    _close(got, jfid.fid_score(fa, fb))
    assert np.isfinite(got)


def _jax_weights(seed=0):
    """init_inception_params' tree (HWIO convs, 1-D BN leaves) with numpy
    values: conv N(0, 0.05), BN weight 1 +- 0.1, bias and running mean
    N(0, 0.1), running var in [0.5, 1.5]."""
    shapes = jax.eval_shape(jfid.init_inception_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "running_var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("bias", "running_mean"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        scale = 0.05 if len(s.shape) == 4 else 0.1
        base = 1.0 if len(s.shape) == 1 else 0.0
        return (base + scale * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def weights():
    jw = _jax_weights()
    return jw, inception_params_from_jax(jw, device="cpu")


def _features(weights, size, seed=1):
    jw, pw = weights
    x = np.random.default_rng(seed).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jfid.inception_pool3)(jw, jnp.asarray(x)))
    return ref, pw, torch.from_numpy(x)


def _rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_inception_pool3_matches_jax(weights, monkeypatch):
    ref, pw, x = _features(weights, 107)
    got = pfid.inception_pool3(pw, x).numpy()
    assert got.shape == ref.shape == (2, pfid.FEATURE_DIM)
    assert got.dtype == np.float32
    err = _rel_err(got, ref)
    assert err <= FEATURE_TOL, err
    # torchvision's default average pool counts the zero padding
    monkeypatch.setattr(pfid, "_avgpool3x3s1p1", lambda t: torch.nn.functional.avg_pool2d(
        t, 3, stride=1, padding=1, count_include_pad=True))
    planted = _rel_err(pfid.inception_pool3(pw, x).numpy(), ref)
    assert planted > FEATURE_TOL, planted


@pytest.mark.slow
def test_inception_pool3_matches_jax_at_299(weights):
    ref, pw, x = _features(weights, pfid.INCEPTION_SIZE)
    err = _rel_err(pfid.inception_pool3(pw, x).numpy(), ref)
    assert err <= FEATURE_TOL, err


@pytest.mark.parametrize("side", [512, 16])
def test_resize_matches_jax_image_resize(side, rng):
    """Down from the generation size (antialiased in JAX) and up from the
    tiny models' 16²."""
    x = rng.uniform(0, 1, (2, side, side, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    got = pfid.resize_bilinear(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - ref).max()) <= 1e-5


@pytest.mark.slow
def test_inception_features_match_jax(weights):
    jw, pw = weights
    imgs = np.random.default_rng(2).uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    ref = jfid.inception_features(jw, imgs, batch=2)
    got = pfid.inception_features(pw, imgs, batch=2)
    assert got.shape == (3, pfid.FEATURE_DIM)
    assert _rel_err(got, ref) <= FEATURE_TOL


def test_torchvision_checkpoint_loads_strictly(tmp_path):
    sd = pfid.random_inception("cpu", seed=3).state_dict()
    full = dict(sd)
    full["fc.weight"] = torch.zeros(1000, 2048)
    full["fc.bias"] = torch.zeros(1000)
    full["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    for k in list(sd):
        if k.endswith("running_var"):
            full[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "pt_inception.pth"
    torch.save(full, path)
    got = pfid.load_inception_checkpoint(str(path), device="cpu").state_dict()
    want = flatten_tree(jfid.load_inception_checkpoint(str(path)))
    assert set(got) == set(want) == set(sd)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), torch_layout(k, v), err_msg=k)
        assert got[k].dtype == torch.float32
    # a module saved whole loads the same
    torch.save(pfid.random_inception("cpu", seed=3), tmp_path / "module.pth")
    again = pfid.load_inception_checkpoint(str(tmp_path / "module.pth"), device="cpu")
    assert all(torch.equal(again.state_dict()[k], got[k]) for k in got)
    del full["Mixed_7c.branch_pool.bn.running_var"]
    torch.save(full, path)
    with pytest.raises(RuntimeError, match="running_var"):
        pfid.load_inception_checkpoint(str(path), device="cpu")


def test_compute_fid_refuses_a_random_inception():
    imgs = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="Refusing to score"):
        compute_fid(imgs, imgs, inception_ckpt=None, reward_model=None,
                    device="cpu")
