"""The port's parallel/ generation paths at world 2 against the JAX package.

Two ranks of ``tests/torch_parallel_worker.py`` (job ``jax``, gloo on the
CPU, one torch thread each) run once for the module, while this process
computes the JAX side on conftest's 8 virtual devices: ``sample_latents_tp``
('heads', 'spatial') on ``tp_mesh(2)`` and ``sample_latents_sharded`` on
``make_mesh(2)``, on the same small bundle (every fuser gate opened), the
same conditioning and the same numpy noise; the same request's
``sample_latents_tp`` (both styles) on the bundle's int8 UNet with
DPM-Solver++, the guidance interval and the encoder cache (tests/
test_tp.py:152-168's composition). The port's images must meet
``tests/parity_setup.py``'s image gates against the JAX package's, and
match the port's own single-process ``sample_latents`` within max-abs 2e-4
(the JAX test's own bound, tests/test_tp.py:41). Under 'spatial':
``attention_with_projections`` at B1 N1024 H2 C40 D64 against JAX
``impl="xla"`` at 2e-5 (tests/test_tp.py:118-149), the row-split
GroupNorm's statistics and stride-1 and stride-2 convolutions at 1 and 2
rows a rank against the JAX ops; under 'heads' the GEGLU FF through K6's
route on a rank's inner slice against JAX ``geglu_ff``. ZeRO-1's rule
against JAX ``zero1_sharding``.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.ops import attention as jattn
from layoutllm_t2i_tpu.ops import nn as jnn
from layoutllm_t2i_tpu.parallel.mesh import make_mesh as jax_make_mesh
from layoutllm_t2i_tpu.parallel.mesh import zero1_sharding as jax_zero1
from layoutllm_t2i_tpu.parallel.tp import tp_mesh as jax_tp_mesh
from layoutllm_t2i_tpu.pipeline.inference import InferencePipeline as JaxPipeline
from layoutllm_t2i_tpu.pipeline.loaders import quantize_unet_int8 as jax_int8
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models

from parity_setup import PSNR_GATE_DB, SSIM_GATE, psnr, ssim

from layoutllm_t2i_torch.checkpoint.from_jax import load_from_jax
from layoutllm_t2i_torch.parallel.mesh import Mesh, zero1_dim, zero1_sharding
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.pipeline.loaders import quantize_unet_int8, random_models
from torch_parallel_worker import COMPOSE, spawn_world, wait_world
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SINGLE_TOL = 2e-4   # tests/test_tp.py:41
ATTN_TOL = 2e-5     # tests/test_tp.py:149
OP_TOL = 1e-5
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
COND1 = (["a dog next to a cat"],
         [([[0.1, 0.1, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9]], ["dog", "cat"])],
         [["dog next to cat"]])
COND2 = (["a dog chasing a ball", "a cat on a chair"],
         [([[0.1, 0.4, 0.5, 0.9]], ["a dog"]),
          ([[0.2, 0.1, 0.6, 0.6], [0.1, 0.5, 0.7, 0.95]], ["a cat", "a chair"])],
         [["dog chasing ball"], ["cat on chair"]])


def _open_gates(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            _open_gates(v)
        elif k in ("alpha_attn", "alpha_dense"):
            tree[k] = np.asarray(0.5, np.float32)


def _port_cond(cond_j):
    return {k: torch.from_numpy(np.array(v)) for k, v in cond_j.items()}


def _conv_case(rng, h, stride):
    x = rng.standard_normal((2, 16, h, h)).astype(np.float32)
    w = rng.standard_normal((16, 16, 3, 3)).astype(np.float32) * 0.2
    b = rng.standard_normal(16).astype(np.float32)
    port = {"x": torch.from_numpy(x).contiguous(memory_format=torch.channels_last),
            "p": {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)},
            "stride": stride}
    jax_p = {"weight": jnp.asarray(w.transpose(2, 3, 1, 0)), "bias": jnp.asarray(b)}
    ref = np.asarray(jnn.conv2d(jax_p, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                stride=stride))
    return port, ref.transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the two ranks, compute the JAX side meanwhile; returns
    (the ranks' results, the JAX results, the port's single-process
    images)."""
    d = tmp_path_factory.mktemp("parallel")
    jm = jax_random_models(seed=0, small=True)
    _open_gates(jm.unet_params)
    pm = random_models(small=True, device="cpu", seed=1)
    for name in ("unet_params", "vae_params", "clip_params"):
        load_from_jax(getattr(pm, name), getattr(jm, name))
    torch.save({name: getattr(pm, name).state_dict()
                for name in ("unet_params", "vae_params", "clip_params")},
               d / "weights.pt")
    jp = JaxPipeline(jm, steps=2, guidance_scale=7.5)
    rng = np.random.default_rng(0)
    cond1, cond2 = jp.build_cond(*COND1), jp.build_cond(*COND2)
    noise1 = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    noise2 = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)

    # attention_with_projections, B1 N1024 H2 C40 D64 (tests/test_tp.py:124)
    b, n, h, c, dm = 1, 1024, 2, 40, 64
    x = rng.standard_normal((b, n, dm)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.1
          for s in ((dm, h * c),) * 3 + ((h * c, dm),)]
    bo = rng.standard_normal(dm).astype(np.float32) * 0.1
    pj = {"to_q": {"weight": jnp.asarray(ws[0])},
          "to_k": {"weight": jnp.asarray(ws[1])},
          "to_v": {"weight": jnp.asarray(ws[2])},
          "to_out": {"0": {"weight": jnp.asarray(ws[3]), "bias": jnp.asarray(bo)}}}
    pt = {k: {"weight": torch.from_numpy(w.T.copy())}
          for k, w in zip(("to_q", "to_k", "to_v"), ws)}
    pt["to_out"] = {"0": {"weight": torch.from_numpy(ws[3].T.copy()),
                          "bias": torch.from_numpy(bo)}}

    convs, conv_refs = {}, {}
    for name, hh, stride in (("s2_1row", 2, 2), ("s2_2rows", 4, 2),
                             ("s1_4rows", 8, 1)):
        convs[name], conv_refs[name] = _conv_case(rng, hh, stride)
    gx = rng.standard_normal((2, 64, 8, 8)).astype(np.float32) * 3 + 1
    gw, gb = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    # a GEGLU FF K6 is eligible for at a rank's inner slice: M 1024, K 128,
    # inner 512 (256 a rank)
    fk, fi = 128, 512
    fx = rng.standard_normal((1, 1024, fk)).astype(np.float32)
    fw = [rng.standard_normal(s).astype(np.float32) * s[0] ** -0.5
          for s in ((fk, 2 * fi), (fi, fk))]
    fb = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (2 * fi, fk)]
    fp = {"net": {"0": {"proj": {"weight": fw[0], "bias": fb[0]}},
                  "2": {"weight": fw[1], "bias": fb[1]}}}
    torch.save({
        "cond1": _port_cond(cond1), "cond2": _port_cond(cond2),
        "noise1": torch.from_numpy(noise1), "noise2": torch.from_numpy(noise2),
        "attention": {"x": torch.from_numpy(x), "p": pt, "heads": h},
        "convs": convs,
        "group_norm": {"x": torch.from_numpy(gx).contiguous(
                           memory_format=torch.channels_last),
                       "p": {"weight": torch.from_numpy(gw),
                             "bias": torch.from_numpy(gb)},
                       "groups": 32, "eps": 1e-6},
        "ff": {"x": torch.from_numpy(fx),
               "p": {"net": {"0": {"proj": {
                   "weight": torch.from_numpy(fw[0].T.copy()),
                   "bias": torch.from_numpy(fb[0])}},
                   "2": {"weight": torch.from_numpy(fw[1].T.copy()),
                         "bias": torch.from_numpy(fb[1])}}}},
    }, d / "inputs.pt")
    procs = spawn_world([WORKER, "jax", str(d)])
    try:
        jax_out = {style: np.asarray(jp.sample_latents_tp(
            jax_tp_mesh(2), cond1, jnp.asarray(noise1), style=style))
            for style in ("heads", "spatial")}
        jax_out["sharded"] = np.asarray(jp.sample_latents_sharded(
            jax_make_mesh(2), cond2, jnp.asarray(noise2)))
        jq = JaxPipeline(jax_int8(jm, min_size=128), **COMPOSE)
        for style in ("heads", "spatial"):
            jax_out[f"compose_{style}"] = np.asarray(jq.sample_latents_tp(
                jax_tp_mesh(2), cond1, jnp.asarray(noise1), style=style))
        jax_out["ff_heads"] = np.asarray(jnn.geglu_ff(
            jax.tree_util.tree_map(jnp.asarray, fp), jnp.asarray(fx)))
        jax_out["attention"] = np.asarray(jax.jit(
            lambda x: jattn.attention_with_projections(pj, x, x, x, h,
                                                       impl="xla"))(x))
        jax_out.update({f"conv_{k}": v for k, v in conv_refs.items()})
        jg = jnn.group_norm({"weight": jnp.asarray(gw), "bias": jnp.asarray(gb)},
                            jnp.asarray(gx.transpose(0, 2, 3, 1)), 32, 1e-6,
                            silu=True)
        jax_out["group_norm"] = np.asarray(jg).transpose(0, 3, 1, 2)
        pp = InferencePipeline(pm, steps=2, guidance_scale=7.5)
        single = {"heads": pp.sample_latents(_port_cond(cond1), noise1).numpy(),
                  "sharded": pp.sample_latents(_port_cond(cond2),
                                               noise2).numpy()}
        single["spatial"] = single["heads"]
        pq = InferencePipeline(quantize_unet_int8(pm, min_size=128), **COMPOSE)
        single["compose_heads"] = single["compose_spatial"] = pq.sample_latents(
            _port_cond(cond1), noise1).numpy()
        wait_world(procs, timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # written by the ranks just now
    return torch.load(d / "jax.pt", weights_only=False), jax_out, single


PATHS = ["heads", "spatial", "sharded", "compose_heads", "compose_spatial"]


@pytest.mark.parametrize("path", PATHS)
def test_world2_images_meet_the_gates_against_jax(world, path):
    port, jax_out, _ = world
    img = port[path].numpy()
    assert img.shape == jax_out[path].shape and np.isfinite(img).all()
    for a, b in zip(img, jax_out[path]):
        assert psnr(a, b) >= PSNR_GATE_DB
        assert ssim(a, b) >= SSIM_GATE


@pytest.mark.parametrize("path", PATHS)
def test_world2_images_match_one_process(world, path):
    port, _, single = world
    np.testing.assert_allclose(port[path].numpy(), single[path], atol=SINGLE_TOL)


def test_spatial_attention_n1024_matches_jax_xla(world):
    port, jax_out, _ = world
    np.testing.assert_allclose(port["attention"].numpy(), jax_out["attention"],
                               atol=ATTN_TOL)


def test_row_split_group_norm_statistics_match_jax(world):
    port, jax_out, _ = world
    assert port["group_norm_split"]
    np.testing.assert_allclose(port["group_norm"].numpy(), jax_out["group_norm"],
                               atol=OP_TOL, rtol=OP_TOL)


@pytest.mark.parametrize("name,split", [("s2_1row", False), ("s2_2rows", True),
                                        ("s1_4rows", True)])
def test_row_split_convolutions_match_jax(world, name, split):
    """A stride-2 convolution at 1 row a rank stays whole on every rank
    (tests/test_tp.py:94's hazard, kept by the min_per_shard rule); at 2
    rows it splits and takes one halo row from the rank above."""
    port, jax_out, _ = world
    assert port[f"conv_{name}_split"] is split
    np.testing.assert_allclose(port[f"conv_{name}"].numpy(),
                               jax_out[f"conv_{name}"], atol=OP_TOL, rtol=OP_TOL)


def test_heads_ff_through_k6_route_matches_jax(world):
    """Under 'heads' a rank's FF partial takes K6 (zero residual and
    bias) where the card would; the all-reduced result against JAX's
    dense geglu_ff."""
    port, jax_out, _ = world
    assert port["ff_heads_k6"] == [(128, 256)]     # w2's slice: K x inner/2
    np.testing.assert_allclose(port["ff_heads"].numpy(), jax_out["ff_heads"],
                               atol=OP_TOL, rtol=OP_TOL)


SHAPES = {"a": (8, 4), "b": (3, 5), "c": (2, 2), "d": (16,), "e": (4, 16, 2),
          "f": (6, 10), "g": ()}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero1_rule_matches_jax(n):
    """The dimension each leaf's optimizer state splits along: JAX
    ``zero1_sharding``'s spec on make_mesh(n), the port's shape rule."""
    tree = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    specs = jax_zero1(jax_make_mesh(n), tree)
    port = zero1_sharding(Mesh(0, n, torch.device("cpu")), tree)
    for k, shape in SHAPES.items():
        spec = tuple(specs[k].spec)
        want = spec.index("data") if "data" in spec else None
        assert port[k] == want == zero1_dim(shape, n), (k, spec)
