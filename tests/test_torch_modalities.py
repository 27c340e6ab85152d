"""The extra GLIGEN modalities in the port against the JAX package on the
CPU: adapt_models_for_modality (configs and parameter shapes), unet_apply
in every grounding_type, with the downsampler's extra input channels and
the gatedSA2 and gatedCA fusers, one PLMS generation per modality (canny,
keypoint, text_image) under tests/parity_setup.py's gates, the
gligen_inference CLI's modality and inpainting runs at --small --device
cpu (its refusals of bad input are tests/test_torch_cli.py's), and one
--int8 case: ConvNeXt's large weights quantized as the JAX package
quantizes them.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from layoutllm_t2i_tpu.diffusion import samplers as jsamp
from layoutllm_t2i_tpu.models import convnext as jconvnext
from layoutllm_t2i_tpu.models import grounding_extras as jge
from layoutllm_t2i_tpu.models import unet as junet
from layoutllm_t2i_tpu.models.vae import decode as jvae_decode
from layoutllm_t2i_tpu.ops import quant as jquant
from layoutllm_t2i_tpu.pipeline import inference as jinf
from layoutllm_t2i_tpu.pipeline import loaders as jloaders

from parity_setup import LATENT_GATE, PSNR_GATE_DB, SSIM_GATE, psnr, ssim

from layoutllm_t2i_torch.checkpoint.from_jax import (load_from_jax,
                                                     param_tree_from_jax,
                                                     state_dict_from_jax,
                                                     unet_params_from_jax)
from layoutllm_t2i_torch.cli import gligen_inference as pgligen
from layoutllm_t2i_torch.models import convnext as pconvnext
from layoutllm_t2i_torch.models import unet as punet
from layoutllm_t2i_torch.ops import nn as pnn
from layoutllm_t2i_torch.ops import quant as pquant
from layoutllm_t2i_torch.pipeline import loaders as ploaders
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.utils.images import read_png, save_png
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MODALITIES = ["box_text", "text_image", "canny", "hed", "depth", "normal", "sem",
              "keypoint"]
SMALL_UNET = dict(image_size=8, model_channels=32, num_res_blocks=1,
                  attention_resolutions=(2, 1), channel_mult=(1, 2),
                  num_heads=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in tree.items()}


def _set_alphas(tree, value):
    for k, v in tree.items():
        if isinstance(v, dict):
            _set_alphas(v, value)
        elif k.startswith("alpha_"):
            tree[k] = np.asarray(value, np.float32)
    return tree


@pytest.fixture(scope="module")
def bundles():
    jm = jloaders.random_models(seed=0, small=True)
    pm = ploaders.random_models(small=True, device="cpu", seed=1)
    for name in ("unet_params", "vae_params", "clip_params"):
        load_from_jax(getattr(pm, name), getattr(jm, name))
    return jm, pm


# ---------------------------------------------------------------------------
# adapt_models_for_modality


@pytest.mark.parametrize("modality", MODALITIES)
def test_adapt_models_for_modality_matches_jax(bundles, modality):
    jm, pm = bundles
    ja = jloaders.adapt_models_for_modality(jm, modality, seed=0)
    pa = ploaders.adapt_models_for_modality(pm, modality, seed=0)
    assert dataclasses.asdict(pa.unet_cfg) == dataclasses.asdict(ja.unet_cfg)
    assert _shapes(pa.unet_params.state_dict()) == _shapes(
        state_dict_from_jax(_np_tree(ja.unet_params)))
    if modality == "box_text":
        assert pa is pm
        return
    assert pa.unet_cfg.use_relation_attention is False and pa.sd_first_conv is None
    # the bundle it came from is left as it was
    assert pm.unet_cfg.grounding_type == "text" and "downsample_net" not in pm.unet_params
    if modality in ploaders.MAP_MODALITIES:
        assert pa.unet_params["input_blocks"]["0"]["0"]["weight"].shape == (32, 12, 3, 3)
    # the weights it kept are the bundle's own, shared
    assert (pa.unet_params["output_blocks"]["0"]["0"]["in_layers"]["2"]["weight"]
            is pm.unet_params["output_blocks"]["0"]["0"]["in_layers"]["2"]["weight"])


# ---------------------------------------------------------------------------
# unet_apply in each grounding_type, extra channels and fuser


def _unet_inputs(rng, b, mo):
    boxes = np.zeros((b, mo, 4), np.float32)
    masks = np.zeros((b, mo), np.float32)
    boxes[:, :2] = [[0.1, 0.2, 0.5, 0.9], [0.55, 0.1, 0.95, 0.6]]
    masks[:, :2] = 1
    return dict(x=rng.standard_normal((b, 8, 8, 4)).astype(np.float32),
                t=np.asarray([901, 41][:b]),
                ctx=rng.standard_normal((b, 77, 768)).astype(np.float32),
                boxes=boxes, masks=masks,
                emb=rng.standard_normal((b, mo, 768)).astype(np.float32),
                rel=rng.standard_normal((b, 5, 768)).astype(np.float32))


def _extra_grounding(rng, kind, b, mo):
    if kind == "text_image":
        return {"text_masks": (rng.random((b, mo)) > 0.5).astype(np.float32),
                "image_masks": (rng.random((b, mo)) > 0.5).astype(np.float32),
                "image_embeddings": rng.standard_normal((b, mo, 768)).astype(np.float32)}
    if kind == "map":
        return {"cond_map": rng.random((b, 40, 36, 3)).astype(np.float32),
                "map_mask": np.asarray([1.0, 0.0][:b], np.float32)}
    return None


UNET_CASES = {
    "text-gatedCA": dict(fuser_type="gatedCA"),
    "text_image": dict(grounding_type="text_image", use_relation_attention=False),
    "keypoint-gatedCA": dict(grounding_type="keypoint", max_persons_per_image=2,
                             fuser_type="gatedCA", use_relation_attention=False),
    "map-gatedSA2-extra8": dict(grounding_type="map", additional_in_channels=8,
                                fuser_type="gatedSA2", use_relation_attention=False),
    "inpaint-gatedSA": dict(inpaint_mode=True),
}


@pytest.mark.parametrize("case", sorted(UNET_CASES))
def test_unet_apply_matches_jax(rng, case):
    extra = UNET_CASES[case]
    cfg_j = junet.UNetConfig(**SMALL_UNET, **extra)
    cfg_p = punet.UNetConfig(**SMALL_UNET, **extra)
    params = _set_alphas(_np_tree(junet.init_unet_params(jax.random.PRNGKey(5), cfg_j)), 0.6)
    b = 2 if cfg_j.grounding_type != "map" else 1
    mo = 17 * cfg_j.max_persons_per_image if cfg_j.grounding_type == "keypoint" else 30
    inp = _unet_inputs(rng, b, mo)
    if cfg_j.grounding_type == "keypoint":
        inp["boxes"] = rng.random((b, mo, 2)).astype(np.float32)
        inp["masks"] = (rng.random((b, mo)) > 0.3).astype(np.float32)
    eg = _extra_grounding(rng, cfg_j.grounding_type, b, 30)
    kw = {}
    if cfg_j.additional_in_channels:
        kw["grounding_extra"] = rng.standard_normal((b, 8, 8, 8)).astype(np.float32)
    if cfg_j.inpaint_mode:
        kw["inpainting_extra"] = rng.standard_normal((b, 8, 8, 5)).astype(np.float32)
    args = [inp[k] for k in ("x", "t", "ctx", "boxes", "masks", "emb", "rel")]
    ref = jax.jit(lambda p, a, eg, kw: junet.unet_apply(
        p, cfg_j, *a, fuser_scale=0.8, extra_grounding=eg, **kw))(
        params, [jnp.asarray(a) for a in args],
        None if eg is None else {k: jnp.asarray(v) for k, v in eg.items()},
        {k: jnp.asarray(v) for k, v in kw.items()})
    tree = unet_params_from_jax(params, cfg_p)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = punet.unet_apply(
        tree, cfg_p, pnn.nhwc_to_nchw(t(inp["x"])), *map(t, args[1:]),
        fuser_scale=0.8,
        extra_grounding=None if eg is None else {k: t(v) for k, v in eg.items()},
        **{k: pnn.nhwc_to_nchw(t(v)) for k, v in kw.items()})
    np.testing.assert_allclose(pnn.nchw_to_nhwc(out).numpy(), np.asarray(ref),
                               atol=1e-4, rtol=1e-4)


def test_unet_apply_refuses_inpaint_mode_without_its_input(rng):
    cfg = punet.UNetConfig(**SMALL_UNET, inpaint_mode=True)
    from layoutllm_t2i_torch.models.initializers import Init

    tree = punet.init_unet_params(Init(torch.Generator().manual_seed(0),
                                       torch.device("cpu")), cfg)
    inp = _unet_inputs(rng, 1, 30)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    with pytest.raises(ValueError, match="inpainting_extra"):
        punet.unet_apply(tree, cfg, pnn.nhwc_to_nchw(t(inp["x"])),
                         *(t(inp[k]) for k in ("t", "ctx", "boxes", "masks", "emb", "rel")))


# ---------------------------------------------------------------------------
# one PLMS generation a modality, against the JAX pipeline


PROMPTS = ["a dog on the grass", "a cat on a chair"]


def _modality_conds(rng, modality, jm, pm, jp, pp):
    """The JAX and the port's conditioning for ``modality``, as the CLIs
    build them, from the same numpy inputs."""
    if modality == "text_image":
        layouts = [([[0.1, 0.2, 0.5, 0.9], [0.5, 0.1, 0.9, 0.6]], ["a dog", "a ball"]),
                   ([[0.2, 0.1, 0.6, 0.6]], ["a cat"])]
    else:
        layouts = [([], [])] * 2
    cj = jp.build_cond(PROMPTS, layouts)
    cp = pp.build_cond(PROMPTS, layouts)
    if modality == "text_image":
        emb = rng.standard_normal((2, 30, 768)).astype(np.float32) * 0.5
        im = np.zeros((2, 30), np.float32)
        im[0, 0] = 1.0
        cj["extra_grounding"] = {"text_masks": cj["masks"], "image_masks": jnp.asarray(im),
                                 "image_embeddings": jnp.asarray(emb)}
        cp["extra_grounding"] = {"text_masks": cp["masks"], "image_masks": torch.from_numpy(im),
                                 "image_embeddings": torch.from_numpy(emb)}
    elif modality == "keypoint":
        pts, masks = pgligen.parse_keypoints(
            "0.5,0.2;0.52,0.18;0.48,0.18|0.2,0.3;0.25,0.35", 8)
        cj.update(boxes=jnp.tile(jnp.asarray(pts)[None], (2, 1, 1)),
                  masks=jnp.tile(jnp.asarray(masks)[None], (2, 1)),
                  phrase_embeddings=jnp.zeros((2, 136, 768), jnp.float32))
        cp.update(pgligen.keypoint_conditioning(
            pm, "0.5,0.2;0.52,0.18;0.48,0.18|0.2,0.3;0.25,0.35", 2))
    else:
        cmap = rng.random((2, 40, 48, 3)).astype(np.float32)
        extra = jge.grounding_downsampler(jm.unet_params["downsample_net"],
                                          jnp.asarray(cmap), resize_input=32)
        cj["extra_grounding"] = {"cond_map": jnp.asarray(cmap),
                                 "map_mask": jnp.ones((2,), jnp.float32)}
        cj["grounding_extra"] = extra
        cp.update(pgligen.map_conditioning(pm, torch.from_numpy(cmap)))
        np.testing.assert_allclose(cp["grounding_extra"].numpy(), np.asarray(extra),
                                   atol=1e-5, rtol=1e-5)
    return cj, cp


def _jax_generation(jp, cond, noise):
    jm = jp.models
    cj = dict(cond)
    cj["objs"] = jinf.precompute_grounding_tokens(jm, jm.unet_params, cj, True)
    core = jinf.make_cfg_denoiser(jm, jp.guidance_scale)
    z = jax.jit(lambda z: jsamp.plms_sample(
        lambda x, t, f, u: core(jm.unet_params, None, cj, x, t, f, u),
        jp.tables, z, schedule=jm.schedule))(jnp.asarray(noise))
    img = jax.jit(lambda z: jnp.clip(jvae_decode(jm.vae_params, jm.vae_cfg, z),
                                     -1.0, 1.0) * 0.5 + 0.5)(z)
    return np.asarray(z), np.asarray(img)


@pytest.mark.parametrize("modality", ["canny", "keypoint", "text_image"])
def test_generation_matches_jax(rng, bundles, modality):
    jm0, _ = bundles
    jm = jloaders.adapt_models_for_modality(jm0, modality, seed=3)
    jm.unet_params = _set_alphas(_np_tree(jm.unet_params), 0.6)
    # a bundle of its own: the adapted tree shares the weights it keeps
    pm = ploaders.adapt_models_for_modality(
        ploaders.random_models(small=True, device="cpu", seed=1), modality, seed=3)
    for name in ("unet_params", "vae_params", "clip_params"):
        load_from_jax(getattr(pm, name), getattr(jm, name))
    sample = dict(steps=3, guidance_scale=7.5,
                  alpha_type=(1.0, 0.0, 0.0) if modality != "text_image" else (0.5, 0.0, 0.5))
    jp = jinf.InferencePipeline(jm, **sample)
    pp = InferencePipeline(pm, **sample)
    cj, cp = _modality_conds(rng, modality, jm, pm, jp, pp)
    noise = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    z_j, img_j = _jax_generation(jp, cj, noise)
    z_p = pp.run_sampler(cp, noise)
    lat_err = float(np.abs(z_p.numpy() - z_j).max())
    assert lat_err < LATENT_GATE, lat_err
    img_p = pp.decode(z_p).numpy()
    for a, b in zip(img_p, img_j):
        assert psnr(a, b) >= PSNR_GATE_DB
        assert ssim(a, b) >= SSIM_GATE


# ---------------------------------------------------------------------------
# the CLI at --small --device cpu


@pytest.fixture
def images(tmp_path):
    rng = np.random.default_rng(0)
    paths = {}
    for name, shape in (("src", (16, 16, 3)), ("big", (32, 32, 3)),
                        ("map", (40, 30, 3)), ("ref", (20, 24, 3))):
        paths[name] = str(tmp_path / f"{name}.png")
        save_png((rng.random(shape) * 255).astype(np.uint8), paths[name])
    return paths


CLI_RUNS = {
    "inpaint": ["--layout", "dog:[0.2,0.2,0.5,0.5]", "--inpaint_image", "{src}"],
    "inpaint-ddim-fast": ["--layout", "dog:[0.2,0.2,0.5,0.5]", "--inpaint_image", "{src}",
                          "--no_plms", "--cache_encoder", "2", "--cfg_interval", "0,0.5"],
    "canny": ["--modality", "canny", "--map_path", "{map}"],
    "sem-int8": ["--modality", "sem", "--map_path", "{map}", "--int8"],
    "keypoint": ["--modality", "keypoint", "--keypoints", "0.5,0.2;0.52,0.18|0.1,0.1"],
    "text_image": ["--modality", "text_image", "--layout",
                   "dog:[0.2,0.2,0.5,0.5];cat:[0.5,0.5,0.3,0.3]",
                   "--image_refs", "{ref};-"],
}


@pytest.mark.parametrize("run", sorted(CLI_RUNS))
def test_cli_runs(tmp_path, images, run):
    argv = [a.format(**images) for a in CLI_RUNS[run]]
    paths = pgligen.main(["--prompt", "a dog", "--small", "--device", "cpu",
                          "--folder", str(tmp_path / "out")] + argv)
    assert len(paths) == 1
    with open(paths[0], "rb") as f:
        px = read_png(f.read())
    assert px.shape == (16, 16, 3)


# ---------------------------------------------------------------------------
# --int8 with a modality


def test_int8_quantizes_convnext_like_jax(rng, bundles):
    """quantize_params with the JAX default floor (65,536 elements) on a
    canny bundle: the same weights quantized, ConvNeXt's large linears and
    its stage-3 downsample conv among them, with the same int8 values and
    scales; ConvNeXt's features on the int8 weights against the JAX ones."""
    jm0, _ = bundles
    ja = jloaders.adapt_models_for_modality(jm0, "canny", seed=0)
    tree = _np_tree(ja.unet_params)
    jq = jquant.quantize_params(tree)
    pa = ploaders.adapt_models_for_modality(
        ploaders.random_models(small=True, device="cpu", seed=1), "canny")
    pq = pquant.quantize_params(load_from_jax(pa.unet_params, tree))

    def quantized(t, prefix=""):
        out = set()
        for k in t.keys():
            v = t[k]
            name = prefix + k
            if isinstance(v, (dict, torch.nn.Module)):
                out |= quantized(v, name + ".")
            elif jquant.is_quantized(v) or pquant.is_quantized(v):
                out.add(name)
        return out

    names = quantized(pq)
    assert names == quantized(jq)
    bb = "position_net.convnext_tiny_backbone."
    assert {bb + "downsample_layers.3.1.weight", bb + "stages.3.0.pwconv1.weight",
            bb + "stages.2.0.pwconv2.weight"} <= names
    assert bb + "stages.3.0.dwconv.weight" not in names
    bridged = param_tree_from_jax(jq)
    for name in (bb + "downsample_layers.3.1.weight", bb + "stages.3.2.pwconv2.weight"):
        node_p, node_b = pq, bridged
        for part in name.split("."):
            node_p, node_b = node_p[part], node_b[part]
        assert torch.equal(node_p.q, node_b.q)
        assert torch.equal(node_p.scale, node_b.scale)
    cfg = jconvnext.ConvNeXtConfig()
    x = rng.random((1, 64, 64, 3)).astype(np.float32)
    ref = jconvnext.convnext_features(jq["position_net"]["convnext_tiny_backbone"], cfg,
                                      jnp.asarray(x))
    out = pconvnext.convnext_features(pq["position_net"]["convnext_tiny_backbone"],
                                      pconvnext.ConvNeXtConfig(),
                                      pnn.nhwc_to_nchw(torch.from_numpy(x)))
    ref = np.asarray(ref)
    rel = float(np.abs(pnn.nchw_to_nhwc(out).numpy() - ref).max() / np.abs(ref).max())
    assert rel < 1e-4, rel


@pytest.mark.parametrize("kind", ["inpaint_mode-gatedCA", "map-gatedSA2"])
def test_cli_runs_a_checkpoint_of_the_new_kinds(tmp_path, images, kind):
    """A .pth whose embedded config sets inpaint_mode (with the gatedCA
    fuser), or map grounding with the gatedSA2 fuser and a downsampler,
    loads strictly and runs through the CLI."""
    from layoutllm_t2i_torch.checkpoint.export import export_gligen_checkpoint
    from layoutllm_t2i_torch.models.initializers import Init

    pm = ploaders.random_models(small=True, device="cpu", seed=4)
    extra = (dict(inpaint_mode=True, fuser_type="gatedCA") if kind.startswith("inpaint")
             else dict(grounding_type="map", additional_in_channels=8,
                       fuser_type="gatedSA2", use_relation_attention=False))
    cfg = dataclasses.replace(pm.unet_cfg, **extra)
    ini = Init(torch.Generator().manual_seed(0), torch.device("cpu"))
    unet = ploaders.unet_init_tree(ini, cfg, downsampler=cfg.grounding_type == "map")
    from layoutllm_t2i_torch.utils.trees import flatten_tree

    path = str(tmp_path / f"{kind}.pth")
    export_gligen_checkpoint(path, flatten_tree(unet), pm.vae_params.state_dict(),
                             pm.clip_params.state_dict(), pm.schedule,
                             {"unet_cfg": dataclasses.asdict(cfg),
                              "vae_cfg": dataclasses.asdict(pm.vae_cfg),
                              "clip_cfg": dataclasses.asdict(pm.clip_cfg)})
    loaded = ploaders.load_models_from_gligen_ckpt(path, device="cpu")
    assert loaded.unet_cfg == cfg
    argv = (["--layout", "dog:[0.2,0.2,0.5,0.5]", "--inpaint_image", images["src"]]
            if kind.startswith("inpaint") else
            ["--modality", "canny", "--map_path", images["map"]])
    paths = pgligen.main(["--prompt", "a dog", "--ckpt", path, "--device", "cpu",
                          "--small", "--folder", str(tmp_path / "out")] + argv)
    with open(paths[0], "rb") as f:
        assert read_png(f.read()).shape == (16, 16, 3)
    if kind.startswith("inpaint"):
        with pytest.raises(ValueError, match="needs --inpaint_image"):
            pgligen.main(["--prompt", "a dog", "--ckpt", path, "--device", "cpu",
                          "--layout", "dog:[0.2,0.2,0.5,0.5]"])
