"""Shared set-up of the fast-path parity tests (tests/test_torch_fast*.py).

The JAX and the port pipelines at small geometry with the JAX weights
carried across, and the JAX sampler over its CFG denoiser wired as the JAX
package's ``InferencePipeline._sample_fn`` wires it: the cond-only
denoisers and the cfg_on table in guidance-interval mode, a zero cache of
the first segment's batch and the key table in encoder-cache mode.
``steps=6`` gives 7 steps (range(1, 1000, 166) and the reference's +1);
with alpha (0.3, 0, 0.7) and the interval (0, 0.75) they make three
segments: steps 0-1 grounded with CFG, 2-4 without the gated fusers with
CFG, 5-6 cond-only. With the encoder cache every 2nd step of each is
propagated (keys 0 | 2, 4 | 5), so a propagated step runs in every kind of
segment, and PLMS's Heun warm start reuses step 0's cache.
"""
import numpy as np
import jax
import jax.numpy as jnp

from layoutllm_t2i_tpu.diffusion import samplers as jsamplers
from layoutllm_t2i_tpu.pipeline.inference import (
    InferencePipeline as JaxPipeline, make_cfg_denoiser, precompute_grounding_tokens,
)
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models

from layoutllm_t2i_torch.checkpoint.from_jax import load_from_jax
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.pipeline.loaders import random_models

PROMPTS = ["a dog chasing a ball on the grass", "a cat sitting on a chair"]
LAYOUTS = [([[0.1, 0.4, 0.5, 0.9], [0.6, 0.6, 0.85, 0.85]], ["a dog", "a ball"]),
           ([[0.2, 0.1, 0.6, 0.6], [0.1, 0.4, 0.7, 0.95], [0.7, 0.1, 0.9, 0.7]],
            ["a cat", "a chair", "a lamp"])]
RELATIONS = [["dog chasing ball"], ["cat on chair", "lamp next to chair"]]
SAMPLE = dict(steps=6, guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7))
INTERVAL = (0.0, 0.75)


def bridged_models():
    """(JAX bundle, port bundle on the CPU holding the same weights). A
    fuser gate is opened (random init leaves it 0, which would hide the
    gated path)."""
    jm = jax_random_models(seed=0, small=True)
    jm.unet_params["input_blocks"]["1"]["1"]["transformer_blocks"]["0"][
        "fuser"]["alpha_attn"] = np.asarray(0.6, np.float32)
    pm = random_models(small=True, device="cpu", seed=1)
    for name in ("unet_params", "vae_params", "clip_params"):
        load_from_jax(getattr(pm, name), getattr(jm, name))
    return jm, pm


def pipelines(jm, pm, **kw):
    return (JaxPipeline(jm, **SAMPLE, **kw), InferencePipeline(pm, **SAMPLE, **kw))


def noise(b=2):
    return np.random.default_rng(7).standard_normal((b, 8, 8, 4)).astype(np.float32)


def jax_latents(jp, cond, z):
    """The JAX sampler's final latent for ``jp``'s configuration."""
    jm = jp.models
    gs = jp.guidance_scale
    cj = dict(cond)
    cj["objs"] = precompute_grounding_tokens(jm, jm.unet_params, cj, gs != 1.0)

    def bind(core, skip):
        return lambda x, t, f, u, **kw: core(jm.unet_params, None, cj, x, t, f, u,
                                             skip_gated=skip, **kw)

    core = make_cfg_denoiser(jm, gs)
    dn = bind(core, False)
    kw = {"denoise_skip_fn": bind(core, True)}
    if jp.cfg_interval:
        nc = make_cfg_denoiser(jm, gs, cfg_override=False)
        kw.update(denoise_nocfg_fn=bind(nc, False),
                  denoise_nocfg_skip_fn=bind(nc, True), cfg_on=jp._cfg_on_steps())
    z = jnp.asarray(z)
    if jp.encoder_cache_interval:
        first = dn if "cfg_on" not in kw or kw["cfg_on"][0] else kw["denoise_nocfg_fn"]
        t0 = jnp.full((z.shape[0],), jp.tables.t[0])
        shapes = jax.eval_shape(
            lambda nz: first(nz, t0, 1.0, False, cache="init", is_key=True)[1], z)
        kw.update(cache_init=jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes),
            key_steps=jp._key_steps())
    sample = {"plms": jsamplers.plms_sample, "ddim": jsamplers.ddim_sample,
              "dpm": jsamplers.dpm_sample}[jp.sampler]
    return np.asarray(jax.jit(lambda x: sample(
        dn, jp.tables, x, schedule=jm.schedule, **kw))(z))
