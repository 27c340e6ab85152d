"""PLMS with the guidance interval, the encoder cache and both, the port
against the JAX package on the CPU (set-up and gates as
tests/test_torch_fast.py). In cached mode PLMS's Heun warm start evaluates
at t_next with the cache of step 0 and no encoder: a second full forward
there, or a stale cache, moves the latent far past the gate.
"""
import numpy as np
import pytest

from parity_setup import LATENT_GATE
from torch_fast_setup import (INTERVAL, LAYOUTS, PROMPTS, RELATIONS, SAMPLE,
                              bridged_models, jax_latents, noise, pipelines)

from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def models():
    return bridged_models()


@pytest.mark.parametrize("mode", [
    dict(cfg_interval=INTERVAL), dict(encoder_cache_interval=2),
    dict(cfg_interval=INTERVAL, encoder_cache_interval=2)],
    ids=["interval", "cache", "both"])
def test_plms_speed_mode_matches_jax(models, mode):
    jp, pp = pipelines(*models, sampler="plms", **mode)
    z = noise()
    want = jax_latents(jp, jp.build_cond(PROMPTS, LAYOUTS, RELATIONS), z)
    got = pp.run_sampler(pp.build_cond(PROMPTS, LAYOUTS, RELATIONS), z).numpy()
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err < LATENT_GATE, err
    exact = InferencePipeline(models[1], **SAMPLE).run_sampler(
        pp.build_cond(PROMPTS, LAYOUTS, RELATIONS), z).numpy()
    # each mode changes the result (approximate modes, not a no-op)
    assert float(np.abs(got - exact).max()) > 1e-4
