"""The port bench (layoutllm_t2i_torch/cli/bench.py) and its analytic FLOP
count (utils/flops.py) against the JAX package, on the CPU.

* utils/flops.py counts the JAX bench's timed program at the --small
  geometry: ``count_fn_flops`` of bench.py's ``run_all_fn`` (traced only:
  make_jaxpr compiles nothing) for exact PLMS-50 and the fast preset. The
  JAX walker's ``cond_mode="min"`` leaves PLMS's Heun warm start out (the
  cond's cheaper branch, Adams-Bashforth, has no matmul), so the JAX count
  of the exact path is the port's minus one grounded CFG evaluation,
  exactly. For the fast preset the JAX walker interpolates the encoder
  cache's key/propagated cond at the global key fraction; with the
  preset's tables that equals the per-step count, and the two agree to
  1e-6 (difference 0). Each piece (a UNet evaluation in every
  gated/encoder case, PositionNet, the VAE decode) matches its JAX count.
* bench.py's flags, defaults and dual rule; the bench run as a process at
  the small geometry prints one JSON line with every field.
* utils/profiling.py: the phase timer and the trace on the CPU.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from layoutllm_t2i_tpu.models import position_net as jpn
from layoutllm_t2i_tpu.models import unet as junet
from layoutllm_t2i_tpu.models import vae as jvae
from layoutllm_t2i_tpu.pipeline import presets as jpresets
from layoutllm_t2i_tpu.pipeline.inference import InferencePipeline as JaxPipeline
from layoutllm_t2i_tpu.pipeline.loaders import random_models as jax_random_models
from layoutllm_t2i_tpu.utils.flops import count_fn_flops

from layoutllm_t2i_torch.cli import bench as pbench
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.pipeline.loaders import model_configs
from layoutllm_t2i_torch.utils import flops as pflops
from layoutllm_t2i_torch.utils.profiling import (PhaseTimer, device_intervals,
                                                 device_profile, trace, union_ms)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
B, ITERS = 2, 2
CTX = 77


@pytest.fixture(scope="module")
def jax_models():
    return jax_random_models(seed=0, small=True)


def _port_tables(jp):
    """The port pipeline of the JAX pipeline's settings, on a namespace
    holding the small configs (no weights: the count needs none)."""
    from types import SimpleNamespace

    from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule

    u, v, c = model_configs(small=True)
    models = SimpleNamespace(unet_cfg=u, vae_cfg=v, clip_cfg=c, max_objs=30,
                             max_relas=5, tokenizer=SimpleNamespace(max_length=CTX),
                             schedule=make_ddpm_schedule("linear", 1000, 0.00085,
                                                         0.012))
    return InferencePipeline(
        models, steps=jp.steps, sampler=jp.sampler,
        guidance_scale=jp.guidance_scale, alpha_type=jp.alpha_type,
        vae_chunk=jp.vae_chunk, encoder_cache_interval=jp.encoder_cache_interval,
        cfg_interval=jp.cfg_interval)


def _jax_bench_count(jm, jp):
    """bench.py's count: count_fn_flops of its run_all_fn (scan of
    ``ITERS`` sample_fn calls) with its key_frac, per sample_fn call."""
    cond = jp.build_cond([pbench.PROMPT] * B, [pbench.LAYOUT] * B,
                         [pbench.RELATIONS] * B)
    noises = jnp.zeros((ITERS, B, 8, 8, 4), jnp.float32)

    def run_all_fn(unet_params, vae_params, sd_conv, cond, noises):
        out = jax.eval_shape(
            lambda nz: jp._sample_fn(unet_params, vae_params, sd_conv, cond,
                                     nz, jax.random.PRNGKey(0)), noises[0])
        img0 = jnp.zeros(out.shape, out.dtype)

        def body(carry, nz):
            img = jp._sample_fn(unet_params, vae_params, sd_conv, cond, nz,
                                jax.random.PRNGKey(0))
            return img, jnp.sum(img.astype(jnp.float32))
        return jax.lax.scan(body, img0, noises)

    kf = (float(np.mean(jp._key_steps())) if jp.encoder_cache_interval
          else None)
    return count_fn_flops(run_all_fn, jm.unet_params, jm.vae_params,
                          jm.sd_first_conv, cond, noises, key_frac=kf) / ITERS


MODES = {
    "exact": dict(steps=50, sampler="plms"),
    "fast": dict(steps=jpresets.FAST_STEPS, sampler=jpresets.FAST_SAMPLER,
                 cfg_interval=jpresets.FAST_CFG_INTERVAL,
                 encoder_cache_interval=jpresets.FAST_CACHE_ENCODER),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_flops_match_the_jax_bench_count(jax_models, mode):
    jp = JaxPipeline(jax_models, guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
                     vae_chunk=8, **MODES[mode])
    want = _jax_bench_count(jax_models, jp)
    pp = _port_tables(jp)
    got = pflops.generation_flops(pp, B)
    assert got["total"] == pytest.approx(
        got["grounding"] + got["unet"] + got["vae"], rel=1e-12)
    if mode == "exact":
        # the JAX walker leaves out the Heun warm start: one grounded
        # evaluation at CFG batch 2B (steps 0-14 are grounded)
        evals = pflops.unet_evaluations(pp, B)
        assert len(evals) == 51 and evals[1] == (2 * B, True, True)
        heun = pflops.unet_flops(pp.models.unet_cfg, 2 * B, 30, 5, CTX)
        assert abs(got["total"] - heun - want) <= 1e-6 * want
        assert heun / want == pytest.approx(0.0230530, rel=1e-4)
    else:
        assert abs(got["total"] - want) <= 1e-6 * want


def _jax_unet_count(jm, b, gated, encoder):
    cfg = jm.unet_cfg
    args = (jnp.zeros((b, 8, 8, 4)), jnp.zeros((b,), jnp.int32),
            jnp.zeros((b, CTX, 768)), jnp.zeros((b, 30, 4)), jnp.zeros((b, 30)),
            jnp.zeros((b, 30, 768)), jnp.zeros((b, 5, 768)))
    objs = jnp.zeros((b, 30, 768))

    def run(params, *a):
        if encoder:
            return junet.unet_apply(params, cfg, *a, objs=objs,
                                    skip_gated=not gated)
        _, cache = junet.unet_apply(params, cfg, *a, objs=objs,
                                    return_encoder_cache=True)
        return junet.unet_apply(params, cfg, *a, objs=objs,
                                skip_gated=not gated, encoder_cache=cache)
    total = count_fn_flops(run, jm.unet_params, *args)
    if not encoder:   # less the full forward that made the cache
        total -= count_fn_flops(
            lambda p, *a: junet.unet_apply(p, cfg, *a, objs=objs), jm.unet_params,
            *args)
    return total


@pytest.mark.parametrize("b,gated,encoder", [
    (1, True, True), (4, True, True), (4, False, True), (4, True, False),
    (2, False, False)])
def test_unet_flops_match_jax(jax_models, b, gated, encoder):
    u = model_configs(small=True)[0]
    want = _jax_unet_count(jax_models, b, gated, encoder)
    assert pflops.unet_flops(u, b, 30, 5, CTX, gated=gated,
                             encoder=encoder) == pytest.approx(want, rel=1e-12)


def test_unet_flops_four_levels_without_relations():
    """A config the small geometry does not reach: SD-1.4's four levels
    and attention resolutions at a fifth of its width, the relation fuser
    off, two transformer blocks a level."""
    from layoutllm_t2i_tpu.models.unet import UNetConfig as JUNetConfig
    from layoutllm_t2i_torch.models.unet import UNetConfig

    kw = dict(use_relation_attention=False, transformer_depth=2,
              image_size=16, model_channels=64)
    jcfg, pcfg = JUNetConfig(**kw), UNetConfig(**kw)
    params = junet.init_unet_params(jax.random.PRNGKey(0), jcfg)
    b = 2
    args = (jnp.zeros((b, 16, 16, 4)), jnp.zeros((b,), jnp.int32),
            jnp.zeros((b, CTX, 768)), jnp.zeros((b, 30, 4)), jnp.zeros((b, 30)),
            jnp.zeros((b, 30, 768)), jnp.zeros((b, 5, 768)))
    want = count_fn_flops(lambda p, *a: junet.unet_apply(
        p, jcfg, *a, objs=jnp.zeros((b, 30, 768))), params, *args)
    assert pflops.unet_flops(pcfg, b, 30, 5, CTX) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("b,side", [(1, 8), (3, 8), (2, 5)])
def test_vae_decode_flops_match_jax(jax_models, b, side):
    v = model_configs(small=True)[1]
    want = count_fn_flops(
        lambda p, z: jvae.decode(p, jax_models.vae_cfg, z), jax_models.vae_params,
        jnp.zeros((b, side, side, 4)))
    assert pflops.vae_decode_flops(v, b, side) == pytest.approx(want, rel=1e-12)


def test_position_net_flops_match_jax(jax_models):
    u = model_configs(small=True)[0]
    want = count_fn_flops(
        lambda p, bx, m, e: jpn.position_net(p, bx, m, e),
        jax_models.unet_params["position_net"], jnp.zeros((3, 30, 4)),
        jnp.zeros((3, 30)), jnp.zeros((3, 30, 768)))
    assert pflops.position_net_flops(u, 90) == pytest.approx(want, rel=1e-12)


def test_unet_evaluations_without_guidance():
    """guidance 1.0 runs every step at batch b (no CFG doubling)."""
    from types import SimpleNamespace

    from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule

    models = SimpleNamespace(schedule=make_ddpm_schedule("linear", 1000, 0.00085,
                                                         0.012))
    pp = InferencePipeline(models, steps=10, sampler="plms", guidance_scale=1.0,
                           alpha_type=(0.3, 0.0, 0.7), cfg_interval=(0.0, 0.5))
    evals = pflops.unet_evaluations(pp, 3)
    assert len(evals) == len(pp.tables.t) + 1      # PLMS's Heun warm start
    assert {e[0] for e in evals} == {3}


def test_peak_and_mfu(monkeypatch):
    monkeypatch.delenv("LLT2I_PEAK_TFLOPS", raising=False)
    assert pflops.peak_tflops() == 989.0
    assert pflops.mfu(989e12, 2.0) == pytest.approx(0.5)
    assert pflops.mfu(989e12, 1.0, n_chips=4) == pytest.approx(0.25)
    assert pflops.mfu(1.0, 0.0) == 0.0 and pflops.mfu(1.0, float("inf")) == 0.0
    monkeypatch.setenv("LLT2I_PEAK_TFLOPS", "197")
    assert pflops.peak_tflops() == 197.0
    assert pflops.mfu(197e12, 1.0) == pytest.approx(1.0)


def _bench_py_flags():
    """{flag: default} of every add_argument in bench.py's main."""
    tree = ast.parse((REPO / "bench.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "add_argument"):
            name = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else False if "action" in kw else None)
            flags[name] = default
    return flags


def test_bench_flags_and_defaults_are_bench_py_s():
    want = _bench_py_flags()
    assert len(want) == 15
    got = {f"--{k}": v for k, v in vars(pbench.parse_args([])).items()}
    assert got.pop("--device") is None
    assert got == want


@pytest.mark.parametrize("argv,dual", [
    ([], True), (["--trace", "t"], True), (["--batch", "4", "--iters", "2"], True),
    (["--small"], True), (["--fast"], False), (["--no_fast"], False),
    (["--latency"], False), (["--int8"], False), (["--sampler", "dpm"], False),
    (["--steps", "20"], False), (["--cfg_interval", "0,0.75"], False),
    (["--cache_encoder", "2"], False)])
def test_dual_rule(argv, dual):
    assert pbench.is_dual(pbench.parse_args(argv)) is dual


def test_sharded_is_refused_before_any_model(monkeypatch):
    from layoutllm_t2i_torch.pipeline import loaders

    def built(**_):
        raise AssertionError("a model was built")

    monkeypatch.setattr(loaders, "random_models", built)
    with pytest.raises(NotImplementedError, match="parallel/"):
        pbench.Bench(pbench.parse_args(["--sharded", "--device", "cpu"]))


def test_fast_flag_expands_the_preset():
    a = pbench.parse_args(["--fast", "--device", "cpu", "--small", "--batch", "1",
                           "--iters", "1"])
    bench = pbench.Bench(a)
    assert bench.metric_suffix == "_fast" and not bench.dual
    p = bench.pipe
    assert (p.sampler, p.steps, p.cfg_interval, p.encoder_cache_interval) == (
        jpresets.FAST_SAMPLER, jpresets.FAST_STEPS, jpresets.FAST_CFG_INTERVAL,
        jpresets.FAST_CACHE_ENCODER)
    assert p.vae_chunk == 8 and p.alpha_type == (0.3, 0.0, 0.7)


FIELDS = {"metric", "value", "unit", "tflops_per_sec", "mfu", "peak_tflops",
          "flops_per_image", "device", "peak_mem_gib", "fast_value",
          "fast_psnr_vs_exact_db", "fast_tflops_per_sec", "fast_mfu",
          "fast_flops_per_image"}


def test_bench_runs_as_a_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "layoutllm_t2i_torch.cli.bench", "--small",
         "--device", "cpu", "--batch", "2", "--iters", "1", "--trace",
         str(tmp_path / "tr")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert FIELDS <= set(line) and "fast_error" not in line
    assert "vs_baseline" not in line
    assert line["metric"] == "images_per_sec_per_chip" and line["unit"] == "img/s"
    assert line["device"] == "cpu" and line["peak_mem_gib"] is None
    assert np.isfinite(line["fast_psnr_vs_exact_db"])
    assert line["value"] > 0 and line["fast_value"] > 0
    assert 0 < line["mfu"] < 1 and 0 < line["fast_mfu"] < 1
    # the count is utils/flops.py's at the bench's settings
    jm_u, jm_v, jm_c = model_configs(small=True)
    from types import SimpleNamespace

    from layoutllm_t2i_torch.ops.schedules import make_ddpm_schedule
    m = SimpleNamespace(unet_cfg=jm_u, vae_cfg=jm_v, clip_cfg=jm_c, max_objs=30,
                        max_relas=5, tokenizer=SimpleNamespace(max_length=CTX),
                        schedule=make_ddpm_schedule("linear", 1000, 0.00085, 0.012))
    exact = InferencePipeline(m, steps=50, guidance_scale=7.5,
                              alpha_type=(0.3, 0.0, 0.7), vae_chunk=8)
    assert line["flops_per_image"] == pytest.approx(
        pflops.generation_flops(exact, 2)["total"] / 2 / 1e12, rel=1e-12)
    # --trace in dual mode: the wall of one more run of each mode
    assert line["trace"]["device_busy_ms"] is None
    assert line["fast_trace"]["wall_ms"] > 0


def test_latency_mode_line(monkeypatch):
    out, images = pbench.Bench(pbench.parse_args(
        ["--latency", "--small", "--device", "cpu", "--iters", "1",
         "--steps", "3"])).run()
    assert out["metric"] == "image_latency_steady_state_mean"
    assert out["unit"] == "s/img" and out["value"] > 0
    assert set(images) == {"exact"} and images["exact"].shape == (1, 16, 16, 3)


def test_phase_timer_and_trace(tmp_path):
    import torch

    tm = PhaseTimer()
    for _ in range(2):
        with tm.phase("encode", block_on=torch.ones(2)):
            pass
    assert tm.counts["encode"] == 2 and "encode: total" in tm.report()
    with trace("step", logdir=str(tmp_path)):
        torch.ones(3) + 1
    assert json.loads((tmp_path / "step.json").read_text())
    with trace("no_logdir"):
        pass
    rec = device_profile(lambda: None, on_card=False)
    assert rec["device_idle_share"] is None and rec["wall_ms"] >= 0


def test_device_busy_time_counts_overlapping_activities_once():
    # the busy time is the union of the trace's device intervals: two
    # kernels overlapping on two streams, a copy inside one of them and a
    # host event count as the span they cover, not as the sum of their
    # durations (which passed the wall in the f32 profiles)
    trace_json = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 120.0, "dur": 60.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 130.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0.0, "dur": 1e6},
        {"ph": "X", "cat": "gpu_memset", "name": "d", "ts": 300.0, "dur": 10.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 400.0},
    ]}
    iv = device_intervals(trace_json)
    assert iv == [(100.0, 150.0), (120.0, 180.0), (130.0, 135.0), (300.0, 310.0)]
    assert union_ms(iv) == pytest.approx((80.0 + 10.0) / 1e3)
    assert sum(b - a for a, b in iv) / 1e3 > union_ms(iv)
    assert union_ms([]) == 0.0

