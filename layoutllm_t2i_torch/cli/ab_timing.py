"""Time one checkout of the port on the card, for an A/B of two commits.

Run from the root of a checkout, naming this file by its path:
  python3 <other checkout>/layoutllm_t2i_torch/cli/ab_timing.py
It times the checkout in the working directory (its port and its
chip_smoke.py), not the one that holds this file, so one call to the card
can run it in turns from the roots of two checkouts (parent, change,
change, parent) and compare them on the same card. It prints one JSON
line:
- K1 (flash attention) at the five shapes a 2-request generation gives
  it: the wrapper's host microseconds a call, with its launches queued
  behind a device-side sleep so that the device never waits for the host,
  and the device ms a call of the same run;
- K2 (GroupNorm, + SiLU where the model has it) at every distinct shape
  of one 2-request generation (chip_smoke.generation_calls: the UNet's 18
  at CFG batch 4, among them 64^2 x 320, 32^2 x 640, 16^2 x 1280 and
  8^2 x 1280, and the VAE decoder's 7): the wrapper's host microseconds a
  call and the device ms a call, as chip_smoke.device_time measures them,
  and their sum over one UNet evaluation's 61 calls
  (`k2_unet_eval_device_ms`);
- K3 (LayerNorm) at three of its shapes, the UNet's widths: the
  wrapper's host microseconds a call and the device ms a call, as
  chip_smoke.device_time measures them;
- K7 (the int8 LN + GEGLU FF) and K4 (the same on bf16 weights, whose
  GEMM epilogues K7 shares) at K7's three (M, K) at s = 0.5: device ms a
  call (chip_smoke.device_time) and the host microseconds;
- every kernel's wrapper: the median of its host microseconds a call over
  the shapes chip_smoke's phase `kernels` walks (the generation on its
  three routes and a training step), as chip_smoke.device_time measures
  them;
- one timed 2-request PLMS-50 generation at full SD-1.4 width
  (chip_smoke.run_generation): wall seconds, images/s and K1 launches;
  then the same on the int8 UNet through K7 (LLT2I_FFN_INT8=1): wall
  seconds and K7 launches.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

# (B, N = M, H, d): the generation's K1 calls (CFG batch 4; the VAE at 2)
K1_SHAPES = ((4, 4096, 8, 40), (4, 4126, 8, 40), (4, 1024, 8, 80),
             (4, 1054, 8, 80), (2, 4096, 1, 512))
K3_SHAPES = ((16384, 320), (4096, 640), (1024, 1280))
FF_SHAPES = ((16384, 320), (4096, 640), (1024, 1280))  # K7's and K4's
CALLS = 100
SLEEP_CYCLES = 200_000_000   # >= 0.1 s at the card's SM clock (<= 2 GHz)


def k1_timing(flash_attention, b, n, h, d):
    """(host us, device ms) a call, and whether the device was still
    asleep when the host had enqueued the last call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, n, h * d, device="cuda", generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    for _ in range(3):
        flash_attention(q, k, v, h, scale)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(CALLS):
        flash_attention(q, k, v, h, scale)
    e1.record()
    host_s = time.perf_counter() - t0
    asleep = not e0.query()
    e1.synchronize()
    return host_s / CALLS * 1e6, e0.elapsed_time(e1) / CALLS, asleep


def k2_shapes(cs) -> list:
    """K2's distinct (N, HW, C, eps, silu) in one generation, in call order."""
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    calls = cs.generation_calls(unet_cfg, vae_cfg, clip_cfg, clip_cfg.max_length,
                                cs.REQUESTS, cs.VAE_CHUNK)
    return list(dict.fromkeys(args for kid, args in calls if kid == "K2"))


def unet_k2_calls(cs) -> list:
    """K2's calls in one UNet evaluation of the generation (CFG batch 4)."""
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    unet_cfg, _, clip_cfg = model_configs(small=False)
    return [args for kid, args in cs.unet_calls(
        unet_cfg, 2 * len(cs.REQUESTS[0]), 30, 5, clip_cfg.max_length)
        if kid == "K2"]


def host_us_by_kernel(cs) -> dict:
    """{kernel id: median host us a call} over every shape of chip_smoke's
    walk, each wrapper call on fresh inputs from chip_smoke.make_case."""
    from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
    from layoutllm_t2i_torch.pipeline.loaders import model_configs

    unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
    tok = clip_cfg.max_length
    batch = next(synthetic_layout_batches(cs.TRAIN_BATCH, 512,
                                          cs.TRAIN_MAX_BOXES))
    paths = {name: cs.generation_calls(unet_cfg, vae_cfg, clip_cfg, tok,
                                       cs.REQUESTS, cs.VAE_CHUNK, route=route)
             for name, route in (("generate", cs.DEFAULT), ("int8", cs.INT8),
                                 ("routes", cs.SPLIT))}
    paths["train"] = cs.training_calls(unet_cfg, vae_cfg, clip_cfg, tok, batch,
                                       cs.TRAIN_MAX_BOXES,
                                       cs.TRAIN_MAX_RELATIONS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    host = {}
    for kid, _, args, _ in cs.kernel_cases(paths):
        kern = cs.make_case(kid, args, dev, gen)[0]
        host.setdefault(kid, []).append(cs.device_time(kern)[1])
        del kern
        torch.cuda.empty_cache()
    return {kid: statistics.median(us) for kid, us in host.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from layoutllm_t2i_torch.kernels import build
    from layoutllm_t2i_torch.kernels.flash_attention import flash_attention
    from layoutllm_t2i_torch.pipeline.loaders import (quantize_unet_int8,
                                                      random_models)

    build.build_all()
    out = {"k1": []}
    with torch.no_grad():
        for b, n, h, d in K1_SHAPES:
            host_us, dev_ms, asleep = k1_timing(flash_attention, b, n, h, d)
            out["k1"].append({"shape": f"B{b} N{n} H{h} d{d}",
                              "host_us": host_us, "device_ms": dev_ms,
                              "sleep_outlasted_host": asleep})
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        for kid, shapes in (("K2", k2_shapes(cs)), ("K3", K3_SHAPES),
                            ("K7", FF_SHAPES), ("K4", FF_SHAPES)):
            out[kid.lower()] = []
            for shape in shapes:
                args = shape if kid in ("K2", "K3") else (*shape, 0.5)
                kern = cs.make_case(kid, args, dev, gen)[0]
                dev_ms, host_us = cs.device_time(kern)
                out[kid.lower()].append({"shape": cs.case_label(kid, args),
                                         "host_us": host_us,
                                         "device_ms": dev_ms})
                del kern
    by_shape = {rec["shape"]: rec["device_ms"] for rec in out["k2"]}
    out["k2_unet_eval_device_ms"] = sum(
        by_shape[cs.case_label("K2", args)] for args in unet_k2_calls(cs))
    out["host_us_median"] = host_us_by_kernel(cs)
    models = random_models(small=False, device="cuda", dtype=torch.bfloat16,
                           seed=0)
    with cs.route_env(cs.DEFAULT):
        rec, _, _ = cs.run_generation(models, "generate")
    out.update({k: rec[k] for k in ("ok", "wall_s", "img_per_s")},
               k1_launches=rec["launches"]["K1"])
    qmodels = quantize_unet_int8(models)
    del models
    with cs.route_env(cs.INT8):
        qrec, _, _ = cs.run_generation(qmodels, "int8")
    out.update(int8_ok=qrec["ok"], int8_wall_s=qrec["wall_s"],
               k7_launches=qrec["launches"]["K7"])
    print(json.dumps(out))
    return 0 if rec["ok"] and qrec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
