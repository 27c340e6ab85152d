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
- one timed 2-request PLMS-50 generation at full SD-1.4 width
  (chip_smoke.run_generation): wall seconds, images/s and K1 launches.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

# (B, N = M, H, d): the generation's K1 calls (CFG batch 4; the VAE at 2)
K1_SHAPES = ((4, 4096, 8, 40), (4, 4126, 8, 40), (4, 1024, 8, 80),
             (4, 1054, 8, 80), (2, 4096, 1, 512))
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from layoutllm_t2i_torch.kernels import build
    from layoutllm_t2i_torch.kernels.flash_attention import flash_attention
    from layoutllm_t2i_torch.pipeline.loaders import random_models

    build.build_all()
    out = {"k1": []}
    with torch.no_grad():
        for b, n, h, d in K1_SHAPES:
            host_us, dev_ms, asleep = k1_timing(flash_attention, b, n, h, d)
            out["k1"].append({"shape": f"B{b} N{n} H{h} d{d}",
                              "host_us": host_us, "device_ms": dev_ms,
                              "sleep_outlasted_host": asleep})
    models = random_models(small=False, device="cuda", dtype=torch.bfloat16,
                           seed=0)
    with cs.route_env(cs.DEFAULT):
        rec, _, _ = cs.run_generation(models, "generate")
    out.update({k: rec[k] for k in ("ok", "wall_s", "img_per_s")},
               k1_launches=rec["launches"]["K1"])
    print(json.dumps(out))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
