"""Time K2 on the card along every plan it can take at a few shapes.

Run from the repository root on a machine with one H100:
  python3 layoutllm_t2i_torch/cli/group_norm_sweep.py
``kernels/group_norm.py plan_group_norm`` picks one plan per (N, HW, C, G).
This script forces, at each shape below (G = 32, SiLU on), every on-chip
plan (each slab of at most 640 channels, each portable cluster of 1-8
blocks whose rows fit shared memory) and the streaming plan aimed at 1, 2
(the shipped aim) and 4 blocks an SM, checks each output against the plain
version and prints one JSON line per shape: device µs a call of each plan,
timed twice behind a device-side sleep (``chip_smoke.device_time``), the
planner's choice and the plan of the least mean. Exits 1 if any plan disagrees with the plain
version.
"""
from __future__ import annotations

import json
import os
import sys

import torch

# the UNet's levels at batch 4 and 8 (those with 128 clusters of one slab
# each among them), the VAE decoder's
SHAPES = ((4, 4096, 320), (4, 4096, 640), (4, 4096, 960), (4, 1024, 640),
          (4, 1024, 1280), (4, 256, 1280), (4, 256, 2560), (4, 64, 1280),
          (8, 4096, 960), (8, 1024, 640), (8, 256, 1920), (2, 16384, 512),
          (2, 65536, 256), (2, 262144, 128))
GROUPS = 32
WAVES = (1, 2, 4)


def plans(gn, n, hw, c):
    """{label: plan}: the on-chip plans, then the streaming ones."""
    cg = c // GROUPS
    out = {}
    for slab in (s for s in gn.slabs(c, GROUPS) if s <= 640):
        for k in range(1, gn.MAX_CLUSTER + 1):
            rows = -(-hw // k)
            if -(-hw // rows) == k and gn.cluster_smem_bytes(rows, slab, cg) <= gn.SMEM_MAX:
                out[f"s{slab}k{k}"] = gn.GNPlan("cluster", slab, k, rows, 0, 0)
    base = gn.stream_plan(n, hw, c, GROUPS)
    for waves in WAVES:
        target = waves * gn.SMS
        chunks = min(hw, max(1, -(-target // (n * (c // base.slab)))))
        rows = -(-hw // chunks)
        apply_rows = -(-hw // min(hw, max(1, -(-target // n))))
        out[f"stream{waves}"] = base._replace(rows=rows, chunks=-(-hw // rows),
                                              apply_rows=apply_rows)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("group_norm_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import importlib

    import chip_smoke as cs
    from layoutllm_t2i_torch.kernels.tolerance import agreement

    gn = importlib.import_module("layoutllm_t2i_torch.kernels.group_norm")
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ok = True
    for n, hw, c in SHAPES:
        x = (torch.randn(n, hw, c, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        w = (torch.randn(c, generator=gen, device=dev) * 0.5 + 1).to(torch.bfloat16)
        b = (torch.randn(c, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        ref = gn.group_norm_plain(x, w, b, GROUPS, 1e-5, True)
        shipped = gn.plan_group_norm(n, hw, c, GROUPS)
        forced = plans(gn, n, hw, c)
        chosen = next((k for k, p in forced.items() if p == shipped), "planned")
        forced.setdefault(chosen, shipped)
        us = {}
        for name, plan in forced.items():
            run = lambda plan=plan: gn.launch(x, w, b, GROUPS, 1e-5, True, plan)
            agree = agreement("K2", run(), ref)["ok"]
            ok = ok and agree
            us[name] = ([round(cs.device_time(run, 20.0)[0] * 1e3, 2) for _ in range(2)]
                        if agree else "disagrees")
        timed = {k: sum(v) / 2 for k, v in us.items() if not isinstance(v, str)}
        best = min(timed, key=timed.get)
        print(json.dumps({"shape": [n, hw, c], "bound_us": round(4.0 * x.numel() / cs.H100_HBM_BYTES * 1e6, 2),
                          "planned": chosen, "planned_us": us[chosen],
                          "best": best, "best_us": us[best], "us": us}), flush=True)
        del x, ref
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
