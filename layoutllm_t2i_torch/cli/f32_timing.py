"""Time the f32 forms of K1, K5a, K5b, K4, K6, K7, K8a and K8b of one
checkout on the card, for an A/B of two commits.

Run from the root of a checkout, naming this file by its path:
  python3 <other checkout>/layoutllm_t2i_torch/cli/f32_timing.py [--reps R]
      [--only K1 K5a K5b K4 K6 K7 K8a K8b]
It times the checkout in the working directory (its port and its
chip_smoke.py), not the one that holds this file, so one call to the card
can run it in turns from the roots of two checkouts (parent, change,
change, parent) and compare them on the same card. It prints one JSON
line: the card's name and power limit, and for each main-path shape of
K1/f32 (the f32 generation's, d 40, 80 and 512, and the f32 trainings',
with and without the lse), of K5a/f32 and K5b/f32 (the f32 trainings'
backward: d 40 and 80 at batch 8), of K4/f32 (the f32 generation's and the
f32 training's), of K7/f32 (the f32 int8 generation's), and of K6/f32,
K8a/f32 and K8b/f32 (the split routes' f32 training): the kernel's device
ms a call and the wrapper's host us
(chip_smoke.device_time, the best of R runs), the library call's device
ms (SDPA, SDPA's whole backward for K5a and K5b, F.linear, or the FF or
GEGLU as its F.layer_norm / F.linear / F.gelu chain, in f32 with
allow_tf32 off, as phase `kernels` times it), the roofline bound at the
TF32 peak, and the kernel's agreement with its plain version under the f32
tolerance rows. After K5a and K5b of a shape, a "K5 pair/f32" row holds
their sum against SDPA's backward, with the bound of the function the pair
computes (chip_smoke.pair_work), as phase `kernels`' "K5 pair f32" rows.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# (B, N, M, H, d[, "lse"]): K1/f32's cases in chip_smoke's phase `kernels`
K1_F32 = ((4, 4096, 4096, 8, 40), (4, 4126, 4126, 8, 40),
          (4, 1024, 1024, 8, 80), (4, 1054, 1054, 8, 80),
          (2, 4096, 4096, 1, 512), (8, 4096, 4096, 1, 512),
          (8, 4096, 4096, 8, 40), (8, 4126, 4126, 8, 40),
          (8, 4096, 4096, 8, 40, "lse"), (8, 4126, 4126, 8, 40, "lse"),
          (8, 1024, 1024, 8, 80, "lse"), (8, 1054, 1054, 8, 80, "lse"))
# (B, N, M, H, d): K5a/f32's and K5b/f32's, the f32 trainings' backward at
# the 64^2 (ungated and gated) and 32^2 sites
K5_F32 = ((8, 4096, 4096, 8, 40), (8, 4126, 4126, 8, 40),
          (8, 1024, 1024, 8, 80), (8, 1054, 1054, 8, 80))
# (M, K, s): K4/f32's, the f32 generation's (CFG batch 4) and the f32
# training's (batch 8) LN + FF sites, s = 1 (norm3) and 0.5 (the fuser)
K4_F32 = tuple((m, k, s) for m, k in ((16384, 320), (4096, 640), (1024, 1280),
                                      (32768, 320), (8192, 640), (2048, 1280))
               for s in (0.5, 1.0))
# (M, K, s): K7/f32's, the f32 int8 generation's (CFG batch 4) LN + FF
# sites on int8 weights, s = 1 (norm3) and 0.5 (the fuser)
K7_F32 = tuple((m, k, s) for m, k in ((16384, 320), (4096, 640), (1024, 1280))
               for s in (0.5, 1.0))
# (M, K): K6/f32's, the split routes' norm3 FF sites at batch 8
K6_F32 = ((32768, 320), (8192, 640), (2048, 1280))
# (M, K, N): K8a/f32's, the fuser FF down-projections at batch 8
K8A_F32 = ((32768, 1280, 320), (8192, 2560, 640), (2048, 5120, 1280))
# (M, K, N): K8b/f32's, the split routes' fuser FF up-projections at batch 8
K8B_F32 = ((32768, 320, 1280), (8192, 640, 2560), (2048, 1280, 5120))
CASES = {"K1": K1_F32, "K5a": K5_F32, "K5b": K5_F32, "K4": K4_F32,
         "K6": K6_F32, "K7": K7_F32, "K8a": K8A_F32, "K8b": K8B_F32}


def pair_row(cs, dq, dkv, case) -> dict:
    """K5a + K5b at one shape against SDPA's whole backward (both rows time
    that one call: their mean), bound by the pair's function, counted
    once (chip_smoke.pair_work)."""
    b_ms, b_by = cs.bound(*cs.pair_work(case), cs.flops_peak("K5a", case))
    dev_ms = dq["device_ms"] + dkv["device_ms"]
    lib_ms = 0.5 * (dq["library_device_ms"] + dkv["library_device_ms"])
    return {"kernel": "K5 pair/f32", "shape": dq["shape"], "device_ms": dev_ms,
            "host_us": dq["host_us"] + dkv["host_us"],
            "library_device_ms": lib_ms, "device_vs_library": dev_ms / lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "ok": dq["ok"] and dkv["ok"],
            "rms_rel_err": max(dq["rms_rel_err"], dkv["rms_rel_err"]),
            "max_rel_err": max(dq["max_rel_err"], dkv["max_rel_err"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3,
                    help="device timings a shape (the best is kept)")
    ap.add_argument("--only", nargs="+", choices=tuple(CASES), default=None,
                    help="the kernels to time (default: all eight)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from layoutllm_t2i_torch.kernels.tolerance import agreement, tol_id

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = [(kid, a + ("f32",)) for kid, shapes in CASES.items()
             if args.only is None or kid in args.only for a in shapes]
    rows = []
    for kid, case in cases:
        kern, plain, lib, flops, nbytes = cs.make_case(kid, case, dev, gen)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        tid = ((tol_id("K1", torch.float32), tol_id("lse", torch.float32))
               if cs.has_lse(case) else tol_id(kid, torch.float32))
        agree = agreement(tid, out, ref)
        del out, ref
        timed = [cs.device_time(kern) for _ in range(args.reps)]
        lib_ms = min(cs.library_ms(lib, cs.device_ms) for _ in range(args.reps))
        b_ms, b_by = cs.bound(flops, nbytes, cs.flops_peak(kid, case))
        dev_ms = min(t[0] for t in timed)
        rows.append({"kernel": f"{kid}/f32", "shape": cs.case_label(kid, case),
                     "device_ms": dev_ms, "host_us": min(t[1] for t in timed),
                     "library_device_ms": lib_ms, "device_vs_library": dev_ms / lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "ok": agree["ok"],
                     "rms_rel_err": agree["rms_rel_err"],
                     "max_rel_err": agree["max_rel_err"]})
        del kern, plain, lib
        torch.cuda.empty_cache()
    dq_rows = {r["shape"]: r for r in rows if r["kernel"] == "K5a/f32"}
    rows += [pair_row(cs, dq_rows[r["shape"]], r, case)
             for (kid, case), r in zip(cases, list(rows))
             if kid == "K5b" and r["shape"] in dq_rows]
    sums = {}
    for r in rows:
        s = sums.setdefault(r["kernel"], {"device_ms": 0.0, "library_device_ms": 0.0,
                                          "bound_ms": 0.0})
        for key in s:
            s[key] += r[key]
    print(json.dumps({"tree": os.getcwd(), "card": cs.nvidia_smi_line(),
                      "rows": rows, "sums": sums}), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
