#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (layoutllm_t2i_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py
Phases, in order; each prints JSON lines and any failure exits non-zero:

  1. build     nvcc-builds the four kernel libraries from csrc/ (sm_90a),
               prints build seconds, ptxas lines and the card's name and
               power limit.
  2. kernels   every kernel (K1 flash attention, K2 GroupNorm, K3 LayerNorm,
               K4 LN+GEGLU FF) against its plain PyTorch version on the card,
               in bf16, at the main-path shapes of a 2-request batch (CFG
               batch 4); times kernel, plain version and one PyTorch library
               call for the same function, beside the roofline bound.
  3. unet      one full-width UNet forward through the kernels and again
               through the plain versions (fuser and relation alphas set to
               0.5 first: random init leaves them 0, which would hide a
               fuser fault behind tanh(0) = 0).
  4. generate  random_models() at full SD-1.4 width in bf16, then PLMS-50,
               CFG 7.5, alpha (0.3, 0, 0.7), vae_chunk 8 on 2 requests;
               checks shape, finiteness and range; counts kernel launches.
  5. the `kernels` JSON line, then the card line, then the result line.
     In that line `ms`, `plain_ms`, `library_ms` and `bound_ms` are sums
     over the kernel's distinct main-path shapes (one call at each, as
     timed in phase 2); `launches` counts phase 4's run alone.

With `--profile OUT.json`, one more generation runs under torch.profiler
after phase 4 and prints device time by kernel group and the device's idle
share; OUT.json gets the per-kernel table.

The script imports nothing of JAX or of the JAX package. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

H100_BF16_FLOPS = 989e12    # dense bf16 tensor-core peak, H100 SXM
H100_HBM_BYTES = 3.35e12    # HBM3 bytes/s, H100 SXM

# kernel vs plain version: the tolerances stated in
# layoutllm_t2i_torch/kernels/tolerance.py (element-wise atol + rtol*|b|,
# K1's atol a fraction of the output's rms, and a whole-tensor rms bound)
# full-width UNet forward, kernel route vs plain route: max |a-b| / max |b|
UNET_REL_TOL = 5e-2

KERNEL_META = {
    "K1": ("flash_attention", "layoutllm_t2i_torch/csrc/flash_attention.cu",
           "layoutllm_t2i_tpu/ops/pallas/flash_attention.py:349"),
    "K2": ("group_norm", "layoutllm_t2i_torch/csrc/group_norm.cu",
           "layoutllm_t2i_tpu/ops/pallas/norms.py:120"),
    "K3": ("layer_norm", "layoutllm_t2i_torch/csrc/layer_norm.cu",
           "layoutllm_t2i_tpu/ops/pallas/norms.py:333"),
    "K4": ("ffn_ln_geglu", "layoutllm_t2i_torch/csrc/ffn.cu",
           "layoutllm_t2i_tpu/ops/pallas/ffn.py:182"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


# ---------------------------------------------------------------------------
# timing and bounds


def time_ms(fn, target_ms: float = 60.0) -> float:
    """Mean device ms per call: warm-up, then CUDA events around a run of
    launches sized to ~target_ms."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    once = max(e0.elapsed_time(e1), 1e-3)
    iters = int(min(200, max(3, target_ms / once)))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(flops: float, nbytes: float):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_mem = nbytes / H100_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# ---------------------------------------------------------------------------
# main-path shapes (2 requests -> CFG batch 4)


def kernel_cases(unet_cfg, vae_cfg, prompts: int = 2):
    """(kid, label, shape-args) at every distinct main-path shape."""
    from layoutllm_t2i_torch.models.unet import input_block_specs, output_block_specs

    b2 = 2 * prompts
    lat = unet_cfg.image_size
    cases = []
    # K1: the flash-routed sites (N >= 512, M >= 128, no mask)
    for n, m, heads, d, b in ((4096, 4096, 8, 40, b2), (4126, 4126, 8, 40, b2),
                              (1024, 1024, 8, 80, b2), (1054, 1054, 8, 80, b2),
                              (4096, 4096, 1, 512, prompts)):
        cases.append(("K1", f"B{b} N{n} M{m} H{heads} d{d}", (b, n, m, heads, d)))
    # K2: every GroupNorm of the UNet and of the VAE decoder
    gn = []
    for kind, ci, co, ds in input_block_specs(unet_cfg):
        hw = (lat // ds) ** 2
        if kind in ("res", "res_st"):
            gn += [(b2, hw, ci, 1e-5, True), (b2, hw, co, 1e-5, True)]
        if kind == "res_st":
            gn.append((b2, hw, co, 1e-6, False))
    mid = unet_cfg.model_channels * unet_cfg.channel_mult[-1]
    hw8 = (lat // 2 ** (len(unet_cfg.channel_mult) - 1)) ** 2
    gn += [(b2, hw8, mid, 1e-5, True), (b2, hw8, mid, 1e-6, False)]
    for kind, ci, _skip, co, _up, ds in output_block_specs(unet_cfg):
        hw = (lat // ds) ** 2
        gn += [(b2, hw, ci, 1e-5, True), (b2, hw, co, 1e-5, True)]
        if kind == "res_st":
            gn.append((b2, hw, co, 1e-6, False))
    gn.append((b2, lat * lat, unet_cfg.model_channels, 1e-5, True))
    ch = [vae_cfg.ch * m for m in vae_cfg.ch_mult]
    side = lat
    gn += [(prompts, side * side, ch[-1], 1e-6, True),
           (prompts, side * side, ch[-1], 1e-6, False)]
    block_in = ch[-1]
    for i_level in reversed(range(len(ch))):
        for _ in range(vae_cfg.num_res_blocks + 1):
            gn += [(prompts, side * side, block_in, 1e-6, True),
                   (prompts, side * side, ch[i_level], 1e-6, True)]
            block_in = ch[i_level]
        if i_level:
            side *= 2
    for args in sorted(set(gn)):
        n, hw, c, eps, silu = args
        cases.append(("K2", f"N{n} HW{hw} C{c} eps{eps:g} silu{int(silu)}", args))
    # K3: every LayerNorm width and row count; CLIP encodes the prompts
    # (and the empty uncond prompts) in a batch of 2, and the 5 phrases +
    # 3 relation texts of phase_generate in one batch of 8
    ln = [(b2 * 4096, 320), (b2 * 4126, 320), (b2 * 1024, 640),
          (b2 * 1054, 640), (b2 * 256, 1280), (b2 * 286, 1280),
          (b2 * 64, 1280), (b2 * 94, 1280), (b2 * 30, 320), (b2 * 30, 640),
          (b2 * 30, 1280), (8 * 77, 768), (prompts * 77, 768)]
    for rows, c in ln:
        cases.append(("K3", f"rows{rows} C{c}", (rows, c)))
    # K4: every FF site (norm3, s = 1; the fuser FF, s = scale*tanh(alpha))
    for hw, k in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        for s in (1.0, 0.5):
            cases.append(("K4", f"M{b2 * hw} K{k} s{s:g}", (b2 * hw, k, s)))
    return cases


def make_case(kid, args, dev, gen):
    """(kernel_fn, plain_fn, library_fn, flops, bytes) on fresh bf16 inputs."""
    from layoutllm_t2i_torch import kernels as K

    bf = torch.bfloat16
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    if kid == "K1":
        b, n, m, h, d = args
        q, k, v = rnd(b, n, h * d), rnd(b, m, h * d), rnd(b, m, h * d)
        sc = d ** -0.5
        heads = lambda t: t.view(t.shape[0], t.shape[1], h, d).transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                     scale=sc)
        flops = 4.0 * b * h * n * m * d
        nbytes = 2.0 * (2 * b * n * h * d + 2 * b * m * h * d)
        return (lambda: K.flash_attention(q, k, v, h, sc),
                lambda: K.flash_attention_plain(q, k, v, h, sc), lib, flops, nbytes)
    if kid == "K2":
        n, hw, c, eps, silu = args
        x = rnd(n, hw, c, scale=2.0) + 0.5
        w, bb = rnd(c, scale=0.5) + 1.0, rnd(c, scale=0.5)
        side = int(math.isqrt(hw))

        def lib():
            y = F.group_norm(x.view(n, side, side, c).permute(0, 3, 1, 2), 32,
                             w, bb, eps)
            return F.silu(y) if silu else y
        return (lambda: K.group_norm(x, w, bb, 32, eps, silu),
                lambda: K.group_norm_plain(x, w, bb, 32, eps, silu), lib,
                10.0 * x.numel(), 2.0 * (2 * x.numel() + 2 * c))
    if kid == "K3":
        rows, c = args
        x = rnd(rows, c, scale=2.0) + 0.5
        w, bb = rnd(c, scale=0.5) + 1.0, rnd(c, scale=0.5)
        return (lambda: K.layer_norm(x, w, bb, 1e-5),
                lambda: K.layer_norm_plain(x, w, bb, 1e-5),
                lambda: F.layer_norm(x, (c,), w, bb, 1e-5),
                8.0 * x.numel(), 2.0 * (2 * x.numel() + 2 * c))
    m, k, s = args
    inner = 4 * k
    x = rnd(m, k)
    lw, lb = rnd(k, scale=0.2) + 1.0, rnd(k, scale=0.2)
    w1, b1 = rnd(2 * inner, k, scale=k ** -0.5), rnd(2 * inner, scale=0.1)
    w2, b2 = rnd(k, inner, scale=inner ** -0.5), rnd(k, scale=0.1)
    s_t = torch.tensor(s, device=dev, dtype=torch.float32)

    def lib():
        a, g = F.linear(F.layer_norm(x, (k,), lw, lb, 1e-5), w1, b1).chunk(2, -1)
        return x + s * F.linear(a * F.gelu(g), w2, b2)
    flops = 6.0 * m * k * inner
    nbytes = 2.0 * (2 * m * k + 3 * inner * k + 2 * inner + 3 * k)
    return (lambda: K.ffn_ln_geglu(x, lw, lb, w1, b1, w2, b2, s_t),
            lambda: K.ffn_ln_geglu_plain(x, lw, lb, w1, b1, w2, b2, s_t),
            lib, flops, nbytes)


# ---------------------------------------------------------------------------
# phases


def phase_build():
    from layoutllm_t2i_torch.kernels import build

    t0 = time.perf_counter()
    log = build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libs": log})


def phase_kernels(unet_cfg, vae_cfg):
    from layoutllm_t2i_torch.kernels.tolerance import agreement

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    summary = {kid: {"max_abs_err": 0.0, "max_rel_err": 0.0,
                     "rms_rel_err": 0.0, "ms": 0.0,
                     "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                     "ops_ms": 0.0, "bytes_ms": 0.0, "shapes": 0}
               for kid in KERNEL_META}
    failed = []
    for kid, label, args in kernel_cases(unet_cfg, vae_cfg):
        kern, plain, lib, flops, nbytes = make_case(kid, args, dev, gen)
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        agree = agreement(kid, out, ref)
        del out, ref
        b_ms, b_by = bound(flops, nbytes)
        rec = {"phase": "kernels", "kernel": kid, "shape": label, **agree,
               "ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
        emit(rec)
        agg = summary[kid]
        for key in ("max_abs_err", "max_rel_err", "rms_rel_err"):
            agg[key] = max(agg[key], agree[key])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            agg[key] += rec[key]
        agg["ops_ms"] += flops / H100_BF16_FLOPS * 1e3
        agg["bytes_ms"] += nbytes / H100_HBM_BYTES * 1e3
        agg["shapes"] += 1
        if not agree["ok"]:
            failed.append(f"{kid} {label}")
        torch.cuda.empty_cache()
    if failed:
        raise SmokeFailure(f"kernel disagrees with its plain version: {failed}")
    return summary


def set_alphas(tree, value: float) -> int:
    n = 0
    for name, p in tree.named_parameters():
        if name.endswith(("alpha_attn", "alpha_dense")):
            p.data.fill_(value)
            n += 1
    return n


def phase_unet(models):
    from layoutllm_t2i_torch.kernels import plain_route
    from layoutllm_t2i_torch.models.unet import unet_apply

    dev, dt = models.device, models.compute_dtype
    cfg = models.unet_cfg
    n_alpha = set_alphas(models.unet_params, 0.5)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    b = 4
    x = rnd(b, 4, cfg.image_size, cfg.image_size).to(dt).contiguous(
        memory_format=torch.channels_last)
    t = torch.tensor([981, 981, 501, 501], device=dev)
    ctx = (rnd(b, 77, cfg.context_dim) * 0.5).to(dt)
    boxes = torch.zeros(b, 30, 4, device=dev)
    boxes[:, 0] = torch.tensor([0.1, 0.2, 0.5, 0.9])
    boxes[:, 1] = torch.tensor([0.55, 0.1, 0.95, 0.6])
    boxes[:, 2] = torch.tensor([0.3, 0.5, 0.7, 0.95])
    masks = torch.zeros(b, 30, device=dev)
    masks[:, :3] = 1
    pos = (rnd(b, 30, cfg.grounding_in_dim) * 0.5).to(dt)
    rel = (rnd(b, 5, cfg.context_dim) * 0.5).to(dt)
    run = lambda: unet_apply(models.unet_params, cfg, x, t, ctx, boxes, masks,
                             pos, rel, fuser_scale=1.0)
    with torch.no_grad():
        out = run().float()
        with plain_route():
            ref = run().float()
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(ref).all())
    diff = float((out - ref).abs().max())
    rel_err = diff / max(float(ref.abs().max()), 1e-6)
    ok = finite and rel_err <= UNET_REL_TOL
    emit({"phase": "unet", "ok": ok, "alphas_set": n_alpha, "shape": list(out.shape),
          "max_abs_diff": diff, "ref_max_abs": float(ref.abs().max()),
          "rel_err": rel_err, "tol_rel": UNET_REL_TOL})
    if not ok:
        raise SmokeFailure("UNet forward: kernel route disagrees with plain route")


# PLMS steps of the generation phases: the whole script runs well inside the
# time limit at the full 50, so the step count is never lowered
STEPS = 50

# two requests: a prompt, 2-3 boxes with phrases, 1-2 relation texts each
REQUESTS = (
    ["a dog chasing a red ball on the grass",
     "a cat sitting on a wooden chair next to a lamp"],
    [([[0.05, 0.4, 0.55, 0.95], [0.6, 0.6, 0.85, 0.85]],
      ["a dog", "a red ball"]),
     ([[0.2, 0.1, 0.6, 0.6], [0.15, 0.4, 0.7, 0.98], [0.7, 0.05, 0.95, 0.7]],
      ["a cat", "a wooden chair", "a lamp"])],
    [["dog chasing ball"], ["cat on chair", "lamp next to chair"]],
)


def exact_pipeline(models):
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    return InferencePipeline(models, steps=STEPS, sampler="plms",
                             guidance_scale=7.5, alpha_type=(0.3, 0.0, 0.7),
                             vae_chunk=8)


def phase_generate(models):
    from layoutllm_t2i_torch.kernels import launch_counts, reset_launches
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    pipe = exact_pipeline(models)
    prompts, layouts, relations = REQUESTS
    # warm-up at 2 steps: cuDNN algorithm selection and the first kernel
    # launches stay out of the timed run
    InferencePipeline(models, steps=2, alpha_type=(0.5, 0.0, 0.5),
                      vae_chunk=8).generate(prompts, layouts, relations, seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    img = pipe.generate(prompts, layouts, relations, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    ok = (img.shape == (2, 512, 512, 3) and bool(np.isfinite(img).all())
          and float(img.min()) >= 0.0 and float(img.max()) <= 1.0)
    grounded = int((pipe.tables.fuser_scale != 0).sum())
    emit({"phase": "generate", "ok": ok, "steps": STEPS,
          "shape": list(img.shape), "min": float(img.min()),
          "max": float(img.max()), "mean": float(img.mean()),
          "std_across_images": float(img.std(axis=0).mean()),
          "wall_s": wall, "img_per_s": len(prompts) / wall,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "unet_evals": STEPS + 1, "grounded_steps": grounded,
          "launches": counts})
    if not ok:
        raise SmokeFailure("generation output is not a finite (2,512,512,3) "
                           "image batch in [0, 1]")
    return counts


# device-time groups of the profile, matched in order against kernel names
PROFILE_GROUPS = (
    ("K1 flash_attention", ("flash_fwd_kernel",)),
    ("K2 group_norm", ("gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")),
    ("K3 layer_norm", ("ln_kernel",)),
    ("K4 ffn_ln_geglu", ("ffn_up_kernel", "ffn_down_kernel")),
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "nhwc", "fprop")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")),
    ("softmax", ("softmax",)),
)


def phase_profile(models, out_path: str) -> None:
    """One more generation under torch.profiler, tracing the device only
    (each kernel counted once, and little host overhead): device time by
    kernel group and the device's idle share of the wall time; the full
    per-kernel table goes to ``out_path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe = exact_pipeline(models)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(*REQUESTS, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:
            continue  # a host op: its kernels are listed on their own
        if evt.self_device_time_total > 0:
            rows.append({"name": evt.key, "calls": evt.count,
                         "device_ms": evt.self_device_time_total / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for r in rows:
        low = r["name"].lower()
        name = next((g for g, keys in PROFILE_GROUPS
                     if any(k in low for k in keys)), "other")
        groups[name] += r["device_ms"]
    busy = sum(groups.values())
    summary = {"phase": "profile", "steps": STEPS, "wall_ms": wall * 1e3,
               "device_busy_ms": busy,
               "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
               "device_ms_by_group": groups}
    with open(out_path, "w") as f:
        json.dump({**summary, "kernels": rows}, f, indent=1)
    emit(summary)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="JSON",
                    help="after the checks, profile one more generation "
                         "and write its per-kernel device times here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from layoutllm_t2i_torch.models.unet import UNetConfig
        from layoutllm_t2i_torch.models.vae import VAEConfig
        from layoutllm_t2i_torch.pipeline.loaders import random_models
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0))})
    try:
        phase_build()
        summary = phase_kernels(UNetConfig(), VAEConfig())
        models = random_models(small=False, device="cuda", dtype=torch.bfloat16,
                               seed=0)
        phase_unet(models)
        counts = phase_generate(models)
        if args.profile:
            phase_profile(models, args.profile)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    missing = [kid for kid, n in counts.items() if n <= 0]
    line = []
    for kid, (name, src, replaces) in KERNEL_META.items():
        s = summary[kid]
        line.append({"name": f"{kid} {name}", "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[kid],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": ("operations" if s["ops_ms"] >= s["bytes_ms"]
                                  else "bytes"),
                     "library_ms": s["library_ms"], "shapes": s["shapes"]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    if missing:
        print(f"chip_smoke: FAILED: no launches of {missing} on the main path",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
