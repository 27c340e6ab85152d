#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (layoutllm_t2i_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py
Phases, in order; each prints JSON lines and any failure exits non-zero:

  1. build     nvcc-builds the four kernel libraries from csrc/ (sm_90a),
               prints build seconds, ptxas lines and the card's name and
               power limit.
  2. kernels   every kernel (K1 flash attention, K2 GroupNorm, K3 LayerNorm,
               K4 LN+GEGLU FF, K5a/K5b flash-attention backward) against
               its plain PyTorch version on the card, in bf16, at every
               distinct shape that phases 4 and 6 give it; times kernel,
               plain version and one PyTorch library call for the same
               function, beside the roofline bound.
  3. unet      one full-width UNet forward through the kernels and again
               through the plain versions (fuser and relation alphas set to
               0.5 first: random init leaves them 0, which would hide a
               fuser fault behind tanh(0) = 0).
  4. generate  random_models() at full SD-1.4 width in bf16, then PLMS-50,
               CFG 7.5, alpha (0.3, 0, 0.7), vae_chunk 8 on 2 requests;
               checks shape, finiteness and range; counts kernel launches.
  5. train-grad  one full-width loss backward at batch 2 (f32 master
               weights, bf16 compute, alphas 0.5), kernel route against
               plain route: the relative L2 error of the rela_fuse
               gradients against a stated bound, which a planted fault of
               the K5 backward must exceed.
  6. train     DiffusionTrainer at full width on synthetic 512^2 data: batch
               8, rela_fuse, AdamW, mixed precision, warmup 0, alphas 0.5;
               2 warm-up steps then 5 timed ones; s/step, images/s, peak
               memory, finite losses, every rela_fuse tensor changed and
               every frozen one bit-identical; kernel launches per step.
  7. the `kernels` JSON line, then the card line, then the result line.
     In that line `ms`, `plain_ms`, `library_ms` and `bound_ms` are sums
     over the kernel's distinct main-path shapes (one call at each, as
     timed in phase 2); `launches` adds phase 4's run and phase 6's.

Phase 2's shapes are walked from the model configs (generation_calls,
training_calls): the generation at 2 requests (CFG batch 4), and a
training step at batch 8 with no CFG doubling: the VAE encoder on 512^2
images (K1 at d 512), CLIP on the captions and on the grounding texts,
and the UNet, whose flash sites after the first relation fuser run K1
with its lse (N = M = 4096/4126 at d 40, 1024/1054 at d 80). Each of
those is also a K5a and a K5b case, on the lse and delta of the plain
forward. tests/test_torch_smoke_shapes.py holds the walk against the
calls that a small model makes on the CPU.

With `--profile OUT.json`, one more generation runs under torch.profiler
after phase 4 and prints device time by kernel group and the device's idle
share; OUT.json gets the per-kernel table. One more training step is
profiled likewise after phase 6, into OUT_train.json.

The script imports nothing of JAX or of the JAX package. Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import shutil
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
# full-width loss backward at batch 2, kernel route against plain route:
# ||g_k - g_p|| / ||g_p|| over all rela_fuse gradients. Both round to bf16
# at the same points and differ by summation order through 16 transformer
# blocks forward and back. On the H100 that reads 4.4e-3, and the planted
# K5 fault of TRAIN_GRAD_CAUGHT 4.4e-2 (planted_fault): the bound sits
# between. Those of TRAIN_GRAD_UNSEEN read within 3 % of the kernel route,
# lost in the rounding of the bf16 backward; they are run and reported,
# not bounded: phase 2 and tests/test_torch_kernels.py hold K5 against
# such faults.
TRAIN_GRAD_REL_TOL = 1e-2
TRAIN_GRAD_CAUGHT = ("dk_unscaled",)
TRAIN_GRAD_UNSEEN = ("softmax_scale", "dq_1pct", "dq_kv_tail")

KERNEL_META = {
    "K1": ("flash_attention", "layoutllm_t2i_torch/csrc/flash_attention.cu",
           "layoutllm_t2i_tpu/ops/pallas/flash_attention.py:349"),
    "K2": ("group_norm", "layoutllm_t2i_torch/csrc/group_norm.cu",
           "layoutllm_t2i_tpu/ops/pallas/norms.py:120"),
    "K3": ("layer_norm", "layoutllm_t2i_torch/csrc/layer_norm.cu",
           "layoutllm_t2i_tpu/ops/pallas/norms.py:333"),
    "K4": ("ffn_ln_geglu", "layoutllm_t2i_torch/csrc/ffn.cu",
           "layoutllm_t2i_tpu/ops/pallas/ffn.py:182"),
    "K5a": ("flash_attention_bwd_dq", "layoutllm_t2i_torch/csrc/flash_attention.cu",
            "layoutllm_t2i_tpu/ops/pallas/flash_attention.py:533"),
    "K5b": ("flash_attention_bwd_dkv", "layoutllm_t2i_torch/csrc/flash_attention.cu",
            "layoutllm_t2i_tpu/ops/pallas/flash_attention.py:555"),
}
# the training phases' batch (no CFG doubling), boxes and relation slots
TRAIN_BATCH, TRAIN_MAX_BOXES, TRAIN_MAX_RELATIONS = 8, 30, 10


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
# main-path shapes: every kernel call of a generation and of a training step,
# walked from the model configs in the order the models make them


def attention_calls(b, n, m, heads, c, lse=False):
    """K1 where multi_head_attention routes an unmasked site to it."""
    from layoutllm_t2i_torch.ops.attention import FLASH_MIN_KV, FLASH_MIN_Q_LEN

    if n >= FLASH_MIN_Q_LEN and m >= FLASH_MIN_KV:
        return [("K1", (b, n, m, heads, c // heads) + (("lse",) if lse else ()))]
    return []


def unet_calls(cfg, b, n_obj, n_rel, ctx_len, train=False):
    """One UNet forward at batch b, n_obj grounding tokens, n_rel relations.
    With ``train`` (rela_fuse mode) autograd records every call from the
    first relation fuser on, so the flash sites there take the lse."""
    from layoutllm_t2i_torch.models.unet import input_block_specs, output_block_specs

    lat, heads = cfg.image_size, cfg.num_heads
    calls = []
    grad = False

    def res(hw, ci, co):
        calls.extend([("K2", (b, hw, ci, 1e-5, True)), ("K2", (b, hw, co, 1e-5, True))])

    def st(hw, c):
        nonlocal grad
        calls.append(("K2", (b, hw, c, 1e-6, False)))
        for _ in range(cfg.transformer_depth):
            calls.append(("K3", (b * hw, c)))                        # attn1
            calls.extend(attention_calls(b, hw, hw, heads, c, grad))
            calls.append(("K3", (b * (hw + n_obj), c)))              # fuser
            calls.extend(attention_calls(b, hw + n_obj, hw + n_obj, heads, c, grad))
            calls.append(("K4", (b * hw, c, 0.5)))
            if cfg.use_relation_attention:                           # rela_fuse
                grad = grad or train
                calls.extend([("K3", (b * hw, c)), ("K3", (b * n_obj, c))])
                calls.extend(attention_calls(b, n_obj, n_rel, heads, c, grad))
                calls.append(("K3", (b * n_obj, c)))
            calls.append(("K3", (b * hw, c)))                        # attn2
            calls.extend(attention_calls(b, hw, ctx_len, heads, c, grad))
            calls.append(("K4", (b * hw, c, 1.0)))                   # ff

    for kind, ci, co, ds in input_block_specs(cfg):
        if kind in ("res", "res_st"):
            res((lat // ds) ** 2, ci, co)
        if kind == "res_st":
            st((lat // ds) ** 2, co)
    mid = cfg.model_channels * cfg.channel_mult[-1]
    hw = (lat // 2 ** (len(cfg.channel_mult) - 1)) ** 2
    res(hw, mid, mid)
    st(hw, mid)
    res(hw, mid, mid)
    for kind, ci, _skip, co, _up, ds in output_block_specs(cfg):
        res((lat // ds) ** 2, ci, co)
        if kind == "res_st":
            st((lat // ds) ** 2, co)
    calls.append(("K2", (b, lat * lat, cfg.model_channels, 1e-5, True)))
    return calls


def vae_res_calls(b, hw, ci, co):
    return [("K2", (b, hw, ci, 1e-6, True)), ("K2", (b, hw, co, 1e-6, True))]


def vae_mid_calls(b, hw, c):
    return (vae_res_calls(b, hw, c, c) + [("K2", (b, hw, c, 1e-6, False))]
            + attention_calls(b, hw, hw, 1, c) + vae_res_calls(b, hw, c, c))


def vae_encoder_calls(cfg, b, side):
    """The VAE encoder on (b, 3, side, side) images."""
    calls, block_in = [], cfg.ch
    for i, mult in enumerate(cfg.ch_mult):
        for _ in range(cfg.num_res_blocks):
            calls += vae_res_calls(b, side * side, block_in, cfg.ch * mult)
            block_in = cfg.ch * mult
        if i != len(cfg.ch_mult) - 1:
            side //= 2
    calls += vae_mid_calls(b, side * side, block_in)
    return calls + [("K2", (b, side * side, block_in, 1e-6, True))]


def vae_decoder_calls(cfg, b, side):
    """The VAE decoder on (b, 4, side, side) latents."""
    block_in = cfg.ch * cfg.ch_mult[-1]
    calls = vae_mid_calls(b, side * side, block_in)
    for i in reversed(range(len(cfg.ch_mult))):
        for _ in range(cfg.num_res_blocks + 1):
            calls += vae_res_calls(b, side * side, block_in, cfg.ch * cfg.ch_mult[i])
            block_in = cfg.ch * cfg.ch_mult[i]
        if i:
            side *= 2
    return calls + [("K2", (b, side * side, block_in, 1e-6, True))]


def clip_calls(clip_cfg, rows):
    """The CLIP text encoder on ``rows`` token rows (its attention is
    causal, so masked: it never routes to K1)."""
    return [("K3", (rows, clip_cfg.hidden_size))] * (2 * clip_cfg.num_layers + 1)


def generation_calls(unet_cfg, vae_cfg, clip_cfg, tok_len, requests,
                     vae_chunk, max_objs=30, max_relas=5):
    """InferencePipeline.generate: prompts and empty prompts, then every
    phrase and relation text in one batch, each padded to a power of two;
    the CFG-doubled UNet; the VAE decode in chunks."""
    from layoutllm_t2i_torch.utils.buckets import pow2_bucket

    prompts, layouts, relations = requests
    b = len(prompts)
    n_texts = (sum(len(phrases) for _, phrases in layouts)
               + sum(min(len(r), max_relas) for r in relations))
    calls = 2 * clip_calls(clip_cfg, pow2_bucket(b) * tok_len)
    if n_texts:
        calls += clip_calls(clip_cfg, pow2_bucket(n_texts) * tok_len)
    calls += unet_calls(unet_cfg, 2 * b, max_objs, max_relas, tok_len)
    for i in range(0, b, vae_chunk):
        calls += vae_decoder_calls(vae_cfg, min(vae_chunk, b - i), unet_cfg.image_size)
    return calls


def training_calls(unet_cfg, vae_cfg, clip_cfg, tok_len, batch, max_boxes,
                   max_relations):
    """One DiffusionTrainer step on a host batch: prepare_batch (VAE
    encode, CLIP on the captions, then every phrase and relation text in
    one power-of-two batch) and the UNet forward of the loss."""
    from layoutllm_t2i_torch.pipeline.scene_graph import relation_texts_for_training
    from layoutllm_t2i_torch.utils.buckets import pow2_bucket

    b, side = len(batch["caption"]), batch["image"].shape[1]
    n_texts = (sum(min(len(labels), max_boxes) for labels in batch["labels"])
               + sum(len(relation_texts_for_training(c, max_relations))
                     for c in batch["caption"]))
    calls = vae_encoder_calls(vae_cfg, b, side) + clip_calls(clip_cfg, b * tok_len)
    if n_texts:
        calls += clip_calls(clip_cfg, pow2_bucket(n_texts) * tok_len)
    return calls + unet_calls(unet_cfg, b, max_boxes, max_relations, tok_len,
                              train=True)


def case_label(kid, args):
    if kid in ("K1", "K5a", "K5b"):
        b, n, m, h, d = args[:5]
        return f"B{b} N{n} M{m} H{h} d{d}" + (" lse" if len(args) > 5 else "")
    if kid == "K2":
        n, hw, c, eps, silu = args
        return f"N{n} HW{hw} C{c} eps{eps:g} silu{int(silu)}"
    if kid == "K3":
        return "rows{} C{}".format(*args)
    return "M{} K{} s{:g}".format(*args)


def kernel_cases(paths):
    """(kid, label, args, path names) at every distinct shape of the given
    {path name: calls}; each K1 site with its lse is also a K5a and a K5b
    case (the backward of that site)."""
    where = {}
    for path, calls in paths.items():
        for kid, args in calls:
            where.setdefault((kid, args), []).append(path)
            if kid == "K1" and len(args) > 5:
                for bwd in ("K5a", "K5b"):
                    where.setdefault((bwd, args[:5]), []).append(path)
    order = list(KERNEL_META)
    keys = sorted(where, key=lambda key: order.index(key[0]))
    return [(kid, case_label(kid, args), args, sorted(set(where[kid, args])))
            for kid, args in keys]


def make_case(kid, args, dev, gen):
    """(kernel_fn, plain_fn, library_fn, flops, bytes) on fresh bf16 inputs."""
    from layoutllm_t2i_torch import kernels as K

    bf = torch.bfloat16
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(bf)
    if kid == "K1" and len(args) == 6:
        return make_lse_case(args[:5], dev, rnd)
    if kid in ("K5a", "K5b"):
        return make_bwd_case(kid, args, dev, rnd)
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


def make_lse_case(args, dev, rnd):
    """K1 as the training forward runs it: (out, lse) through the kernel's
    lse output, against the plain forward's (out, lse)."""
    from layoutllm_t2i_torch import kernels as K
    from layoutllm_t2i_torch.kernels.flash_attention import _launch_fwd

    b, n, m, h, d = args
    q, k, v = rnd(b, n, h * d), rnd(b, m, h * d), rnd(b, m, h * d)
    sc = d ** -0.5
    heads = lambda t: t.view(t.shape[0], t.shape[1], h, d).transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                 scale=sc)
    flops = 4.0 * b * h * n * m * d
    nbytes = 2.0 * (2 * b * n * h * d + 2 * b * m * h * d) + 4.0 * b * h * n
    return (lambda: _launch_fwd(q, k, v, h, sc, need_lse=True),
            lambda: K.flash_attention_lse_plain(q, k, v, h, sc), lib, flops,
            nbytes)


def make_bwd_case(kid, args, dev, rnd):
    """K5a (dQ) or K5b (dK, dV) on the lse and delta of the plain forward,
    against the plain backward. The library call is SDPA's whole backward
    (dQ, dK and dV in one call): its forward plus backward, timed as one
    closure, minus its forward, timed alone; both rows list it."""
    from layoutllm_t2i_torch import kernels as K

    b, n, m, h, d = args
    q, k, v = rnd(b, n, h * d), rnd(b, m, h * d), rnd(b, m, h * d)
    dout = rnd(b, n, h * d, scale=0.1)
    sc = d ** -0.5
    out, lse = K.flash_attention_lse_plain(q, k, v, h, sc)
    delta = K.attention_delta(out, dout, h)
    del out
    heads = lambda t: t.view(t.shape[0], t.shape[1], h, d).transpose(1, 2)
    qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
    doh = heads(dout)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=sc)
    lib = (lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), sdpa)
    io = 2.0 * 4 * b * n * h * d + 4.0 * 2 * b * h * n  # q, k, v, dO; lse, delta
    if kid == "K5a":
        # S, dP and dQ: three N x M x d products
        return (lambda: K.flash_attention_bwd_dq(q, k, v, dout, lse, delta, h, sc),
                lambda: K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, h, sc)[0],
                lib, 6.0 * b * h * n * m * d, io + 2.0 * b * n * h * d)
    # S, dP, dV and dK: four
    return (lambda: K.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, h, sc),
            lambda: K.flash_attention_bwd_plain(q, k, v, dout, lse, delta, h, sc)[1:],
            lib, 8.0 * b * h * n * m * d, io + 2.0 * 2 * b * m * h * d)


def library_ms(lib) -> float:
    """ms of one library call; of a (whole, part) pair, whole minus part."""
    if isinstance(lib, tuple):
        whole, part = lib
        return time_ms(whole) - time_ms(part)
    return time_ms(lib)


# ---------------------------------------------------------------------------
# phases


def phase_build():
    from layoutllm_t2i_torch.kernels import build

    t0 = time.perf_counter()
    log = build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libs": log})


def phase_kernels(cases):
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
    for kid, label, args, paths in cases:
        kern, plain, lib, flops, nbytes = make_case(kid, args, dev, gen)
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        # K1 with its lse: the output to K1's tolerance, the lse to its own
        agree = agreement(("K1", "lse") if label.endswith("lse") else kid, out, ref)
        del out, ref
        b_ms, b_by = bound(flops, nbytes)
        rec = {"phase": "kernels", "kernel": kid, "shape": label, "paths": paths,
               **agree,
               "ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": library_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
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
        del kern, plain, lib
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
VAE_CHUNK = 8

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
                             vae_chunk=VAE_CHUNK)


def phase_generate(models):
    from layoutllm_t2i_torch.kernels import launch_counts, reset_launches
    from layoutllm_t2i_torch.pipeline.inference import InferencePipeline

    pipe = exact_pipeline(models)
    prompts, layouts, relations = REQUESTS
    # warm-up at 2 steps: cuDNN algorithm selection and the first kernel
    # launches stay out of the timed run
    InferencePipeline(models, steps=2, alpha_type=(0.5, 0.0, 0.5),
                      vae_chunk=VAE_CHUNK).generate(prompts, layouts, relations,
                                                    seed=3)
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


def synthetic_step_batch(cfg, b: int, dev, gen) -> dict:
    """A full-width training batch of the shapes prepare_batch gives: clean
    latents, CLIP-width context, three boxes with phrases, two relations."""
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    boxes = torch.zeros(b, 30, 4, device=dev)
    boxes[:, :3] = torch.tensor([[0.1, 0.2, 0.5, 0.9], [0.55, 0.1, 0.95, 0.6],
                                 [0.3, 0.5, 0.7, 0.95]], device=dev)
    masks = torch.zeros(b, 30, device=dev)
    masks[:, :3] = 1
    rel = torch.zeros(b, 10, cfg.context_dim, device=dev)
    rel[:, :2] = rnd(b, 2, cfg.context_dim) * 0.5
    z = rnd(b, 4, cfg.image_size, cfg.image_size).contiguous(
        memory_format=torch.channels_last)
    return {"z": z, "context": rnd(b, 77, cfg.context_dim) * 0.5,
            "boxes": boxes, "masks": masks,
            "phrase_embeddings": rnd(b, 30, cfg.grounding_in_dim) * 0.5,
            "relations": rel}


@contextlib.contextmanager
def planted_fault(name: str):
    """Plant fault ``name`` in the K5 wrappers that FlashAttention.backward
    calls; the kernels still launch (and count) as on the kernel route."""
    # the module, not the function the package exports under its name
    fa = importlib.import_module("layoutllm_t2i_torch.kernels.flash_attention")
    dq_fn, dkv_fn = fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv

    def dq(q, k, v, dout, lse, delta, heads, scale):
        if name == "softmax_scale":
            return dq_fn(q, k, v, dout, lse, delta, heads, scale * 1.005)
        if name == "dq_kv_tail":
            m = k.shape[1] - k.shape[1] % 64
            return dq_fn(q, k[:, :m], v[:, :m], dout, lse, delta, heads, scale)
        out = dq_fn(q, k, v, dout, lse, delta, heads, scale)
        return out * 1.01 if name == "dq_1pct" else out

    def dkv(q, k, v, dout, lse, delta, heads, scale):
        if name == "softmax_scale":
            return dkv_fn(q, k, v, dout, lse, delta, heads, scale * 1.005)
        dk, dv = dkv_fn(q, k, v, dout, lse, delta, heads, scale)
        return (dk / scale if name == "dk_unscaled" else dk), dv

    # the wrappers count through their module's names: these get the counts
    dq.launches = dkv.launches = 0
    fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = dq, dkv
    try:
        yield
    finally:
        fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = dq_fn, dkv_fn


def rel_l2(grads, ref) -> float:
    """||g - g_ref|| / ||g_ref|| over all tensors together."""
    num = sum(float((a - b).double().pow(2).sum()) for a, b in zip(grads, ref))
    den = sum(float(b.double().pow(2).sum()) for b in ref)
    return math.sqrt(num / den)


def phase_train_grad():
    """One full-width loss backward at batch 2 through the kernels and
    again through the plain versions, from the same weights and draws;
    then once with each planted K5 fault."""
    from layoutllm_t2i_torch.kernels import launch_counts, plain_route, reset_launches
    from layoutllm_t2i_torch.pipeline.loaders import random_models
    from layoutllm_t2i_torch.training.train_step import TrainStep, TrainStepConfig

    dev = torch.device("cuda")
    models = random_models(small=False, device=dev, dtype=torch.float32, seed=0)
    n_alpha = set_alphas(models.unet_params, 0.5)
    step = TrainStep(TrainStepConfig(unet_cfg=models.unet_cfg,
                                     schedule=models.schedule,
                                     mixed_precision=True, warmup_steps=0),
                     models.unet_params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    batch = synthetic_step_batch(models.unet_cfg, 2, dev, gen)
    t = torch.tensor([801, 301], device=dev)
    noise = torch.randn(batch["z"].shape, generator=gen, device=dev).contiguous(
        memory_format=torch.channels_last)
    keep = torch.ones((), device=dev)
    grads = lambda: step.grads(batch, t, noise, keep)
    reset_launches()
    loss_k, g_k = grads()
    torch.cuda.synchronize()
    counts = launch_counts()
    with plain_route():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    plain_launched = launch_counts() != counts
    rel = rel_l2(g_k, g_p)
    per_tensor = {name: float((a - b).norm() / max(float(b.norm()), 1e-30))
                  for name, a, b in zip(step.params, g_k, g_p)}
    worst = max(per_tensor, key=per_tensor.get)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    del g_k
    faults = {}
    for name in TRAIN_GRAD_CAUGHT + TRAIN_GRAD_UNSEEN:
        with planted_fault(name):
            g_f = grads()[1]
        faults[name] = rel_l2(g_f, g_p)
        del g_f
    ok = (finite and not plain_launched and rel <= TRAIN_GRAD_REL_TOL
          and all(faults[name] > TRAIN_GRAD_REL_TOL for name in TRAIN_GRAD_CAUGHT))
    emit({"phase": "train-grad", "ok": ok, "batch": 2, "alphas_set": n_alpha,
          "trainable_tensors": len(g_p),
          "trainable_params": sum(g.numel() for g in g_p),
          "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
          "grad_rel_l2_err": rel, "tol_rel_l2": TRAIN_GRAD_REL_TOL,
          "planted_fault_rel_l2_err": faults,
          "worst_tensor": worst, "worst_tensor_rel_l2_err": per_tensor[worst],
          "worst_tensor_grad_norm": float(g_p[list(step.params).index(worst)].norm()),
          "grad_norm": math.sqrt(sum(float(g.double().pow(2).sum()) for g in g_p)),
          "launches": counts})
    if not ok:
        raise SmokeFailure("loss backward: the kernel route lies outside the "
                           "bound, a planted fault it must catch inside it, "
                           "or a plain-route call launched a kernel")
    del models, step, g_p
    torch.cuda.empty_cache()


TRAIN_STEPS, TRAIN_WARMUP = 7, 2


def phase_train(work_dir: str):
    """DiffusionTrainer at full width; returns (launch counts, trainer, data
    iterator)."""
    from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
    from layoutllm_t2i_torch.kernels import launch_counts, reset_launches
    from layoutllm_t2i_torch.pipeline.loaders import random_models
    from layoutllm_t2i_torch.training.diffusion_trainer import (
        DiffusionTrainer, TrainerConfig)

    shutil.rmtree(work_dir, ignore_errors=True)  # no auto-resume from a past run
    cfg = TrainerConfig(output_root=work_dir, name="chip_smoke",
                        batch_size=TRAIN_BATCH, total_iters=TRAIN_STEPS,
                        save_every_iters=10 ** 9, log_every=1,
                        warmup_steps=0, trainable_mode="rela_fuse",
                        optimizer="adamw", mixed_precision=True,
                        max_boxes=TRAIN_MAX_BOXES,
                        max_relations=TRAIN_MAX_RELATIONS)
    models = random_models(small=False, device="cuda", dtype=torch.float32,
                           seed=0)
    n_alpha = set_alphas(models.unet_params, 0.5)
    data = synthetic_layout_batches(cfg.batch_size, 512, cfg.max_boxes)
    trainer = DiffusionTrainer(cfg, data, models=models)
    before = {n: p.detach().clone()
              for n, p in trainer.models.unet_params.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    trained = trainer.train_step.params
    changed = sum(not torch.equal(p, before[n]) for n, p in trained.items())
    frozen_same = all(torch.equal(p, before[n]) for n, p in
                      trainer.models.unet_params.named_parameters()
                      if n not in trained)
    del before
    with open(f"{trainer.run_dir}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs]
    timed = [r["sec_per_iter"] for r in recs[TRAIN_WARMUP:]]
    s_step = sum(timed) / len(timed)
    ok = (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses)
          and changed == len(trained) and frozen_same)
    emit({"phase": "train", "ok": ok, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
          "warmup_steps": TRAIN_WARMUP, "alphas_set": n_alpha,
          "s_per_step": s_step, "s_per_step_each": timed,
          "images_per_s": TRAIN_BATCH / s_step,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "wall_s": wall, "losses": losses,
          "trainable_tensors": len(trained),
          "trainable_params": sum(p.numel() for p in trained.values()),
          "trainable_changed": changed, "frozen_bit_identical": frozen_same,
          "launches": counts,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in counts.items()}})
    if not ok:
        raise SmokeFailure("training: a loss is not finite, a rela_fuse "
                           "tensor did not change or a frozen one did")
    return counts, trainer, data


# device-time groups of the profile, matched in order against kernel names
PROFILE_GROUPS = (
    ("K1 flash_attention", ("flash_fwd_kernel",)),
    ("K5a flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K5b flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("K2 group_norm", ("gn_stats_kernel", "gn_finalize_kernel", "gn_apply_kernel")),
    ("K3 layer_norm", ("ln_kernel",)),
    ("K4 ffn_ln_geglu", ("ffn_up_kernel", "ffn_down_kernel")),
    ("convolution", ("conv", "cudnn", "implicit", "winograd", "nhwc", "fprop",
                     "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")),
    ("softmax", ("softmax",)),
)


def profile_device(run, label: str, out_path: str, **extra) -> None:
    """``run()`` once under torch.profiler, tracing the device only (each
    kernel counted once, and little host overhead): device time by kernel
    group and the device's idle share of the wall time; the full
    per-kernel table goes to ``out_path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    summary = {"phase": label, **extra, "wall_ms": wall * 1e3,
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
                         "and one more training step and write their "
                         "per-kernel device times here and to JSON_train")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from layoutllm_t2i_torch.data.synthetic import synthetic_layout_batches
        from layoutllm_t2i_torch.pipeline.loaders import model_configs, random_models
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
    work_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_train")
    try:
        phase_build()
        unet_cfg, vae_cfg, clip_cfg = model_configs(small=False)
        tok_len = clip_cfg.max_length
        train_batch = next(synthetic_layout_batches(TRAIN_BATCH, 512, TRAIN_MAX_BOXES))
        summary = phase_kernels(kernel_cases({
            "generate": generation_calls(unet_cfg, vae_cfg, clip_cfg, tok_len,
                                         REQUESTS, VAE_CHUNK),
            "train": training_calls(unet_cfg, vae_cfg, clip_cfg, tok_len,
                                    train_batch, TRAIN_MAX_BOXES,
                                    TRAIN_MAX_RELATIONS)}))
        del train_batch
        models = random_models(small=False, device="cuda", dtype=torch.bfloat16,
                               seed=0)
        phase_unet(models)
        gen_counts = phase_generate(models)
        if args.profile:
            pipe = exact_pipeline(models)
            profile_device(lambda: pipe.generate(*REQUESTS, seed=0),
                           "profile", args.profile, steps=STEPS)
            del pipe
        del models
        torch.cuda.empty_cache()
        phase_train_grad()
        train_counts, trainer, data = phase_train(work_dir)
        if args.profile:
            it = iter(data)
            profile_device(
                lambda: trainer.train_step(trainer.prepare_batch(next(it)),
                                           trainer.generator),
                "profile-train", os.path.splitext(args.profile)[0] + "_train.json",
                batch=TRAIN_BATCH)
        trainer.close()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    # the generation path launches K1-K4, the training path all six; the
    # line counts both runs
    counts = {kid: gen_counts[kid] + train_counts[kid] for kid in KERNEL_META}
    missing = ([f"{kid} (generate)" for kid in ("K1", "K2", "K3", "K4")
                if gen_counts[kid] <= 0]
               + [f"{kid} (train)" for kid, n in train_counts.items() if n <= 0])
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
