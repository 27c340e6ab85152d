"""Analytic FLOP count of a generation, and MFU.

The JAX package counts FLOPs by walking a jaxpr
(layoutllm_t2i_tpu/utils/flops.py). This module counts the same work from
the model configs instead: 2*M*N*K for every matmul (projections, the
attention products, the relation fuser's two region products, the FF
GEMMs, the time embedding and PositionNet MLPs) and
2*out_elems*k_spatial*in_ch for every convolution. Elementwise work
(softmax, norms, GELU, the sampler's updates) is left out, as there: MFU
is the matmul share of the bf16 tensor-core peak.

It counts the work the model needs, unpadded. At full width the JAX count
of a TPU program also charges its Pallas kernels' lane padding (a
pallas_call counts its kernel's jaxpr times its grid); that difference is
not reproduced. It counts every UNet evaluation the sampler makes,
PLMS's Heun warm start included, which the JAX walker's ``cond_mode="min"``
leaves out (one evaluation of a PLMS-50 generation's 51).

``unet_evaluations`` lists a pipeline's UNet evaluations from its own step
tables; ``generation_flops`` sums one ``InferencePipeline.sample_latents``
call: the grounding tokens, every evaluation, and the VAE decode in chunks.
"""
from __future__ import annotations

import math
import os

import numpy as np

# dense bf16 tensor-core peak of an H100 SXM, TFLOP/s
H100_BF16_TFLOPS = 989.0
FOURIER_FREQS = 8       # PositionNet's box embedding (position_net.py)


def _linear(rows, din, dout) -> float:
    return 2.0 * rows * din * dout


def _conv(b, hw_out, cin, cout, k=3) -> float:
    return 2.0 * b * hw_out * cout * k * k * cin


def _attention(b, n, m, c, kv_dim) -> float:
    """q from n rows of width c, k and v from m rows of width kv_dim, the
    two N x M products over all heads (width c), the output projection."""
    return (_linear(b * n, c, c) + 2 * _linear(b * m, kv_dim, c)
            + 2 * 2.0 * b * n * m * c + _linear(b * n, c, c))


def _geglu_ff(rows, c) -> float:
    return _linear(rows, c, 8 * c) + _linear(rows, 4 * c, c)


def _res_block(b, hw, ci, co, emb_ch) -> float:
    f = _conv(b, hw, ci, co) + _linear(b, emb_ch, co) + _conv(b, hw, co, co)
    if ci != co:
        f += _conv(b, hw, ci, co, k=1)
    return f


def _spatial_transformer(cfg, b, hw, c, n_obj, n_rel, ctx_len,
                         gated: bool) -> float:
    ctx = cfg.context_dim
    f = 2 * _conv(b, hw, c, c, k=1)                    # proj_in, proj_out
    for _ in range(cfg.transformer_depth):
        f += _attention(b, hw, hw, c, c)                # attn1
        if gated:                                       # gated self-attention
            f += _linear(b * n_obj, ctx, c)
            f += _attention(b, hw + n_obj, hw + n_obj, c, c)
            f += _geglu_ff(b * hw, c)
        if cfg.use_relation_attention:                  # relation fuser
            f += 2 * 2.0 * b * n_obj * hw * c           # pool, scatter
            f += _attention(b, n_obj, n_rel, c, ctx)
            f += _geglu_ff(b * n_obj, c)
        f += _attention(b, hw, ctx_len, c, ctx)         # attn2
        f += _geglu_ff(b * hw, c)                       # ff
    return f


def unet_flops(cfg, b: int, n_obj: int, n_rel: int, ctx_len: int,
               gated: bool = True, encoder: bool = True) -> float:
    """One UNet forward at batch b (models/unet.py unet_apply) with the
    grounding tokens given: ``gated=False`` elides the gated fusers (a step
    with grounding alpha 0), ``encoder=False`` skips input_blocks (a
    propagated step of the encoder cache)."""
    from ..models.unet import input_block_specs, output_block_specs

    mc, lat = cfg.model_channels, cfg.image_size
    emb_ch = 4 * mc
    st = lambda hw, c: _spatial_transformer(cfg, b, hw, c, n_obj, n_rel,
                                            ctx_len, gated)
    f = _linear(b, mc, emb_ch) + _linear(b, emb_ch, emb_ch)   # time_embed
    if encoder:
        for kind, ci, co, ds in input_block_specs(cfg):
            hw = (lat // ds) ** 2
            if kind == "conv":
                f += _conv(b, hw, ci, co)
            elif kind == "down":
                f += _conv(b, hw // 4, ci, co)
            else:
                f += _res_block(b, hw, ci, co, emb_ch)
                if kind == "res_st":
                    f += st(hw, co)
    mid = mc * cfg.channel_mult[-1]
    hw = (lat // 2 ** (len(cfg.channel_mult) - 1)) ** 2
    f += 2 * _res_block(b, hw, mid, mid, emb_ch) + st(hw, mid)
    for kind, ci, _skip, co, up, ds in output_block_specs(cfg):
        hw = (lat // ds) ** 2
        f += _res_block(b, hw, ci, co, emb_ch)
        if kind == "res_st":
            f += st(hw, co)
        if up:
            f += _conv(b, 4 * hw, co, co)
    return f + _conv(b, lat * lat, mc, cfg.out_channels)


def position_net_flops(cfg, rows: int) -> float:
    """PositionNet's MLP on ``rows`` grounding slots (models/position_net.py)."""
    din = cfg.grounding_in_dim + FOURIER_FREQS * 2 * 4
    return (_linear(rows, din, 512) + _linear(rows, 512, 512)
            + _linear(rows, 512, cfg.grounding_out_dim))


def _vae_res(b, hw, ci, co) -> float:
    f = _conv(b, hw, ci, co) + _conv(b, hw, co, co)
    return f + (_conv(b, hw, ci, co, k=1) if ci != co else 0.0)


def vae_decode_flops(cfg, b: int, side: int) -> float:
    """models/vae.py decode of b latents of side x side."""
    c = cfg.ch * cfg.ch_mult[-1]
    hw = side * side
    f = _conv(b, hw, cfg.z_channels, cfg.z_channels, k=1)       # post_quant
    f += _conv(b, hw, cfg.z_channels, c)                        # conv_in
    # mid: two res blocks around single-head attention (1x1 q, k, v, proj)
    f += 2 * _vae_res(b, hw, c, c) + 4 * _conv(b, hw, c, c, k=1)
    f += 2 * 2.0 * b * hw * hw * c
    for i in reversed(range(len(cfg.ch_mult))):
        co = cfg.ch * cfg.ch_mult[i]
        for _ in range(cfg.num_res_blocks + 1):
            f += _vae_res(b, hw, c, co)
            c = co
        if i:
            hw *= 4
            f += _conv(b, hw, c, c)
    return f + _conv(b, hw, c, cfg.out_ch)


def unet_evaluations(pipe, b: int, inpaint: bool = False):
    """(batch, gated, encoder) of every UNet evaluation that ``pipe``'s
    sampler makes for b requests, from its own step tables: CFG steps at
    2b and the guidance interval's cond-only steps at b; steps with
    grounding alpha 0 without the gated fusers; the encoder cache's
    propagated steps without the encoder, unless ``inpaint`` (the cache is
    off under inpainting). PLMS adds its Heun warm start, at step 0's
    batch and alpha, propagated in cached mode."""
    n = len(pipe.tables.t)
    cfg_on = (pipe._cfg_on_steps() if pipe._guidance_interval_on()
              else np.ones(n, dtype=bool))
    if pipe.guidance_scale == 1.0:
        cfg_on = np.zeros(n, dtype=bool)
    cached = bool(pipe.encoder_cache_interval) and not inpaint
    keys = pipe._key_steps() if cached else np.ones(n, dtype=bool)
    gated = np.asarray(pipe.tables.fuser_scale) != 0
    evals = [(2 * b if cfg_on[i] else b, bool(gated[i]), bool(keys[i]))
             for i in range(n)]
    if pipe.sampler == "plms":
        evals.insert(1, evals[0][:2] + (not cached,))
    return evals


def generation_flops(pipe, b: int) -> dict:
    """FLOPs of one ``pipe.sample_latents`` call on b requests, by part:
    ``grounding`` (PositionNet, at the CFG layout when guidance is on),
    ``unet`` (every evaluation of unet_evaluations), ``vae`` (the decode
    in ``pipe.vae_chunk`` chunks) and ``total``."""
    m = pipe.models
    ucfg = m.unet_cfg
    # the text context's rows: the tokenizer's padded length
    ctx_len = int(getattr(m.tokenizer, "max_length", m.clip_cfg.max_length))
    cfg_rows = 2 if pipe.guidance_scale != 1.0 else 1
    grounding = position_net_flops(ucfg, cfg_rows * b * m.max_objs)
    unet = sum(unet_flops(ucfg, batch, m.max_objs, m.max_relas, ctx_len,
                          gated=gated, encoder=encoder)
               for batch, gated, encoder in unet_evaluations(pipe, b))
    chunk = pipe.vae_chunk or b
    vae = sum(vae_decode_flops(m.vae_cfg, min(chunk, b - i), ucfg.image_size)
              for i in range(0, b, chunk))
    return {"grounding": grounding, "unet": unet, "vae": vae,
            "total": grounding + unet + vae}


def peak_tflops() -> float:
    """The card's dense bf16 peak, TFLOP/s: LLT2I_PEAK_TFLOPS if set, else
    the H100 SXM's 989."""
    env = os.environ.get("LLT2I_PEAK_TFLOPS")
    if env:
        return float(env)
    return H100_BF16_TFLOPS


def mfu(flops: float, seconds: float, n_chips: int = 1) -> float:
    """Achieved FLOP/s over the peak: a fraction in [0, ~1]."""
    if seconds <= 0 or not math.isfinite(seconds):
        return 0.0
    return flops / seconds / (peak_tflops() * 1e12 * n_chips)
