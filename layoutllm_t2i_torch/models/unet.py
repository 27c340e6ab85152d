"""Relation-aware GLIGEN UNet (SD-1.x skeleton) as a function over params
(layoutllm_t2i_tpu/models/unet.py; reference GLIGEN openaimodel.py:234-459).

Parameters are nested under the reference torch names (input_blocks.1.0.
in_layers...); activations are NCHW in channels_last memory. The per-step
grounding alpha arrives as ``fuser_scale``; the alpha==0 first-conv restore
is the caller's weight select (pipeline.inference.make_cfg_denoiser).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import nn
from ..ops.schedules import timestep_embedding
from . import initializers as init
from .blocks import init_spatial_transformer, spatial_transformer
from .position_net import init_position_net, position_net


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    image_size: int = 64
    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    transformer_depth: int = 1
    context_dim: int = 768
    fuser_type: str = "gatedSA"
    grounding_in_dim: int = 768
    grounding_out_dim: int = 768
    use_relation_attention: bool = True


def input_block_specs(cfg: UNetConfig):
    """Mirror of the torch constructor loop (openaimodel.py:306-332): a list
    over input_blocks of (kind, ch_in, ch_out, ds), kind in
    'conv' | 'res' | 'res_st' | 'down'."""
    specs = [("conv", cfg.in_channels, cfg.model_channels, 1)]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            out_ch = mult * cfg.model_channels
            kind = "res_st" if ds in cfg.attention_resolutions else "res"
            specs.append((kind, ch, out_ch, ds))
            ch = out_ch
        if level != len(cfg.channel_mult) - 1:
            specs.append(("down", ch, ch, ds))
            ds *= 2
    return specs


def output_block_specs(cfg: UNetConfig):
    """Mirror of openaimodel.py:357-380: a list of
    (kind, ch_in, skip_ch, ch_out, upsample, ds)."""
    chans = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            ch = mult * cfg.model_channels
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            chans.append(ch)
            ds *= 2
    specs = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            out_ch = cfg.model_channels * mult
            kind = "res_st" if ds in cfg.attention_resolutions else "res"
            upsample = bool(level and i == cfg.num_res_blocks)
            specs.append((kind, ch + ich, ich, out_ch, upsample, ds))
            ch = out_ch
            if upsample:
                ds //= 2
    return specs


# ---------------------------------------------------------------------------
# res block (openaimodel.py:117-231, use_scale_shift_norm=False)


def res_block(p, x, emb):
    h = nn.group_norm(p["in_layers"]["0"], x, silu=True)
    h = nn.conv2d(p["in_layers"]["2"], h)
    emb_out = nn.linear(p["emb_layers"]["1"], nn.silu(emb))
    h = h + emb_out[:, :, None, None].to(h.dtype)
    h = nn.group_norm(p["out_layers"]["0"], h, silu=True)
    h = nn.conv2d(p["out_layers"]["3"], h)
    if "skip_connection" in p:
        x = nn.conv2d(p["skip_connection"], x, padding=0)
    return x + h


def init_res_block(ini, ch_in, ch_out, emb_ch):
    p = {
        "in_layers": {"0": init.norm_p(ini, ch_in),
                      "2": init.conv_p(ini, 3, 3, ch_in, ch_out)},
        "emb_layers": {"1": init.linear_p(ini, emb_ch, ch_out)},
        "out_layers": {"0": init.norm_p(ini, ch_out),
                       "3": init.conv_p(ini, 3, 3, ch_out, ch_out)},
    }
    if ch_in != ch_out:
        p["skip_connection"] = init.conv_p(ini, 1, 1, ch_in, ch_out)
    return p


def downsample(p, x):
    return nn.conv2d(p["op"], x, stride=2, padding=1)


def upsample(p, x):
    return nn.conv2d(p["conv"], nn.nearest_upsample_2x(x), padding=1)


# ---------------------------------------------------------------------------
# full UNet


def init_unet_params(ini: init.Init, cfg: UNetConfig):
    if cfg.fuser_type != "gatedSA":
        raise NotImplementedError(f"fuser_type {cfg.fuser_type!r} is not ported")
    emb_ch = cfg.model_channels * 4
    params = {
        "time_embed": {
            "0": init.linear_p(ini, cfg.model_channels, emb_ch),
            "2": init.linear_p(ini, emb_ch, emb_ch),
        },
        "position_net": init_position_net(ini, cfg.grounding_in_dim,
                                          cfg.grounding_out_dim),
    }

    def st(ch):
        return init_spatial_transformer(
            ini, ch, cfg.context_dim, cfg.context_dim, cfg.num_heads,
            ch // cfg.num_heads, cfg.transformer_depth,
            cfg.use_relation_attention)

    inblocks = {}
    for idx, (kind, ci, co, _ds) in enumerate(input_block_specs(cfg)):
        blk = {}
        if kind == "conv":
            blk["0"] = init.conv_p(ini, 3, 3, ci, co)
        elif kind == "down":
            blk["0"] = {"op": init.conv_p(ini, 3, 3, ci, co)}
        else:
            blk["0"] = init_res_block(ini, ci, co, emb_ch)
            if kind == "res_st":
                blk["1"] = st(co)
        inblocks[str(idx)] = blk
    params["input_blocks"] = inblocks

    mid_ch = cfg.model_channels * cfg.channel_mult[-1]
    params["middle_block"] = {
        "0": init_res_block(ini, mid_ch, mid_ch, emb_ch),
        "1": st(mid_ch),
        "2": init_res_block(ini, mid_ch, mid_ch, emb_ch),
    }

    outblocks = {}
    for idx, (kind, ci, _skip, co, up, _ds) in enumerate(output_block_specs(cfg)):
        blk = {"0": init_res_block(ini, ci, co, emb_ch)}
        nxt = 1
        if kind == "res_st":
            blk[str(nxt)] = st(co)
            nxt += 1
        if up:
            blk[str(nxt)] = {"conv": init.conv_p(ini, 3, 3, co, co)}
        outblocks[str(idx)] = blk
    params["output_blocks"] = outblocks

    params["out"] = {
        "0": init.norm_p(ini, cfg.model_channels),
        "2": init.conv_p(ini, 3, 3, cfg.model_channels, cfg.out_channels),
    }
    return params


def unet_apply(
    params,
    cfg: UNetConfig,
    x: torch.Tensor,                 # (B, C, H, W) channels_last noisy latent
    timesteps: torch.Tensor,         # (B,) int
    context: torch.Tensor,           # (B, 77, context_dim)
    boxes: torch.Tensor,             # (B, MO, 4) xyxy normalized
    masks: torch.Tensor,             # (B, MO)
    positive_embeddings: torch.Tensor,   # (B, MO, grounding_in_dim)
    relations: torch.Tensor,         # (B, R, context_dim)
    fuser_scale: float = 1.0,
    objs: Optional[torch.Tensor] = None,  # precomputed grounding tokens
    skip_gated: bool = False,        # fuser_scale == 0 for this step
):
    """One eps-prediction forward (openaimodel.py:413-459). Returns
    (B, out_channels, H, W) channels_last."""
    if skip_gated:
        # grounding tokens feed only the gated fusers: with those elided,
        # position_net is dead compute too
        objs = None
    elif objs is None:
        objs = position_net(params["position_net"], boxes, masks,
                            positive_embeddings)
    objs = None if objs is None else objs.to(x.dtype)

    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = nn.linear(params["time_embed"]["0"], t_emb)
    emb = nn.linear(params["time_embed"]["2"], nn.silu(emb))

    def run_st(p_st, h):
        return spatial_transformer(
            p_st, h, context, objs, relations, boxes, masks, cfg.num_heads,
            fuser_scale, cfg.transformer_depth,
            use_rela=cfg.use_relation_attention, skip_gated=skip_gated)

    h = x
    hs = []
    for idx, (kind, _ci, _co, _ds) in enumerate(input_block_specs(cfg)):
        blk = params["input_blocks"][str(idx)]
        if kind == "conv":
            h = nn.conv2d(blk["0"], h, padding=1)
        elif kind == "down":
            h = downsample(blk["0"], h)
        else:
            h = res_block(blk["0"], h, emb)
            if kind == "res_st":
                h = run_st(blk["1"], h)
        hs.append(h)

    mid = params["middle_block"]
    h = res_block(mid["0"], h, emb)
    h = run_st(mid["1"], h)
    h = res_block(mid["2"], h, emb)

    for idx, (kind, _ci, _skip, _co, up, _ds) in enumerate(output_block_specs(cfg)):
        blk = params["output_blocks"][str(idx)]
        h = torch.cat([h, hs.pop()], dim=1).contiguous(memory_format=nn.CL)
        h = res_block(blk["0"], h, emb)
        nxt = 1
        if kind == "res_st":
            h = run_st(blk[str(nxt)], h)
            nxt += 1
        if up:
            h = upsample(blk[str(nxt)], h)

    h = nn.group_norm(params["out"]["0"], h, silu=True)
    return nn.conv2d(params["out"]["2"], h)
