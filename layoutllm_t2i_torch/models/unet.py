"""Relation-aware GLIGEN UNet (SD-1.x skeleton) as a function over params
(layoutllm_t2i_tpu/models/unet.py; reference GLIGEN openaimodel.py:234-459).

Parameters are nested under the reference torch names (input_blocks.1.0.
in_layers...); activations are NCHW in channels_last memory. The per-step
grounding alpha arrives as ``fuser_scale``; the alpha==0 first-conv restore
is the caller's weight select (pipeline.inference.make_cfg_denoiser).

The grounding tokenizer follows ``grounding_type``: box + text ("text"),
box + text + image ("text_image"), person keypoints ("keypoint") or a
condition map's ConvNeXt tokens ("map"). Extra input channels are
concatenated onto the latent before the first conv: a grounding
downsampler's (``additional_in_channels``), then an inpainting UNet's
masked latent and mask (``inpaint_mode``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import nn
from ..ops.schedules import timestep_embedding
from ..parallel import tp
from . import initializers as init
from .blocks import init_spatial_transformer, spatial_transformer
from .position_net import (init_position_net, init_position_net_text_image,
                           position_net, position_net_text_image)


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
    inpaint_mode: bool = False
    # extra input channels concatenated by a grounding downsampler
    additional_in_channels: int = 0
    grounding_in_dim: int = 768
    grounding_out_dim: int = 768
    # LayoutLLM-T2I's relation-aware layer; False = the vanilla GLIGEN UNet
    use_relation_attention: bool = True
    # grounding tokenizer family: text | text_image | keypoint | map
    grounding_type: str = "text"
    max_persons_per_image: int = 8  # keypoint mode only

    @property
    def first_conv_in_channels(self) -> int:
        in_c = self.in_channels + self.additional_in_channels
        if self.inpaint_mode:
            in_c += self.in_channels + 1
        return in_c

    @property
    def first_conv_restorable(self) -> bool:
        """Whether SD's 4-channel first conv can stand in at alpha 0."""
        return not self.inpaint_mode


def input_block_specs(cfg: UNetConfig):
    """Mirror of the torch constructor loop (openaimodel.py:306-332): a list
    over input_blocks of (kind, ch_in, ch_out, ds), kind in
    'conv' | 'res' | 'res_st' | 'down'."""
    specs = [("conv", cfg.first_conv_in_channels, cfg.model_channels, 1)]
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


def init_position_net_for(ini: init.Init, cfg: UNetConfig):
    """The grounding tokenizer's parameters for ``cfg.grounding_type``."""
    if cfg.grounding_type == "text":
        return init_position_net(ini, cfg.grounding_in_dim, cfg.grounding_out_dim)
    if cfg.grounding_type == "text_image":
        return init_position_net_text_image(ini, cfg.grounding_in_dim,
                                            cfg.grounding_out_dim)
    if cfg.grounding_type == "keypoint":
        from .grounding_extras import init_position_net_keypoint

        return init_position_net_keypoint(ini, cfg.max_persons_per_image,
                                          cfg.grounding_out_dim)
    if cfg.grounding_type == "map":
        from .grounding_extras import init_position_net_map

        return init_position_net_map(ini, cfg.grounding_out_dim)
    raise ValueError(f"unknown grounding_type {cfg.grounding_type}")


def apply_position_net(params, cfg: UNetConfig, boxes, masks,
                       positive_embeddings, extra_grounding=None):
    """The grounding tokens of ``cfg.grounding_type``. text_image reads
    ``extra_grounding``'s text_masks, image_masks and image_embeddings; map
    its cond_map (B, H, W, 3) and map_mask (B,); in keypoint mode ``boxes``
    carries the (B, P*17, 2) points and ``masks`` their validity."""
    if cfg.grounding_type == "text":
        return position_net(params, boxes, masks, positive_embeddings)
    eg = extra_grounding or {}
    if cfg.grounding_type == "text_image":
        return position_net_text_image(
            params, boxes, masks, eg["text_masks"], eg["image_masks"],
            positive_embeddings, eg["image_embeddings"])
    if cfg.grounding_type == "keypoint":
        from .grounding_extras import position_net_keypoint

        return position_net_keypoint(params, boxes, masks,
                                     cfg.max_persons_per_image,
                                     cfg.grounding_out_dim)
    if cfg.grounding_type == "map":
        from .grounding_extras import position_net_map

        return position_net_map(params, eg["cond_map"], eg["map_mask"])
    raise ValueError(f"unknown grounding_type {cfg.grounding_type}")


def init_unet_params(ini: init.Init, cfg: UNetConfig):
    emb_ch = cfg.model_channels * 4
    params = {
        "time_embed": {
            "0": init.linear_p(ini, cfg.model_channels, emb_ch),
            "2": init.linear_p(ini, emb_ch, emb_ch),
        },
        "position_net": init_position_net_for(ini, cfg),
    }

    def st(ch):
        return init_spatial_transformer(
            ini, ch, cfg.context_dim, cfg.context_dim, cfg.num_heads,
            ch // cfg.num_heads, cfg.transformer_depth,
            cfg.use_relation_attention, cfg.fuser_type)

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
    inpainting_extra: Optional[torch.Tensor] = None,  # (B, C+1, H, W)
    grounding_extra: Optional[torch.Tensor] = None,   # (B, extra, H, W)
    extra_grounding: Optional[dict] = None,   # text_image / map inputs
    objs: Optional[torch.Tensor] = None,  # precomputed grounding tokens
    skip_gated: bool = False,        # fuser_scale == 0 for this step
    encoder_cache: Optional[dict] = None,     # propagated-step reuse
    return_encoder_cache: bool = False,
):
    """One eps-prediction forward (openaimodel.py:413-459). Returns
    (B, out_channels, H, W) channels_last. ``grounding_extra`` (the
    downsampled condition map) and then, in ``inpaint_mode``,
    ``inpainting_extra`` (the masked latent and its mask) are concatenated
    onto x's channels, NCHW like x.

    Encoder propagation ("Faster Diffusion", arXiv:2312.09608; opt-in, no
    reference counterpart): ``return_encoder_cache=True`` also returns
    ``{"hs": tuple, "mid_in": h}``, the skip features and the middle
    block's input; ``encoder_cache`` (the same structure) skips
    ``input_blocks`` entirely, the first conv included, and runs the
    middle block and the decoder on the cached features. Mutually
    exclusive."""
    if skip_gated:
        # grounding tokens feed only the gated fusers: with those elided,
        # position_net is dead compute too
        objs = None
    elif objs is None:
        objs = apply_position_net(params["position_net"], cfg, boxes, masks,
                                  positive_embeddings, extra_grounding)
    objs = None if objs is None else objs.to(x.dtype)

    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = nn.linear(params["time_embed"]["0"], t_emb)
    emb = nn.linear(params["time_embed"]["2"], nn.silu(emb))

    def run_st(p_st, h):
        return spatial_transformer(
            p_st, h, context, objs, relations, boxes, masks, cfg.num_heads,
            fuser_scale, cfg.transformer_depth,
            use_rela=cfg.use_relation_attention, skip_gated=skip_gated,
            fuser_type=cfg.fuser_type)

    if encoder_cache is not None:
        if return_encoder_cache:
            raise ValueError("encoder_cache and return_encoder_cache are "
                             "mutually exclusive")
        hs = list(encoder_cache["hs"])
        h = encoder_cache["mid_in"]
    else:
        h = x
        extras = [e for e in (grounding_extra,
                              inpainting_extra if cfg.inpaint_mode else None)
                  if e is not None]
        if cfg.inpaint_mode and inpainting_extra is None:
            raise ValueError("an inpaint_mode UNet needs inpainting_extra")
        if extras:
            h = torch.cat([h] + [e.to(h.dtype) for e in extras],
                          dim=1).contiguous(memory_format=nn.CL)
        # 'spatial' TP: this rank's block of the latent's rows from here on
        # (whole where they do not split); the output is gathered whole
        h = tp.shard_rows(h)
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
    cache = {"hs": tuple(hs), "mid_in": h} if return_encoder_cache else None

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
    h = tp.gather_rows(nn.conv2d(params["out"]["2"], h))
    return (h, cache) if return_encoder_cache else h
