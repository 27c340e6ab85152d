"""AutoencoderKL (SD f8/z4 VAE) decode path (layoutllm_t2i_tpu/models/vae.py;
reference GLIGEN/ldm/modules/diffusionmodules/model.py Decoder:462,
ResnetBlock:82, AttnBlock:150). All norms are GroupNorm(32, eps=1e-6) with
f32 statistics. Activations NCHW in channels_last memory.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..ops import nn
from ..ops.attention import multi_head_attention
from . import initializers as init


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    embed_dim: int = 4
    z_channels: int = 4
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    scale_factor: float = 0.18215
    double_z: bool = True


def _gn(p, x, silu: bool = False):
    return nn.group_norm(p, x, num_groups=32, eps=1e-6, silu=silu)


def resnet_block(p, x):
    h = nn.conv2d(p["conv1"], _gn(p["norm1"], x, silu=True))
    h = nn.conv2d(p["conv2"], _gn(p["norm2"], h, silu=True))
    if "nin_shortcut" in p:
        x = nn.conv2d(p["nin_shortcut"], x, padding=0)
    return x + h


def attn_block(p, x):
    """Single-head spatial self-attention (model.py:150-202)."""
    h, w = x.shape[2:]
    hn = _gn(p["norm"], x)
    q = nn.to_rows(nn.conv2d(p["q"], hn, padding=0))
    k = nn.to_rows(nn.conv2d(p["k"], hn, padding=0))
    v = nn.to_rows(nn.conv2d(p["v"], hn, padding=0))
    out = multi_head_attention(q, k, v, num_heads=1)
    return x + nn.conv2d(p["proj_out"], nn.from_rows(out, h, w), padding=0)


def vae_upsample(p, x):
    return nn.conv2d(p["conv"], nn.nearest_upsample_2x(x), padding=1)


def decoder_apply(p, cfg: VAEConfig, z):
    h = nn.conv2d(p["conv_in"], z)
    h = resnet_block(p["mid"]["block_1"], h)
    h = attn_block(p["mid"]["attn_1"], h)
    h = resnet_block(p["mid"]["block_2"], h)
    for i_level in reversed(range(len(cfg.ch_mult))):
        lvl = p["up"][str(i_level)]
        for i_block in range(cfg.num_res_blocks + 1):
            h = resnet_block(lvl["block"][str(i_block)], h)
        if i_level != 0:
            h = vae_upsample(lvl["upsample"], h)
    return nn.conv2d(p["conv_out"], _gn(p["norm_out"], h, silu=True))


def decode(params, cfg: VAEConfig, z):
    """Scaled latent (B, 4, h, w) channels_last -> image (B, 3, 8h, 8w)."""
    z = nn.conv2d(params["post_quant_conv"], z / cfg.scale_factor, padding=0)
    return decoder_apply(params["decoder"], cfg, z)


def _init_resnet_block(ini, cin, cout):
    p = {
        "norm1": init.norm_p(ini, cin),
        "conv1": init.conv_p(ini, 3, 3, cin, cout),
        "norm2": init.norm_p(ini, cout),
        "conv2": init.conv_p(ini, 3, 3, cout, cout),
    }
    if cin != cout:
        p["nin_shortcut"] = init.conv_p(ini, 1, 1, cin, cout)
    return p


def _init_attn_block(ini, c):
    return {
        "norm": init.norm_p(ini, c),
        "q": init.conv_p(ini, 1, 1, c, c),
        "k": init.conv_p(ini, 1, 1, c, c),
        "v": init.conv_p(ini, 1, 1, c, c),
        "proj_out": init.conv_p(ini, 1, 1, c, c),
    }


def init_vae_params(ini: init.Init, cfg: VAEConfig):
    """The full AutoencoderKL tree (encoder included), so reference
    checkpoints load strict; only the decoder runs in the port so far."""
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    down = {}
    block_in = cfg.ch
    for i_level in range(len(cfg.ch_mult)):
        block_in = cfg.ch * in_ch_mult[i_level]
        block_out = cfg.ch * cfg.ch_mult[i_level]
        blocks = {}
        for i_block in range(cfg.num_res_blocks):
            blocks[str(i_block)] = _init_resnet_block(ini, block_in, block_out)
            block_in = block_out
        lvl = {"block": blocks}
        if i_level != len(cfg.ch_mult) - 1:
            lvl["downsample"] = {"conv": init.conv_p(ini, 3, 3, block_in, block_in)}
        down[str(i_level)] = lvl

    z2 = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
    encoder = {
        "conv_in": init.conv_p(ini, 3, 3, cfg.in_channels, cfg.ch),
        "down": down,
        "mid": {
            "block_1": _init_resnet_block(ini, block_in, block_in),
            "attn_1": _init_attn_block(ini, block_in),
            "block_2": _init_resnet_block(ini, block_in, block_in),
        },
        "norm_out": init.norm_p(ini, block_in),
        "conv_out": init.conv_p(ini, 3, 3, block_in, z2),
    }

    block_in = cfg.ch * cfg.ch_mult[-1]
    up = {}
    dec_block_in = block_in
    for i_level in reversed(range(len(cfg.ch_mult))):
        block_out = cfg.ch * cfg.ch_mult[i_level]
        blocks = {}
        for i_block in range(cfg.num_res_blocks + 1):
            blocks[str(i_block)] = _init_resnet_block(ini, dec_block_in, block_out)
            dec_block_in = block_out
        lvl = {"block": blocks}
        if i_level != 0:
            lvl["upsample"] = {"conv": init.conv_p(ini, 3, 3, dec_block_in,
                                                   dec_block_in)}
        up[str(i_level)] = lvl

    decoder = {
        "conv_in": init.conv_p(ini, 3, 3, cfg.z_channels, block_in),
        "mid": {
            "block_1": _init_resnet_block(ini, block_in, block_in),
            "attn_1": _init_attn_block(ini, block_in),
            "block_2": _init_resnet_block(ini, block_in, block_in),
        },
        "up": up,
        "norm_out": init.norm_p(ini, dec_block_in),
        "conv_out": init.conv_p(ini, 3, 3, dec_block_in, cfg.out_ch),
    }
    return {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": init.conv_p(ini, 1, 1, z2, 2 * cfg.embed_dim),
        "post_quant_conv": init.conv_p(ini, 1, 1, cfg.embed_dim, cfg.z_channels),
    }
