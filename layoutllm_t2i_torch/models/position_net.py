"""Box + text grounding tokenizer (layoutllm_t2i_tpu/models/position_net.py
``position_net``; GLIGEN text_grounding_net.py:6-43).

Boxes are Fourier-embedded, padding slots take the learnable null
embeddings, and a 3-layer SiLU MLP emits the grounding tokens.
"""
from __future__ import annotations

import torch

from ..ops import nn
from ..ops.schedules import fourier_embed
from . import initializers as init


def position_net(p, boxes: torch.Tensor, masks: torch.Tensor,
                 positive_embeddings: torch.Tensor,
                 fourier_freqs: int = 8) -> torch.Tensor:
    """boxes: (B, N, 4); masks: (B, N); positive_embeddings: (B, N, in_dim)."""
    dtype = positive_embeddings.dtype
    m = masks[..., None].to(dtype)
    xyxy = fourier_embed(boxes, num_freqs=fourier_freqs).to(dtype)
    pos_null = p["null_positive_feature"].reshape(1, 1, -1).to(dtype)
    xyxy_null = p["null_position_feature"].reshape(1, 1, -1).to(dtype)
    positive = positive_embeddings * m + (1 - m) * pos_null
    xyxy = xyxy * m + (1 - m) * xyxy_null
    h = torch.cat([positive, xyxy], dim=-1)
    h = nn.silu(nn.linear(p["linears"]["0"], h))
    h = nn.silu(nn.linear(p["linears"]["2"], h))
    return nn.linear(p["linears"]["4"], h)


def init_position_net(ini: init.Init, in_dim: int = 768, out_dim: int = 768,
                      fourier_freqs: int = 8):
    position_dim = fourier_freqs * 2 * 4
    return {
        "linears": {
            "0": init.linear_p(ini, in_dim + position_dim, 512),
            "2": init.linear_p(ini, 512, 512),
            "4": init.linear_p(ini, 512, out_dim),
        },
        "null_positive_feature": init.zeros_p(ini, (in_dim,)),
        "null_position_feature": init.zeros_p(ini, (position_dim,)),
    }
