"""Box + text and box + text + image grounding tokenizers
(layoutllm_t2i_tpu/models/position_net.py; GLIGEN text_grounding_net.py:6-43,
text_image_grounding_net.py:9-65).

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


def position_net_text_image(p, boxes: torch.Tensor, masks: torch.Tensor,
                            text_masks: torch.Tensor, image_masks: torch.Tensor,
                            text_embeddings: torch.Tensor,
                            image_embeddings: torch.Tensor,
                            fourier_freqs: int = 8) -> torch.Tensor:
    """The text + image grounding tokenizer (layoutllm_t2i_tpu/models/
    position_net.py ``position_net_text_image``; GLIGEN
    text_image_grounding_net.py:9-65). Emits 2N tokens: N text-grounded,
    then N image-grounded."""
    dtype = text_embeddings.dtype
    m = masks[..., None].to(dtype)
    tm = text_masks[..., None].to(dtype)
    im = image_masks[..., None].to(dtype)
    xyxy = fourier_embed(boxes, num_freqs=fourier_freqs).to(dtype)
    text_null = p["null_text_feature"].reshape(1, 1, -1).to(dtype)
    image_null = p["null_image_feature"].reshape(1, 1, -1).to(dtype)
    xyxy_null = p["null_position_feature"].reshape(1, 1, -1).to(dtype)
    text = text_embeddings * tm + (1 - tm) * text_null
    image = image_embeddings.to(dtype) * im + (1 - im) * image_null
    xyxy = xyxy * m + (1 - m) * xyxy_null

    def mlp(q, h):
        h = nn.silu(nn.linear(q["0"], h))
        h = nn.silu(nn.linear(q["2"], h))
        return nn.linear(q["4"], h)

    objs_text = mlp(p["linears_text"], torch.cat([text, xyxy], dim=-1))
    objs_image = mlp(p["linears_image"], torch.cat([image, xyxy], dim=-1))
    return torch.cat([objs_text, objs_image], dim=1)


def init_position_net_text_image(ini: init.Init, in_dim: int = 768,
                                 out_dim: int = 768, fourier_freqs: int = 8):
    position_dim = fourier_freqs * 2 * 4

    def mlp():
        return {"0": init.linear_p(ini, in_dim + position_dim, 512),
                "2": init.linear_p(ini, 512, 512),
                "4": init.linear_p(ini, 512, out_dim)}

    return {
        "linears_text": mlp(),
        "linears_image": mlp(),
        "null_text_feature": init.zeros_p(ini, (in_dim,)),
        "null_image_feature": init.zeros_p(ini, (in_dim,)),
        "null_position_feature": init.zeros_p(ini, (position_dim,)),
    }
