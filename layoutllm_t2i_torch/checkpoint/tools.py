"""Checkpoint surgery (layoutllm_t2i_tpu/checkpoint/tools.py).

Reference: GLIGEN/convert_ckpt.py:5-38, which grows the UNet's first conv
from 4 to 4+5 input channels for inpainting init; the new channels are zero,
so the model's output does not change until they are trained.
"""
from __future__ import annotations

from typing import Dict

import torch

FIRST_CONV = "input_blocks.0.0.weight"


def grow_first_conv(unet_sd: Dict[str, torch.Tensor],
                    additional_channels: int = 5) -> Dict[str, torch.Tensor]:
    """A copy of the UNet state dict whose first conv (OIHW) has
    ``additional_channels`` zero input channels appended."""
    w = unet_sd[FIRST_CONV]
    cout, cin, kh, kw = w.shape
    grown = w.new_zeros((cout, cin + additional_channels, kh, kw))
    grown[:, :cin] = w
    return {**unet_sd, FIRST_CONV: grown}
