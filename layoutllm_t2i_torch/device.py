"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. Without
a card that is an error, not a quiet run on the CPU: the CPU runs only the
plain versions of the kernels and is chosen by passing ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "layoutllm_t2i_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


def default_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (the kernels' operand type), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
