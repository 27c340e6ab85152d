"""Forward-noising (training side) of the latent diffusion process
(layoutllm_t2i_tpu/diffusion/ddpm.py; reference GLIGEN/ldm/models/diffusion/
ldm.py:19-22 over the schedule registered in ddpm.py:19-54)."""
from __future__ import annotations

import torch

from ..ops.schedules import DDPMSchedule


def q_sample(schedule: DDPMSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(abar_t) x_0 + sqrt(1-abar_t) eps, with t: (B,) ints."""
    dev = x_start.device
    sa = torch.as_tensor(schedule.sqrt_alphas_cumprod, device=dev)[t]
    s1m = torch.as_tensor(schedule.sqrt_one_minus_alphas_cumprod, device=dev)[t]
    shape = (-1,) + (1,) * (x_start.ndim - 1)
    return sa.reshape(shape) * x_start + s1m.reshape(shape) * noise
