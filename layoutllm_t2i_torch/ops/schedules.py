"""Diffusion schedules and positional embeddings.

The schedule tables are host NumPy (float64 math, float32 results), copied
from layoutllm_t2i_tpu/ops/schedules.py so the port imports nothing of the
JAX package; the embeddings are torch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedule table (float64), matching util.py:30-52 semantics."""
    if schedule == "linear":
        betas = (
            np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


class DDPMSchedule(NamedTuple):
    """Registered DDPM buffers (ddpm.py:19-54), as float32 numpy arrays."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_ddpm_schedule(
    beta_schedule: str = "linear",
    timesteps: int = 1000,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
    v_posterior: float = 0.0,
) -> DDPMSchedule:
    betas = make_beta_schedule(beta_schedule, timesteps, linear_start, linear_end, cosine_s)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev) / (
        1.0 - alphas_cumprod
    ) + v_posterior * betas
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DDPMSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
    )


def make_ddim_timesteps(
    ddim_discr_method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int
) -> np.ndarray:
    """Subset of DDPM timesteps for DDIM/PLMS (util.py:55-69, incl. +1 offset)."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(f"unknown ddim discretization: {ddim_discr_method}")
    # +1 offset per the reference (util.py:66); clamp so step counts that do
    # not divide T cannot index past the schedule
    return np.minimum(ddim_timesteps + 1, num_ddpm_timesteps - 1)


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
):
    """(sigmas, alphas, alphas_prev) per DDIM step (util.py:72-83)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def alpha_generator(length: int, type=None):
    """Three-stage grounding-strength schedule over sampling steps.

    ``type=[p_on, p_decay, p_off]`` (sums to 1): alpha is 1 for the first
    ``p_on`` fraction of steps, linearly decays over ``p_decay``, then 0.
    Matches reference txt2img.py:59-93.
    """
    p_on, p_decay, p_off = type if type is not None else (1, 0, 0)
    assert p_on + p_decay + p_off == 1
    n_on = int(p_on * length)
    n_decay = int(p_decay * length)

    out = np.zeros(length, dtype=np.float64)
    out[:n_on] = 1.0
    if n_decay:
        # the reference builds the ramp as arange(0, 1, 1/n)[::-1], which
        # starts at (n-1)/n and ends at 0 — reproduced exactly
        out[n_on:n_on + n_decay] = np.arange(n_decay, dtype=np.float64)[::-1] / n_decay
    return out.tolist()


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] order (util.py:161-181)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def fourier_embed(x: torch.Tensor, num_freqs: int = 8,
                  temperature: float = 100.0) -> torch.Tensor:
    """Fourier box embedding (util.py:12-26), freq-major with sin and cos
    interleaved per frequency: [sin(f0 x), cos(f0 x), sin(f1 x), ...]."""
    freq_bands = temperature ** (
        torch.arange(num_freqs, dtype=torch.float32, device=x.device) / num_freqs)
    ang = x.float()[..., None, :] * freq_bands[:, None]      # (..., F, D)
    out = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-2)
    return out.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
