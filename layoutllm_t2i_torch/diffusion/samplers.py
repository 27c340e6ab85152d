"""PLMS sampling as a Python step loop (layoutllm_t2i_tpu/diffusion/
samplers.py; reference GLIGEN/ldm/models/diffusion/plms.py).

The JAX package runs one ``lax.scan`` per alpha segment and picks the
warm start and Adams-Bashforth order with ``lax.cond``/``lax.switch``; here
the loop is plain Python over host step tables, so the per-step grounding
alpha, the SD first-conv flag and the segment's denoiser are host values
and no step reads a device scalar back.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.schedules import (
    DDPMSchedule,
    alpha_generator,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)


class StepTables(NamedTuple):
    """Per-step coefficient tables in loop order (t descending), host NumPy."""

    t: np.ndarray               # (S,) int32 current timestep
    t_next: np.ndarray          # (S,) next (smaller) timestep, for Heun
    a_t: np.ndarray             # (S,) f32 alpha_cumprod at t
    a_prev: np.ndarray          # (S,) f32
    sigma: np.ndarray           # (S,) f32
    sqrt_one_minus_at: np.ndarray  # (S,) f32
    fuser_scale: np.ndarray     # (S,) f32 grounding alpha schedule
    use_sd_conv: np.ndarray     # (S,) bool: alpha == 0 -> SD first conv


def make_step_tables(schedule: DDPMSchedule, steps: int, eta: float = 0.0,
                     alpha_type=None) -> StepTables:
    ddim_ts = make_ddim_timesteps("uniform", steps, schedule.num_timesteps)
    n_steps = len(ddim_ts)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        schedule.alphas_cumprod.astype(np.float64), ddim_ts, eta)
    time_range = ddim_ts[::-1].copy()
    t_next = np.concatenate([time_range[1:], time_range[-1:]])
    if alpha_type is not None:
        fuser = np.asarray(alpha_generator(n_steps, list(alpha_type)), dtype=np.float32)
    else:
        fuser = np.ones(n_steps, dtype=np.float32)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return StepTables(
        t=np.asarray(time_range, dtype=np.int32),
        t_next=np.asarray(t_next, dtype=np.int32),
        a_t=f32(alphas[::-1]),
        a_prev=f32(alphas_prev[::-1]),
        sigma=f32(sigmas[::-1]),
        sqrt_one_minus_at=f32(np.sqrt(1.0 - alphas[::-1])),
        fuser_scale=f32(fuser),
        use_sd_conv=(fuser == 0) & (alpha_type is not None),
    )


def _update(x, e_t, a_t, a_prev, sigma, sqrt_1m_at, noise=None):
    """x_prev and pred_x0 from an eps estimate (plms.py:126-140). The
    coefficients are float32 scalars, computed in float32 as on the device
    in the JAX package."""
    a_t, a_prev, sigma, sqrt_1m_at = (np.float32(v) for v in
                                      (a_t, a_prev, sigma, sqrt_1m_at))
    pred_x0 = (x - float(sqrt_1m_at) * e_t) / float(np.sqrt(a_t))
    dir_coef = np.sqrt(np.maximum(np.float32(1.0) - a_prev - sigma * sigma,
                                  np.float32(0.0)))
    x_prev = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t
    if noise is not None:
        x_prev = x_prev + float(sigma) * noise
    return x_prev, pred_x0


def _alpha_segments(tables: StepTables, denoise_skip_fn):
    """Split the step range into runs of constant (fuser_scale == 0).

    The grounding alpha table is known before sampling (alpha_generator:
    grounded for the leading stage, plain SD after), so the steps where the
    gated fusers contribute exactly 0 run a reduced UNet body that elides
    them. Returns (start, end, is_zero) tuples."""
    steps = len(tables.t)
    zero = (np.asarray(tables.fuser_scale) == 0 if denoise_skip_fn is not None
            else np.zeros(steps, dtype=bool))
    segs = []
    start = 0
    for i in range(1, steps + 1):
        if i == steps or zero[i] != zero[start]:
            segs.append((start, i, bool(zero[start])))
            start = i
    return segs


def _segment_denoisers(denoise_fn, denoise_skip_fn):
    """is_zero -> denoise fn for a segment."""
    def pick(is_zero: bool):
        return denoise_skip_fn if is_zero else denoise_fn
    return pick


def plms_sample(denoise_fn: Callable, tables: StepTables, x_init: torch.Tensor,
                denoise_skip_fn: Optional[Callable] = None) -> torch.Tensor:
    """PLMS (pseudo linear multistep) sampling: a Heun warm start at step 0,
    then Adams-Bashforth of order 2-4 (AB1-AB3 in the reference's count).

    denoise_fn(x, t, fuser_scale, use_sd_conv) -> eps; CFG is the caller's
    concern. denoise_skip_fn: same signature with the gated fusers elided,
    used on the steps where fuser_scale == 0 (bit-exact there)."""
    b = x_init.shape[0]
    x = x_init
    hist: List[torch.Tensor] = []        # newest first, at most 3
    pick = _segment_denoisers(denoise_fn, denoise_skip_fn)
    for start, end, is_zero in _alpha_segments(tables, denoise_skip_fn):
        dn = pick(is_zero)
        for i in range(start, end):
            coef = (tables.a_t[i], tables.a_prev[i], tables.sigma[i],
                    tables.sqrt_one_minus_at[i])
            fscale = float(tables.fuser_scale[i])
            use_sd = bool(tables.use_sd_conv[i])
            tv = torch.full((b,), int(tables.t[i]), dtype=torch.long,
                            device=x.device)
            e_t = dn(x, tv, fscale, use_sd)
            if not hist:
                # pseudo improved Euler (plms.py:144-150)
                x_mid, _ = _update(x, e_t, *coef)
                tn = torch.full((b,), int(tables.t_next[i]), dtype=torch.long,
                                device=x.device)
                e_prime = (e_t + dn(x_mid, tn, fscale, use_sd)) / 2
            elif len(hist) == 1:
                e_prime = (3 * e_t - hist[0]) / 2
            elif len(hist) == 2:
                e_prime = (23 * e_t - 16 * hist[0] + 5 * hist[1]) / 12
            else:
                e_prime = (55 * e_t - 59 * hist[0] + 37 * hist[1]
                           - 9 * hist[2]) / 24
            x, _ = _update(x, e_prime, *coef)
            hist = [e_t] + hist[:2]
    return x
