"""PLMS, DDIM and DPM-Solver++(2M) as Python step loops (layoutllm_t2i_tpu/
diffusion/samplers.py; reference GLIGEN/ldm/models/diffusion/{plms,ddim}.py).

The JAX package runs one ``lax.scan`` per segment and picks the warm start
and Adams-Bashforth order with ``lax.cond``/``lax.switch``; here the loop
is plain Python over host step tables, so the per-step grounding alpha, the
SD first-conv flag, the segment's denoiser and the encoder-cache key flag
are host values and no step reads a device scalar back.

Two opt-in speed modes compose with every sampler, as in the JAX package:
the guidance interval (``cfg_on``: steps outside it run a cond-only
denoiser at half the CFG batch) and encoder propagation (``key_steps``: on
a non-key step the denoiser skips the UNet encoder and reads the cache of
the last key step). In cached mode every denoiser takes ``cache=`` and
``is_key=`` and returns ``(eps, cache)``.

Inpainting (``inpaint``, an InpaintBlend) replaces the known region of x
with a q-sample of the clean latent at the step's timestep at the start of
every step, before the step's denoise (ddim.py:98-102). Its noise comes
from the blend's own source: the JAX package draws it from a threefry key
a step, which a torch generator cannot reproduce, so a caller that holds
the port to it passes the JAX side's draws in.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

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


@dataclasses.dataclass
class InpaintBlend:
    """Known-region replacement each step (ddim.py:98-102). ``mask`` and
    ``z0`` are in the sampler's layout, (B, 1 or C, h, w) and (B, C, h, w);
    the mask is 1 where the original is kept. ``noise(i)`` gives step i's
    q-sample noise, z0's shape; None draws it from ``generator``."""

    mask: torch.Tensor
    z0: torch.Tensor
    noise: Optional[Callable[[int], torch.Tensor]] = None
    generator: Optional[torch.Generator] = None

    def step_noise(self, i: int) -> torch.Tensor:
        if self.noise is not None:
            return self.noise(i).to(self.z0.dtype)
        return torch.randn(self.z0.shape, generator=self.generator,
                           device=self.z0.device, dtype=self.z0.dtype)


def _q_sample(schedule: DDPMSchedule, z0: torch.Tensor, t: int,
              noise: torch.Tensor) -> torch.Tensor:
    """z0 diffused to timestep t: sqrt(a_t) z0 + sqrt(1 - a_t) noise, the
    coefficients the schedule's float32 values."""
    sa = float(np.float32(schedule.sqrt_alphas_cumprod[t]))
    s1m = float(np.float32(schedule.sqrt_one_minus_alphas_cumprod[t]))
    return sa * z0 + s1m * noise


def _blend(inpaint: Optional[InpaintBlend], schedule, x: torch.Tensor,
           t: int, i: int) -> torch.Tensor:
    """x with its kept region replaced by the q-sampled original (step i)."""
    if inpaint is None:
        return x
    img_orig = _q_sample(schedule, inpaint.z0, t, inpaint.step_noise(i))
    return img_orig * inpaint.mask + (1.0 - inpaint.mask) * x


def _check_inpaint(inpaint, schedule):
    if inpaint is not None and schedule is None:
        raise ValueError("an inpainting blend needs the sampler's schedule")


def _alpha_segments(tables: StepTables, denoise_skip_fn, cfg_on=None):
    """Split the step range into runs of constant (fuser_scale == 0, cfg_on).

    The grounding alpha table is known before sampling (alpha_generator:
    grounded for the leading stage, plain SD after), so the steps where the
    gated fusers contribute exactly 0 run a reduced UNet body that elides
    them; ``cfg_on`` (guidance-interval mode, arXiv:2404.07724) splits the
    runs again where guidance turns off. Returns (start, end, is_zero,
    is_cfg) tuples."""
    steps = len(tables.t)
    zero = (np.asarray(tables.fuser_scale) == 0 if denoise_skip_fn is not None
            else np.zeros(steps, dtype=bool))
    con = (np.ones(steps, dtype=bool) if cfg_on is None
           else np.asarray(cfg_on, dtype=bool))
    segs = []
    start = 0
    for i in range(1, steps + 1):
        if i == steps or (zero[i], con[i]) != (zero[start], con[start]):
            segs.append((start, i, bool(zero[start]), bool(con[start])))
            start = i
    return segs


def _segment_denoisers(denoise_fn, denoise_skip_fn, denoise_nocfg_fn=None,
                       denoise_nocfg_skip_fn=None):
    """(is_zero, is_cfg) -> denoise fn, shared by the three samplers."""
    def pick(is_zero: bool, is_cfg: bool):
        if is_cfg or denoise_nocfg_fn is None:
            return denoise_skip_fn if is_zero else denoise_fn
        return denoise_nocfg_skip_fn if is_zero else denoise_nocfg_fn
    return pick


def _resize_cache(cache, b: int, to_cfg: bool):
    """An encoder cache across a guidance-interval boundary: CFG segments
    carry (2B, ...) features ([cond; uncond]), cond-only segments (B, ...).
    The pipeline forces the first step of every segment to be a key step,
    so the resized values are refreshed before a propagated step reads
    them; a caller's own key table may read them, as in the JAX package."""
    if cache is None:
        return None
    if to_cfg:
        fit = lambda a: torch.cat([a, a]) if a.shape[0] == b else a
    else:
        fit = lambda a: a[:b] if a.shape[0] == 2 * b else a
    return {"hs": tuple(fit(a) for a in cache["hs"]),
            "mid_in": fit(cache["mid_in"])}


class _Segments:
    """The segment walk the three samplers share: which denoiser runs each
    step, and the encoder cache carried between steps in cached mode."""

    def __init__(self, tables, x_init, denoise_fn, denoise_skip_fn, key_steps,
                 denoise_nocfg_fn, denoise_nocfg_skip_fn, cfg_on):
        self.tables = tables
        self.b = x_init.shape[0]
        self.device = x_init.device
        self.key_steps = (None if key_steps is None
                          else np.asarray(key_steps, dtype=bool))
        self.cache = None
        self._pick = _segment_denoisers(denoise_fn, denoise_skip_fn,
                                        denoise_nocfg_fn, denoise_nocfg_skip_fn)
        self._segs = _alpha_segments(tables, denoise_skip_fn, cfg_on)

    def __iter__(self):
        """(step index, denoise fn) in loop order."""
        prev_cfg = None
        for start, end, is_zero, is_cfg in self._segs:
            if self.key_steps is not None and prev_cfg not in (None, is_cfg):
                self.cache = _resize_cache(self.cache, self.b, is_cfg)
            prev_cfg = is_cfg
            dn = self._pick(is_zero, is_cfg)
            for i in range(start, end):
                yield i, dn

    def timesteps(self, i: int, table=None) -> torch.Tensor:
        t = (self.tables.t if table is None else table)[i]
        return torch.full((self.b,), int(t), dtype=torch.long, device=self.device)

    def eps(self, dn, x, i: int, t=None, is_key=None) -> torch.Tensor:
        """dn at step i (at timestep t, default the step's own); in cached
        mode with the carried cache, which a key step refreshes."""
        t = self.timesteps(i) if t is None else t
        args = (x, t, float(self.tables.fuser_scale[i]),
                bool(self.tables.use_sd_conv[i]))
        if self.key_steps is None:
            return dn(*args)
        key = bool(self.key_steps[i]) if is_key is None else is_key
        e, self.cache = dn(*args, cache=self.cache, is_key=key)
        return e


def plms_sample(denoise_fn: Callable, tables: StepTables, x_init: torch.Tensor,
                denoise_skip_fn: Optional[Callable] = None, key_steps=None,
                denoise_nocfg_fn: Optional[Callable] = None,
                denoise_nocfg_skip_fn: Optional[Callable] = None,
                cfg_on=None, schedule: Optional[DDPMSchedule] = None,
                inpaint: Optional[InpaintBlend] = None) -> torch.Tensor:
    """PLMS (pseudo linear multistep) sampling: a Heun warm start at step 0,
    then Adams-Bashforth of order 2-4 (AB1-AB3 in the reference's count).

    denoise_fn(x, t, fuser_scale, use_sd_conv) -> eps; CFG is the caller's
    concern. denoise_skip_fn: same signature with the gated fusers elided,
    used on the steps where fuser_scale == 0 (bit-exact there).
    key_steps: (S,) bool, encoder-propagation mode (see the module doc).
    denoise_nocfg_fn/denoise_nocfg_skip_fn/cfg_on: guidance-interval mode.
    inpaint: the known-region blend, before each step's denoise; it needs
    ``schedule``. The Heun warm start's second evaluation is not blended."""
    _check_inpaint(inpaint, schedule)
    x = x_init
    hist: List[torch.Tensor] = []        # newest first, at most 3
    segs = _Segments(tables, x_init, denoise_fn, denoise_skip_fn, key_steps,
                     denoise_nocfg_fn, denoise_nocfg_skip_fn, cfg_on)
    for i, dn in segs:
        coef = (tables.a_t[i], tables.a_prev[i], tables.sigma[i],
                tables.sqrt_one_minus_at[i])
        x = _blend(inpaint, schedule, x, int(tables.t[i]), i)
        e_t = segs.eps(dn, x, i)
        if not hist:
            # pseudo improved Euler (plms.py:144-150); in cached mode the
            # adjacent-t evaluation reuses the cache the step-0 forward
            # just refreshed
            x_mid, _ = _update(x, e_t, *coef)
            e_next = segs.eps(dn, x_mid, i, t=segs.timesteps(i, tables.t_next),
                              is_key=False)
            e_prime = (e_t + e_next) / 2
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


def ddim_sample(denoise_fn: Callable, tables: StepTables, x_init: torch.Tensor,
                denoise_skip_fn: Optional[Callable] = None, key_steps=None,
                denoise_nocfg_fn: Optional[Callable] = None,
                denoise_nocfg_skip_fn: Optional[Callable] = None,
                cfg_on=None,
                generator: Optional[torch.Generator] = None,
                schedule: Optional[DDPMSchedule] = None,
                inpaint: Optional[InpaintBlend] = None,
                noise_rows: Optional[Tuple[int, slice]] = None) -> torch.Tensor:
    """DDIM sampling (ddim.py:65-135); eta > 0 tables add sigma-scaled step
    noise drawn from ``generator`` (it cannot match the JAX package's
    ``jax.random`` draws: only eta = 0 is held to it). ``noise_rows`` =
    (batch, rows): x holds these rows of a larger batch (prompt-parallel
    sampling), so each step draws the whole batch's noise and keeps its
    rows, as one device would draw it. The other arguments as in
    plms_sample; the JAX package draws the blend's noise from the first
    half of each step's key, split, and the step noise from the second."""
    _check_inpaint(inpaint, schedule)
    stochastic = bool(np.any(np.asarray(tables.sigma) > 0))
    batch, rows = noise_rows or (x_init.shape[0], slice(None))
    x = x_init
    segs = _Segments(tables, x_init, denoise_fn, denoise_skip_fn, key_steps,
                     denoise_nocfg_fn, denoise_nocfg_skip_fn, cfg_on)
    for i, dn in segs:
        x = _blend(inpaint, schedule, x, int(tables.t[i]), i)
        e_t = segs.eps(dn, x, i)
        noise = (torch.randn((batch,) + x.shape[1:], generator=generator,
                             device=x.device, dtype=x.dtype)[rows]
                 if stochastic else None)
        x, _ = _update(x, e_t, tables.a_t[i], tables.a_prev[i],
                       tables.sigma[i], tables.sqrt_one_minus_at[i], noise)
    return x


def dpm_sample(denoise_fn: Callable, tables: StepTables, x_init: torch.Tensor,
               denoise_skip_fn: Optional[Callable] = None, key_steps=None,
               denoise_nocfg_fn: Optional[Callable] = None,
               denoise_nocfg_skip_fn: Optional[Callable] = None,
               cfg_on=None, schedule: Optional[DDPMSchedule] = None,
               inpaint: Optional[InpaintBlend] = None) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al., arXiv:2211.01095), the data-prediction
    multistep form: a deterministic 2nd-order solver in log-SNR time. No
    reference counterpart (GLIGEN ships PLMS and DDIM). The arguments as in
    plms_sample.

    With alpha = sqrt(a), sigma = sqrt(1 - a), lambda = log(alpha/sigma),
    h = lambda_prev - lambda_t:
      x0_t   = (x - sigma_t * eps) / alpha_t
      D      = x0_t                                  (first step)
             = (1 + c) x0_t - c x0_{t-1},  c = h / (2 h_last)
      x_prev = (sigma_prev/sigma_t) x - alpha_prev * expm1(-h) * D
    lambda is computed in float64 on the host and used in float32, the
    coefficients in float32, as the JAX package computes them on the
    device."""
    _check_inpaint(inpaint, schedule)
    if bool(np.any(np.asarray(tables.sigma) > 0)):
        raise ValueError(
            "dpm_sample is a deterministic ODE solver: eta>0 step tables "
            "are unsupported (the sigma noise would be silently dropped) — "
            "use ddim_sample for stochastic sampling")
    f32 = np.float32
    a_t = np.asarray(tables.a_t, dtype=np.float64)
    a_prev = np.asarray(tables.a_prev, dtype=np.float64)
    lam_t = (0.5 * np.log(a_t / (1.0 - a_t))).astype(f32)
    lam_p = (0.5 * np.log(a_prev / np.maximum(1.0 - a_prev, 1e-12))).astype(f32)
    at32, ap32 = a_t.astype(f32), a_prev.astype(f32)
    x = x_init
    x0_prev = None
    lam_last = f32(0.0)
    segs = _Segments(tables, x_init, denoise_fn, denoise_skip_fn, key_steps,
                     denoise_nocfg_fn, denoise_nocfg_skip_fn, cfg_on)
    for i, dn in segs:
        x = _blend(inpaint, schedule, x, int(tables.t[i]), i)
        e_t = segs.eps(dn, x, i)
        alpha_t, sigma_t = np.sqrt(at32[i]), np.sqrt(f32(1.0) - at32[i])
        alpha_p = np.sqrt(ap32[i])
        sigma_p = np.sqrt(np.maximum(f32(1.0) - ap32[i], f32(0.0)))
        x0 = (x - float(sigma_t) * e_t) / float(alpha_t)
        h = lam_p[i] - lam_t[i]
        h_last = lam_t[i] - lam_last
        if x0_prev is None:
            d = x0
        else:
            # 1/(2r) = h/(2*h_last); a degenerate h_last (duplicated
            # timesteps at very fine discretizations) falls back to first
            # order instead of 0/0
            c = (h / (f32(2.0) * np.maximum(h_last, f32(1e-8)))
                 if h_last > 1e-8 else f32(0.0))
            d = float(f32(1.0) + c) * x0 - float(c) * x0_prev
        x = float(sigma_p / sigma_t) * x - float(alpha_p * np.expm1(-h)) * d
        x0_prev, lam_last = x0, lam_t[i]
    return x
