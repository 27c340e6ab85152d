"""Reference-format GLIGEN ``.pth`` export and the RL policy's ``ckpt_E.pt``
and ``state_E.pt`` (layoutllm_t2i_tpu/checkpoint/export.py
``export_gligen_checkpoint``, ``export_policy_checkpoint``,
``export_policy_state``).

Writes the 4-module dict the reference trainer saves
(trainer_combined_layout.py:523-535): ``{model, text_encoder, autoencoder,
diffusion, iters, config_dict}`` plus the optional ``ema``. The port's
state dicts already carry the reference names and torch layouts, so nothing
is converted back; tensors are written as f32 on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.schedules import DDPMSchedule

StateDict = Mapping[str, torch.Tensor]


def _cpu_f32(sd: StateDict, prefix: str = "") -> Dict[str, torch.Tensor]:
    return {prefix + k: v.detach().to("cpu", torch.float32).contiguous()
            for k, v in sd.items()}


def diffusion_state_dict(schedule: DDPMSchedule) -> Dict[str, torch.Tensor]:
    """The DDPM buffer dict the reference registers (ddpm.py:19-54)."""
    ac = np.asarray(schedule.alphas_cumprod, np.float64)
    buffers = {
        "betas": schedule.betas,
        "alphas_cumprod": schedule.alphas_cumprod,
        "alphas_cumprod_prev": schedule.alphas_cumprod_prev,
        "sqrt_alphas_cumprod": schedule.sqrt_alphas_cumprod,
        "sqrt_one_minus_alphas_cumprod": schedule.sqrt_one_minus_alphas_cumprod,
        "log_one_minus_alphas_cumprod": np.log(1.0 - ac),
        "sqrt_recip_alphas_cumprod": schedule.sqrt_recip_alphas_cumprod,
        "sqrt_recipm1_alphas_cumprod": schedule.sqrt_recipm1_alphas_cumprod,
        "posterior_variance": schedule.posterior_variance,
        "posterior_log_variance_clipped": schedule.posterior_log_variance_clipped,
        "posterior_mean_coef1": schedule.posterior_mean_coef1,
        "posterior_mean_coef2": schedule.posterior_mean_coef2,
    }
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in buffers.items()}


def export_gligen_checkpoint(path: str, unet_sd: StateDict, vae_sd: StateDict,
                             clip_sd: StateDict, schedule: DDPMSchedule,
                             config_dict: Dict[str, Any], iters: int = 0,
                             ema_unet_sd: Optional[StateDict] = None) -> None:
    """Write the reference 4-module dict checkpoint. The text encoder keys
    take the ``transformer.text_model.`` prefix (FrozenCLIPEmbedder wraps the
    HF CLIPTextModel as ``self.transformer``, encoders/modules.py:144-160)
    and the ``position_ids`` buffer."""
    text_sd = _cpu_f32(clip_sd, prefix="transformer.text_model.")
    max_len = clip_sd["embeddings.position_embedding.weight"].shape[0]
    text_sd["transformer.text_model.embeddings.position_ids"] = (
        torch.arange(max_len).unsqueeze(0))
    ckpt = {
        "model": _cpu_f32(unet_sd),
        "text_encoder": text_sd,
        "autoencoder": _cpu_f32(vae_sd),
        "diffusion": diffusion_state_dict(schedule),
        "iters": int(iters),
        "config_dict": config_dict,
    }
    if ema_unet_sd is not None:
        ckpt["ema"] = _cpu_f32(ema_unet_sd)
    torch.save(ckpt, path)


def export_policy_checkpoint(path: str, policy_params) -> None:
    """Write the policy linear as the reference ``ckpt_E.pt`` —
    ``torch.save(policy_model.linear.state_dict())`` (train_rl.py:218-219):
    a bare ``{'weight': (out, in), 'bias': (out,)}`` dict, f32 on the CPU,
    which the reference's txt2img.py:546-553 and ``convert.load_policy``
    read."""
    lin = policy_params["linear"]
    torch.save(_cpu_f32({"weight": lin["weight"], "bias": lin["bias"]}), path)


def export_policy_state(path: str, adam_state: Mapping[str, Any], *,
                        epoch: int, lr: float, lr_step_size: int,
                        lr_gamma: float) -> None:
    """Write ``state_E.pt`` in the reference layout (train_rl.py:220-222):
    ``{'optimizer': Adam.state_dict(), 'lr_scheduler': StepLR.state_dict()}``
    with the keys the JAX package's export writes. ``adam_state`` is
    ``{'step': int, 'mu': tree, 'nu': tree}`` (``convert.load_policy_state``
    reads it back), the moments uncorrected, as both torch's Adam and
    optax's keep them, in the policy tree's torch layout. Param ids follow
    ``nn.Linear.parameters()`` order: 0 = weight, 1 = bias."""
    step = int(adam_state["step"])
    mu = _cpu_f32(adam_state["mu"]["linear"])
    nu = _cpu_f32(adam_state["nu"]["linear"])
    cur_lr = float(lr * lr_gamma ** (epoch // lr_step_size))
    opt_sd = {
        "state": {
            i: {"step": torch.tensor(float(step)),
                "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
            for i, name in enumerate(("weight", "bias"))
        },
        "param_groups": [{
            "lr": cur_lr,
            "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 0,
            "amsgrad": False, "maximize": False, "foreach": None,
            "capturable": False, "differentiable": False, "fused": None,
            "params": [0, 1],
        }],
    }
    sched_sd = {
        "step_size": int(lr_step_size), "gamma": float(lr_gamma),
        "base_lrs": [float(lr)], "last_epoch": int(epoch),
        "_step_count": int(epoch) + 1, "verbose": False,
        "_get_lr_called_within_step": False,
        "_last_lr": [cur_lr],
    }
    torch.save({"optimizer": opt_sd, "lr_scheduler": sched_sd}, path)
