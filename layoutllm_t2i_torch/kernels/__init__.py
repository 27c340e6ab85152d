"""The port's hand-written Hopper kernels, their plain versions and counters.

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor (see ``dispatch``). ``launches`` on each
wrapper counts the calls that launched the kernel on the card.
"""
from __future__ import annotations

from .dispatch import plain_route
from .ffn import (ffn_geglu, ffn_geglu_plain, ffn_ln_geglu, ffn_ln_geglu_plain,
                  ffn_ln_geglu_q, ffn_ln_geglu_q_plain)
from .flash_attention import (attention_delta, flash_attention,
                              flash_attention_bwd_dkv, flash_attention_bwd_dq,
                              flash_attention_bwd_plain,
                              flash_attention_lse_plain, flash_attention_plain)
from .group_norm import group_norm, group_norm_plain
from .layer_norm import layer_norm, layer_norm_plain
from .matmul import geglu_fused, geglu_plain, linear_fused, linear_plain

# id -> (wrapper, plain version)
KERNELS = {
    "K1": (flash_attention, flash_attention_plain),
    "K2": (group_norm, group_norm_plain),
    "K3": (layer_norm, layer_norm_plain),
    "K4": (ffn_ln_geglu, ffn_ln_geglu_plain),
    "K5a": (flash_attention_bwd_dq, flash_attention_bwd_plain),
    "K5b": (flash_attention_bwd_dkv, flash_attention_bwd_plain),
    "K6": (ffn_geglu, ffn_geglu_plain),
    "K7": (ffn_ln_geglu_q, ffn_ln_geglu_q_plain),
    "K8a": (linear_fused, linear_plain),
    "K8b": (geglu_fused, geglu_plain),
}


# every kernel has an f32 form: its wrapper also counts that form's
# launches (``f32_launches``, a share of ``launches``)


def reset_launches() -> None:
    for wrapper, _ in KERNELS.values():
        wrapper.launches = wrapper.f32_launches = 0


def launch_counts() -> dict:
    return {kid: wrapper.launches for kid, (wrapper, _) in KERNELS.items()}


def f32_launch_counts() -> dict:
    return {kid: wrapper.f32_launches for kid, (wrapper, _) in KERNELS.items()}


__all__ = ["KERNELS", "attention_delta", "f32_launch_counts",
           "ffn_geglu", "ffn_geglu_plain", "ffn_ln_geglu",
           "ffn_ln_geglu_plain", "ffn_ln_geglu_q", "ffn_ln_geglu_q_plain",
           "flash_attention", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dq", "flash_attention_bwd_plain",
           "flash_attention_lse_plain", "flash_attention_plain", "geglu_fused",
           "geglu_plain", "group_norm", "group_norm_plain", "launch_counts",
           "layer_norm", "layer_norm_plain", "linear_fused", "linear_plain",
           "plain_route", "reset_launches"]
