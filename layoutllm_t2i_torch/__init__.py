"""PyTorch/CUDA port of layoutllm_t2i_tpu for NVIDIA Hopper (H100).

The JAX package is the reference; module paths and function names here
mirror it. Parameters are nested dicts (or ``utils.trees.ParamTree``
modules) keyed by the reference torch state_dict names, in the torch
layouts (conv OIHW, linear (out, in)). Activations are logical NCHW in
``torch.channels_last`` memory; public tensors keep the JAX shapes.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
