"""Parameter initializers producing torch-state_dict-shaped trees.

Same distributions as layoutllm_t2i_tpu/models/initializers.py (torch's
kaiming-uniform fan-in bounds), in the torch layouts: linear weights
(out, in), conv weights OIHW. Values come from an explicit
``torch.Generator`` and are made directly on the target device; they do not
reproduce the JAX package's numbers (tests carry JAX weights across with
checkpoint/from_jax.py instead).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Init:
    """Where and how leaves are made: generator, device, dtype."""

    gen: torch.Generator
    device: torch.device
    dtype: torch.dtype = torch.float32

    def uniform(self, shape, bound: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float32)
        return ((u * 2.0 - 1.0) * bound).to(self.dtype)

    def normal(self, shape, scale: float) -> torch.Tensor:
        n = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return (n * scale).to(self.dtype)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)


def linear_p(ini: Init, din: int, dout: int, bias: bool = True):
    bound = 1.0 / din ** 0.5
    p = {"weight": ini.uniform((dout, din), bound)}
    if bias:
        p["bias"] = ini.uniform((dout,), bound)
    return p


def conv_p(ini: Init, kh: int, kw: int, cin: int, cout: int, bias: bool = True):
    bound = 1.0 / (kh * kw * cin) ** 0.5
    p = {"weight": ini.uniform((cout, cin, kh, kw), bound)}
    if bias:
        p["bias"] = ini.uniform((cout,), bound)
    return p


def normal_p(ini: Init, shape, scale: float = 0.02):
    return ini.normal(shape, scale)


def norm_p(ini: Init, c: int):
    return {"weight": ini.full((c,), 1.0), "bias": ini.full((c,), 0.0)}


def scalar_p(ini: Init, value: float = 0.0):
    return ini.full((), value)


def zeros_p(ini: Init, shape):
    return ini.full(shape, 0.0)
