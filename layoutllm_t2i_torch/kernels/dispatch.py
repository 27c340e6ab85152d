"""Which version of a kernel a call takes, decided by the tensor it is given.

A tensor on the CPU takes the plain PyTorch version. A tensor on a CUDA
device launches the hand-written kernel, and raises if the card is not a
Hopper (sm_90) card: nothing falls back to the plain version on the card.
The one exception is ``plain_route()``, an explicit switch that the chip
check and the tests use to run a whole model through the plain versions
on the card, as the reference the kernel route is compared against. The
switch is read when a forward runs; a backward takes its forward's route
(autograd runs backward on threads of its own).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

_state = threading.local()
_capability: Dict[int, tuple] = {}


@contextlib.contextmanager
def plain_route():
    """Run the plain versions even for CUDA tensors (reference runs only)."""
    prev = getattr(_state, "plain", False)
    _state.plain = True
    try:
        yield
    finally:
        _state.plain = prev


def use_kernel(x: torch.Tensor) -> bool:
    """True when ``x`` must go through the CUDA kernel."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}: use 'cuda' or 'cpu'")
    if getattr(_state, "plain", False):
        return False
    idx = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if idx not in _capability:
        _capability[idx] = torch.cuda.get_device_capability(idx)
    if _capability[idx][0] != 9:
        raise RuntimeError(
            f"the port's kernels are built for Hopper (sm_90a); device {idx} "
            f"is sm_{_capability[idx][0]}{_capability[idx][1]}")
    return True


def require(cond: bool, what: str) -> None:
    """Validate a kernel's operand before its pointer reaches C."""
    if not cond:
        raise ValueError(what)


def check_operand(t: torch.Tensor, name: str, device: torch.device,
                  dtype: torch.dtype = torch.bfloat16) -> None:
    require(t.device == device, f"{name}: on {t.device}, expected {device}")
    require(t.dtype == dtype, f"{name}: dtype {t.dtype}, expected {dtype}")
    require(t.is_contiguous(), f"{name}: must be contiguous")


def require_aligned(t: torch.Tensor, name: str, nbytes: int = 16) -> None:
    """A kernel that loads ``t`` through TMA or in 16-byte vectors needs its
    address 16-byte aligned, one that moves bf16 pairs 4-byte aligned:
    raise otherwise (no fallback)."""
    require(t.data_ptr() % nbytes == 0,
            f"{name}: data_ptr() must be {nbytes}-byte aligned")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def needs_grad(*args) -> bool:
    """True when autograd must record a call on these arguments."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


def plain_vjp(plain_fn, args, needs, grad_out):
    """The vector-Jacobian product of ``plain_fn(*args)`` with ``grad_out``:
    a recompute through the plain version, as the JAX package's custom VJPs
    of its norm and FF kernels do (``jax.vjp`` of the reference math).
    Returns one gradient per argument, None where ``needs`` is False."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(bool(n))
                  if isinstance(a, torch.Tensor) else a
                  for a, n in zip(args, needs)]
        wrt = [a for a, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(plain_fn(*leaves), wrt, grad_out)
                     if wrt else ())
    return tuple(next(grads) if n else None for n in needs)
