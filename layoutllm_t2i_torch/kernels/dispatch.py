"""Which version of a kernel a call takes, decided by the tensor it is given.

A tensor on the CPU takes the plain PyTorch version. A tensor on a CUDA
device launches the hand-written kernel, and raises if the card is not a
Hopper (sm_90) card: nothing falls back to the plain version on the card.
The one exception is ``plain_route()``, an explicit switch that the chip
check and the tests use to run a whole model through the plain versions
on the card, as the reference the kernel route is compared against.
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


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
