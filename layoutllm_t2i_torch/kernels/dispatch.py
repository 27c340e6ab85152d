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
_capability: Dict[int, tuple] = {}  # Hopper devices checked so far


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
    """True when ``x`` must go through the CUDA kernel. On the card it costs
    a few attribute reads and one dict lookup: the tensor's device index is
    always set, and whether that device is a Hopper card is looked up once."""
    if not x.is_cuda:
        if x.is_cpu:
            return False
        raise ValueError(f"unsupported device {x.device}: use 'cuda' or 'cpu'")
    if getattr(_state, "plain", False):
        return False
    idx = x.get_device()
    if _capability.get(idx) is None:
        _require_hopper(idx)
    return True


def _require_hopper(idx: int) -> None:
    cap = torch.cuda.get_device_capability(idx)
    if cap[0] != 9:
        raise RuntimeError(
            f"the port's kernels are built for Hopper (sm_90a); device {idx} "
            f"is sm_{cap[0]}{cap[1]}")
    _capability[idx] = cap


def require(cond: bool, what: str) -> None:
    """Validate a kernel's operand before its pointer reaches C."""
    if not cond:
        raise ValueError(what)


# the operand types of the kernels' instantiations: bf16 for every kernel,
# f32 for K1, K2, K3, K4, K5a and K5b
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def operand_dtype(x: torch.Tensor) -> torch.dtype:
    """The type a kernel call is checked against: ``x``'s where a form of
    the kernel takes it, else bf16 (so that any other type raises naming
    both)."""
    return x.dtype if x.dtype in KERNEL_DTYPES else torch.bfloat16


def check_operand(t: torch.Tensor, name: str, device: int,
                  dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on CUDA device
    ``device`` (an index: the first operand's ``get_device()``). ``dtype``
    is the operand type of the call (``operand_dtype``). An identity test
    and attribute reads: no ``torch.device`` is built unless a check
    fails."""
    if t.dtype is not dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if not t.is_cuda or t.get_device() != device:
        raise ValueError(f"{name}: on {t.device}, expected "
                         f"{torch.device('cuda', device)}")


def require_aligned(t: torch.Tensor, name: str, nbytes: int = 16) -> None:
    """A kernel that loads ``t`` through TMA or in 16-byte vectors needs its
    address 16-byte aligned, one that moves pairs of values 2 values'
    bytes aligned: raise otherwise (no fallback)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data_ptr() must be {nbytes}-byte aligned")


def vector_elems(dtype: torch.dtype) -> int:
    """Values of ``dtype`` in a 16-byte vector: 8 bf16, 4 f32. A row that a
    kernel moves in 16-byte vectors has a stride that is a multiple of it
    (the alignment rule in elements, not bytes)."""
    return 16 // dtype.itemsize


def stream_handle(device: int) -> int:
    """The raw handle of the current CUDA stream of device ``device`` (an
    index), as ``torch.cuda.current_stream(device).cuda_stream`` gives it,
    read without building a ``torch.cuda.Stream``. Read at every call, never
    cached: a caller inside ``torch.cuda.stream(...)`` gets that stream."""
    return torch._C._cuda_getCurrentRawStream(device)


def needs_grad(*args) -> bool:
    """True when autograd must record a call on these arguments."""
    if not torch.is_grad_enabled():
        return False
    for a in args:
        if isinstance(a, torch.Tensor) and a.requires_grad:
            return True
    return False


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
