"""The stated agreement of each kernel with its plain version on the card.

Both sides take the same bf16 inputs and round to bf16 at the same points,
so where their f32 values differ only by summation order, their outputs
differ by about one bf16 ulp of the output (at most 2^-7 |b|). An output
``a`` agrees with its plain version ``b`` when, element-wise,

    |a - b| <= atol + rtol * |b|,

and over the whole tensor ||a - b||_2 <= RMS_REL * ||b||_2. The norm check
catches a fault that shifts every element a little, such as a dropped
ragged tail or a wrong rescale, which an element-wise check near zero can
miss.

K1's atol is a fraction of rms(b): with random q, k, v its output shrinks
as sqrt(e / M) (rms 0.026 at M = 4096), so a fixed atol would be as large
as the values it checks. K2-K4 write normalised values of rms about 1, and
their atol is absolute. ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernels to these numbers.
"""
from __future__ import annotations

import torch

RMS_REL = 1e-2
# kid -> (atol, rtol); K1's atol is in units of rms(b)
TOLERANCE = {"K1": (0.03, 1e-2), "K2": (1e-2, 1e-2), "K3": (1e-2, 1e-2),
             "K4": (2e-2, 2e-2)}


def agreement(kid: str, out: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far ``out`` lies from ``ref`` and whether that is within the
    tolerance of kernel ``kid``."""
    atol, rtol = TOLERANCE[kid]
    a, b = out.float(), ref.float()
    rms = float(b.pow(2).mean().sqrt())
    if kid == "K1":
        atol *= rms
    diff = (a - b).abs()
    max_abs = float(diff.max())
    rms_rel = float(diff.pow(2).mean().sqrt()) / max(rms, 1e-30)
    ok = (bool(torch.isfinite(a).all())
          and bool((diff <= atol + rtol * b.abs()).all())
          and rms_rel <= RMS_REL)
    return {"ok": ok, "max_abs_err": max_abs,
            "max_rel_err": max_abs / max(float(b.abs().max()), 1e-30),
            "rms_rel_err": rms_rel, "atol": atol, "rtol": rtol,
            "rms_rel_tol": RMS_REL}
