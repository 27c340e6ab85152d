"""The stated agreement of each kernel with its plain version on the card.

Both sides take the same bf16 inputs and round to bf16 at the same points,
so where their f32 values differ only by summation order, their outputs
differ by about one bf16 ulp of the output (at most 2^-7 |b|). An output
``a`` agrees with its plain version ``b`` when, element-wise,

    |a - b| <= atol + rtol * |b|,

and over the whole tensor ||a - b||_2 <= rms_rel * ||b||_2. The norm check
catches a fault that shifts every element a little, such as a dropped
ragged tail, a wrong rescale or a small scale error, which an element-wise
check near zero can miss.

K1's atol is a fraction of rms(b): with random q, k, v its output shrinks
as sqrt(e / M) (rms 0.026 at M = 4096), so a fixed atol would be as large
as the values it checks. K2-K4 write normalised values of rms about 1, and
their atol is absolute. K5a and K5b (dQ, and dK with dV) are sums over N or
M terms whose scale follows the inputs, so their atol is a fraction of
rms(b) too, at K1's values. Their plain version rounds P and dS to bf16
where the kernels do (K1's plain version keeps P in f32), so they sit
closer to it: on the H100 their whole-tensor error is at most 2.2e-4 of
rms(b), against K1's 2.5e-3, and their rms bound is 2e-3, under the 5e-3
that a 0.5 % scale error of the output gives. "lse" is K1's log-sum-exp
output (about log M, an f32 sum of f32 exponentials on both sides), held
to an absolute atol. ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernels to these numbers; ``tests/test_torch_kernels.py`` shows
on the CPU that they pass the kernels' rounding and fail planted faults.
"""
from __future__ import annotations

import torch

# kid -> (atol, rtol, rms_rel); the atol of RMS_SCALED kernels is in units
# of rms(b)
TOLERANCE = {"K1": (0.03, 1e-2, 1e-2), "K2": (1e-2, 1e-2, 1e-2),
             "K3": (1e-2, 1e-2, 1e-2), "K4": (2e-2, 2e-2, 1e-2),
             "K5a": (0.03, 1e-2, 2e-3), "K5b": (0.03, 1e-2, 2e-3),
             "lse": (1e-3, 1e-4, 1e-2)}
RMS_SCALED = ("K1", "K5a", "K5b")


def agreement(kid, out, ref) -> dict:
    """How far ``out`` lies from ``ref`` and whether that is within the
    tolerance of kernel ``kid``. A tuple of outputs is held part by part:
    ``kid`` is then one id for every part (K5b's dK and dV) or a tuple of
    ids, one per part (K1's output and its lse); the worst of each figure
    is reported."""
    if isinstance(out, (tuple, list)):
        kids = kid if isinstance(kid, (tuple, list)) else (kid,) * len(out)
        parts = [agreement(k, a, b) for k, a, b in zip(kids, out, ref)]
        return {key: (all(p["ok"] for p in parts) if key == "ok"
                      else max(p[key] for p in parts)) for key in parts[0]}
    atol, rtol, rms_tol = TOLERANCE[kid]
    a, b = out.float(), ref.float()
    rms = float(b.pow(2).mean().sqrt())
    if kid in RMS_SCALED:
        atol *= rms
    diff = (a - b).abs()
    max_abs = float(diff.max())
    rms_rel = float(diff.pow(2).mean().sqrt()) / max(rms, 1e-30)
    ok = (bool(torch.isfinite(a).all())
          and bool((diff <= atol + rtol * b.abs()).all())
          and rms_rel <= rms_tol)
    return {"ok": ok, "max_abs_err": max_abs,
            "max_rel_err": max_abs / max(float(b.abs().max()), 1e-30),
            "rms_rel_err": rms_rel, "atol": atol, "rtol": rtol,
            "rms_rel_tol": rms_tol}
