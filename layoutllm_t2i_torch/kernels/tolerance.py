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
closer to it: on the H100 their whole-tensor error is at most 2.4e-4 of
rms(b), against K1's 2.5e-3, and their rms bound is 2e-3, under the 5e-3
that a 0.5 % scale error of the output gives. "lse" is K1's log-sum-exp
output (about log M, an f32 sum of f32 exponentials on both sides), held
to an absolute atol. K6 and K7 write K4's function (K7 on int8 weights,
its scales applied to f32 sums on both sides) and K8a and K8b one GEMM's
output, of rms about 1 at the inputs the checks draw: all four take K4's
numbers. A planted fault of K7's design on the same mainloop (a dropped
output scale, scales applied per input channel, int8 read as unsigned, the
scale s ignored, a chunk converted from the previous chunk's int8 tile,
scales applied after the bias) lies 4.8e-2 to 3.3e2 of rms(b) off, the
emulated rounding at most 9.7e-5 (``tests/test_torch_quant.py``).
A planted fault of K4's or K8a's wgmma design (a dropped ragged k chunk,
an unwritten last row block, Wa and Wg swapped, a bias dropped or added
twice, s applied after the residual, LN without its rstd) lies 2.3e-2 to
0.6 of rms(b) off in the whole-tensor error, the emulated rounding at
most 7.2e-5 (``tests/test_torch_kernels.py``); h left unrounded in f32 and
K8a's sum rounded before its residual (1.0e-3 and 2.5e-3) are within it.
K6 and K8b on the same mainloop: the planted faults (those, K6's residual
halved, K8b's also with the bias absent) lie 8.0e-2 to 0.96 off, the
emulated rounding at most 1.4e-4; K6's h unrounded and its residual added
before the FF output's rounding (2.0e-3 and 2.3e-3) are within it.
K2's on-chip and streaming designs (per-block sums shifted by the block's
first row, Chan's merges within a block and across the cluster or the
statistics chunks): the emulated rounding lies at most 4.6e-5 of rms(b)
off in the whole-tensor error, planted faults (a block normalising with
its own statistics, the ragged last block dropped, slabs one channel off
the groups, gamma and beta of the next slab) 0.56 to 0.72
(``tests/test_torch_group_norm.py``).

The f32 forms ("K1/f32", "lse/f32", "K2/f32", "K4/f32", "K5a/f32",
"K5b/f32"; ``tol_id``) round nowhere to bf16: both sides are f32, the
kernels' products 3xTF32 (about 2^-21 relative a product), the plain
versions' cuBLAS in full f32, so the two differ by summation order and a
few f32 ulps: the 3xTF32 emulation lies at most 8.0e-7 of rms(b) off in
the whole-tensor error for K1, 1.05e-6 for K5a and K5b (their wgmma
tiles, N = M = 1054), 2.2e-7 for K4. One TF32 pass
(operands rounded once to 10 mantissa bits: a different function) lies
4.1e-4 to 5.8e-4 off for K1, K5a and K5b, and 8.7e-5 to 1.8e-4 for K4,
whose output the residual x dominates. So the whole-tensor bound is 5e-5
for K1, K5a and K5b and 2e-5 for K4, both under the 1e-4 that separates
f32 from one TF32 pass, with element-wise bounds of 1e-3 of rms(b) (K1,
K5) and 1e-4 (K4). A dropped ragged K/V tail, a missing rescale, K4's s
applied after the residual, an unwritten last row block and a dropped
ragged k step lie 7e-2 to 0.6 off, K5's transposed operands off P's key
slots, a stale stage or an unzeroed fresh accumulator 1.2 to 38
(``tests/test_torch_f32_kernels.py``).
K2 in f32 has no products: its emulated sums lie at most 1.0e-6 off, its
four planted faults 0.56 to 0.72, and its bound is 2e-5
(``tests/test_torch_group_norm.py``). The lse in f32 is held to 1e-4
absolute (emulated: 1e-6; one TF32 pass moves it by 6e-5 to 2.6e-4, which
K1's output row already catches). On the H100 the f32 rows read at most
1.5e-6 of rms(b) (K1, K5a, K5b), 7.1e-7 (K4) and 1.1e-7 (K2). Past
d 160 (widths 256 and 320) K5's f32 kernels stream the scores' depth in
32-column items chained into one accumulator, so an item's lo*hi and
hi*lo products add into a sum that already holds the earlier items'
hi*hi: the emulation reads 6.2e-6 and 8.0e-6 (N = M = 606), the card
4.9e-6 to 6.3e-6, inside the row; a dropped last item, a ragged tail, a
stage read past N or a pass of K5b not run lie 6e-2 to 1 off. The
emulation adds in round-to-nearest f32; the tensor cores truncate where
they add into an mma's C operand, so the kernels add each stage's 3xTF32
partial, from a fresh accumulator, into their sums with f32 adds.
Chained through one running C, the same kernels read 3e-5 over 4096 keys
and 3.0e-5 for K4 at K = 1280, growing with the sum's length: the K4 row
failed there. K5's emulated one chain reads 1.0e-5 at N = M = 1054 and
3.9e-5 at 4126, inside its row: the fresh accumulators keep K5 at
~1e-6.
K1 past d 512 (num_heads 1; the column-group kernels, both types) keeps
K1's rows: its emulation (each column group computing the same scores
over 64- or 32-column depth items, the f32 items' products into fresh
accumulators) lies 2.4e-3 of rms(b) off in bf16 and at most 7.6e-7 in
f32 at d 520, 640 and 1280; a column group not written, one reading V or
writing O at another's columns, the last depth item dropped and a ragged
tail scoring 0 lie 1.1e-3 (f32) or 1.9e-2 (bf16) to 0.98 off, one TF32
pass 4.1e-4 (``tests/test_torch_k1_wide.py``).
K6, K7, K8a and K8b in f32 ("K6/f32", "K7/f32", "K8a/f32", "K8b/f32") take
K4/f32's numbers: outputs of rms about 1, f32 on both sides. K7's int8 weights are exact in TF32, so two products (a_hi q
+ a_lo q) give the 3xTF32 accuracy. Their emulated rounding lies at most
6.2e-7 of rms(b) off in the whole-tensor error; one TF32 pass 1.2e-4 to
4.8e-4, K7's scale folded into its weights before the dot 1.2e-4, K8a's
bias dropped 7.1e-2, a dropped ragged k step 9.8e-2 to 0.45, K6's
residual added twice 0.32, K7's s2 dropped 1.7e2
(``tests/test_torch_f32_kernels.py``). On the H100 they read at most
1.03e-6.
K4/f32 and K6/f32 run their up and down GEMMs on tf32_gemm.cuh's TF32
wgmma mainloop, as K8a/f32 does, and keep their rows: under the truncation
model (a fresh accumulator a 32-deep stage, added in round-to-nearest) the
emulation lies at most 6.7e-7 of rms(b) off; a gate half read from Wa's
rows, a fresh accumulator never zeroed or a stage summed against the
previous stage's B lo, in either GEMM, 5.2e-5 to 4.8; one accumulator over
the down product's 5120-deep contraction 2.6e-5 to 2.8e-5 (x of rms 1, s =
1), past the 2e-5 bound (``tests/test_torch_f32_kernels.py``).
K7/f32 runs K4/f32's two GEMMs on the same mainloop's int8 B mode (its
weight bytes converted to f32 in shared memory, two products a product)
and keeps its row: the emulation lies at most 2.2e-7 of rms(b) off; bytes
converted as unsigned, a gate box read at Qa's rows, a fresh accumulator
never zeroed or a stage converted from the previous stage's bytes 0.24 to
3.8; one accumulator over a 5120-deep down product 1.6e-5, inside the row
(``tests/test_torch_f32_kernels.py``).
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the kernels to
these numbers; ``tests/test_torch_kernels.py`` and
``tests/test_torch_quant.py`` show on the CPU that they pass the kernels'
rounding and fail planted faults.
"""
from __future__ import annotations

import torch

# kid -> (atol, rtol, rms_rel); the atol of RMS_SCALED kernels is in units
# of rms(b)
TOLERANCE = {"K1": (0.03, 1e-2, 1e-2), "K2": (1e-2, 1e-2, 1e-2),
             "K3": (1e-2, 1e-2, 1e-2), "K4": (2e-2, 2e-2, 1e-2),
             "K5a": (0.03, 1e-2, 2e-3), "K5b": (0.03, 1e-2, 2e-3),
             "K6": (2e-2, 2e-2, 1e-2), "K7": (2e-2, 2e-2, 1e-2),
             "K8a": (2e-2, 2e-2, 1e-2), "K8b": (2e-2, 2e-2, 1e-2),
             "lse": (1e-3, 1e-4, 1e-2),
             # the f32 forms
             "K1/f32": (1e-3, 1e-3, 5e-5), "lse/f32": (1e-4, 0.0, 1e-5),
             "K2/f32": (1e-4, 1e-4, 2e-5), "K4/f32": (1e-4, 1e-4, 2e-5),
             "K5a/f32": (1e-3, 1e-3, 5e-5), "K5b/f32": (1e-3, 1e-3, 5e-5),
             "K6/f32": (1e-4, 1e-4, 2e-5), "K7/f32": (1e-4, 1e-4, 2e-5),
             "K8a/f32": (1e-4, 1e-4, 2e-5), "K8b/f32": (1e-4, 1e-4, 2e-5)}
RMS_SCALED = ("K1", "K5a", "K5b", "K1/f32", "K5a/f32", "K5b/f32")


def tol_id(kid, dtype) -> str:
    """The tolerance row of kernel ``kid`` (or "lse") on ``dtype`` operands:
    "K1/f32" for f32, "K1" for bf16 (K3 keeps one row for both)."""
    f32 = dtype is torch.float32 and f"{kid}/f32" in TOLERANCE
    return f"{kid}/f32" if f32 else kid


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
