"""Time K4 and K8a on the card with each GEMM tile width forced.

Run from the repository root on a machine with one H100:
  python3 layoutllm_t2i_torch/cli/gemm_tiles_sweep.py
K4's up kernel always takes 128 x (2 x 128) tiles; K8a and K4's down
kernel take 128 x 160 or 128 x 80 tiles as ``gemm_tiles.cuh pick_narrow``
decides from the shape and the card's SMs. This script builds variants of
``csrc/ffn.cu`` and ``csrc/matmul.cu`` from copies of the sources under
``build/tiles_sweep/`` (listed in ``.gitignore``): the up kernel 128 or 64
wide, and ``pick_narrow`` forced to the wide or the narrow width. Then, at
the main-path shapes (K4 at s = 1 on its six (M, K), K8a at its three
(M, K, N)), it has the wrappers launch each variant in turn, checks its
output against the plain version and prints one JSON line per variant:
device ms a call, behind a device-side sleep (``chip_smoke.device_time``),
and the library call's beside the shipped choice. Each variant is timed
``--reps`` times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

K4_SHAPES = ((16384, 320), (4096, 640), (1024, 1280), (32768, 320),
             (8192, 640), (2048, 1280))
K8A_SHAPES = ((16384, 1280, 320), (4096, 2560, 640), (1024, 5120, 1280))
UP_CFG = "using UpCfg = gemm_tiles::Cfg<128, 2>;"
PICK = "inline bool pick_narrow(int M, int N, int wide, int narrow) {\n"


def variant_sources(src_dir, out_dir, up: int, narrow):
    """A copy of the sources with the up kernel ``up`` wide and, unless
    ``narrow`` is None, pick_narrow returning ``narrow``."""
    shutil.copytree(src_dir, out_dir)
    _patch(os.path.join(out_dir, "ffn.cu"), UP_CFG,
           f"using UpCfg = gemm_tiles::Cfg<{up}, 2>;")
    if narrow is not None:
        _patch(os.path.join(out_dir, "gemm_tiles.cuh"), PICK,
               PICK + f"  return {'true' if narrow else 'false'};\n")


def _patch(path, old, new):
    with open(path) as f:
        text = f.read()
    if old not in text:
        raise RuntimeError(f"{path} no longer holds {old.strip()!r}")
    with open(path, "w") as f:
        f.write(text.replace(old, new, 1))


# (up width, down label, pick_narrow forced to): the four forced tilings,
# then the shipped one
VARIANTS = ((128, "160", False), (128, "80", True), (64, "160", False),
            (64, "80", True), (128, "pick", None))


def build_variants(build):
    """{(up, down): {library: loaded handle}}, all nvcc runs at once; matmul
    (K8a, no up kernel) only for the 128-wide variants."""
    root = os.path.join(build.PKG_DIR.parent, "build", "tiles_sweep")
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for up, down, narrow in VARIANTS:
        src = os.path.join(root, f"up{up}_down{down}")
        variant_sources(build.CSRC_DIR, src, up, narrow)
        for lib in ("ffn", "matmul") if up == 128 else ("ffn",):
            out = os.path.join(src, f"{lib}.so")
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", src, "-o", out,
                   os.path.join(src, f"{lib}.cu")]
            procs.append(((up, down), lib, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    handles = {}
    for key, lib, out, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key} {lib}:\n{text}")
        handle = ctypes.CDLL(out)
        for fn, argtypes in build.SIGNATURES[lib].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = build.RESTYPES.get(fn, ctypes.c_int)
        handles.setdefault(key, {})[lib] = handle
    return handles


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_tiles_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from layoutllm_t2i_torch.kernels import build
    from layoutllm_t2i_torch.kernels.tolerance import agreement

    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line()}), flush=True)
    handles = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = ([("K4", (m, k, 1.0)) for m, k in K4_SHAPES]
             + [("K8a", shape) for shape in K8A_SHAPES])
    ok = True
    for kid, shape in cases:
        kern, plain, lib_fn, _, _ = cs.make_case(kid, shape, dev, gen)
        ref = plain()
        for (up, down), libs in handles.items():
            if kid == "K8a" and "matmul" not in libs:
                continue
            build._libs.update(libs)
            agree = agreement(kid, kern(), ref)
            ok = ok and agree["ok"]
            rec = {"kernel": kid, "shape": shape, "down": down,
                   "ok": agree["ok"],
                   "device_ms": [cs.device_time(kern)[0] for _ in range(args.reps)]}
            if kid == "K4":
                rec["up"] = up
            if down == "pick":
                rec["library_device_ms"] = cs.device_time(lib_fn)[0]
            print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
