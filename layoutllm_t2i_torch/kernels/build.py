"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). All
sources compile in parallel, one ``nvcc`` process each, at first use; the
outputs go to ``build/kernels/`` at the repository root (listed in
``.gitignore``) under a name that carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused.

Several processes may reach first use at once (the ranks of a
torch.distributed group): the build holds an exclusive ``flock`` on
``build/kernels/build.lock``, so one process compiles while the others
wait and then find the libraries built, and each library is written under
a temporary name and renamed into place, so no process loads a
half-written one. The kernel releases a ``flock`` when its process dies,
so a lock file left by a killed build blocks nothing.

Nothing here runs at import time: this module imports on machines without
nvcc or a GPU, where the wrappers only ever take their plain versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

# one shared library per kernel source
SOURCES = ("flash_attention", "group_norm", "layer_norm", "ffn", "matmul")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> (argtypes), restype is int (a cudaError_t)
SIGNATURES = {
    "flash_attention": {
        "llt2i_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
        "llt2i_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _F, _P],
        "llt2i_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _L, _L, _L, _L, _L, _L, _F, _P],
    },
    "group_norm": {
        "llt2i_group_norm_cluster": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _I, _F, _I, _P],
        "llt2i_group_norm_stream": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _F, _I, _P],
        # the streaming pair's launches apart (row-split GroupNorm)
        "llt2i_group_norm_stats": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "llt2i_group_norm_apply": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _F, _I, _P],
        # returns bytes, not a cudaError_t (-1: over a block's limit)
        "llt2i_group_norm_cluster_smem": [_I, _I, _I, _I],
    },
    "layer_norm": {
        "llt2i_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _P],
        "llt2i_layer_norm_f32": [_P, _P, _P, _P, _I, _I, _F, _P],
        # one block a row: any C (the wrapper's route past 2048)
        "llt2i_layer_norm_wide": [_P, _P, _P, _P, _I, _I, _F, _P],
        "llt2i_layer_norm_wide_f32": [_P, _P, _P, _P, _I, _I, _F, _P],
    },
    "ffn": {
        "llt2i_ffn_ln_geglu": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                               _I, _I, _I, _F, _P],
        "llt2i_ffn_geglu": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "llt2i_ffn_ln_geglu_q": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _F, _I, _I, _I, _F, _P],
    },
    "matmul": {
        "llt2i_linear": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "llt2i_geglu": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
}

# the f32 forms of K1, K5a, K5b, K2, K4, K6, K7, K8a and K8b take their bf16
# forms' arguments
F32_TWINS = {"flash_attention": ("llt2i_flash_fwd", "llt2i_flash_bwd_dq",
                                 "llt2i_flash_bwd_dkv"),
             "group_norm": ("llt2i_group_norm_cluster", "llt2i_group_norm_stream",
                            "llt2i_group_norm_stats", "llt2i_group_norm_apply"),
             "ffn": ("llt2i_ffn_ln_geglu", "llt2i_ffn_geglu",
                     "llt2i_ffn_ln_geglu_q"),
             "matmul": ("llt2i_linear", "llt2i_geglu")}
for lib_name, twins in F32_TWINS.items():
    SIGNATURES[lib_name].update({f"{fn}_f32": SIGNATURES[lib_name][fn]
                                 for fn in twins})
# K1/f32 takes a workspace (widths up to 160) before the stream, of the bytes
# that llt2i_flash_fwd_f32_ws returns
SIGNATURES["flash_attention"]["llt2i_flash_fwd_f32"] = (
    SIGNATURES["flash_attention"]["llt2i_flash_fwd"][:-1] + [_P, _P])
SIGNATURES["flash_attention"]["llt2i_flash_fwd_f32_ws"] = [_I, _I, _I, _I]
# K5a/f32 and K5b/f32 take a workspace of llt2i_flash_bwd_f32_ws bytes and
# the pre-pass bits (`prepare`) before the stream
for _fn in ("llt2i_flash_bwd_dq_f32", "llt2i_flash_bwd_dkv_f32"):
    SIGNATURES["flash_attention"][_fn] = (
        SIGNATURES["flash_attention"][_fn][:-1] + [_P, _I, _P])
SIGNATURES["flash_attention"]["llt2i_flash_bwd_f32_ws"] = [_I, _I, _I, _I, _I]
# entry points that return another type than a cudaError_t
RESTYPES = {"llt2i_flash_fwd_f32_ws": _L, "llt2i_flash_bwd_f32_ws": _L}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per-source build record of the last build_all(): seconds and ptxas lines
build_log: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock on the build directory, across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> Dict[str, dict]:
    """Compile every source not yet built, all nvcc processes at once, under
    the build lock. Returns {name: {"seconds": s, "cached": bool, "ptxas":
    [lines]}}."""
    with _build_lock():
        return _build_missing()


def _build_missing() -> Dict[str, dict]:
    nvcc = nvcc_path()
    procs = {}
    for name in SOURCES:
        out = lib_path(name)
        if out.exists():
            build_log[name] = {"seconds": 0.0, "cached": True, "ptxas": []}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{text}")
            continue
        os.replace(tmp, out)
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "Function properties" in ln or "registers" in ln
                 or "spill" in ln or "smem" in ln]
        build_log[name] = {"seconds": secs, "cached": False, "ptxas": ptxas}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return dict(build_log)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for one source, building all sources on first use.
    Once it is loaded this is one dict lookup: the lock is taken only while
    a library is loaded, and each C entry point, typed once at load, stays
    bound on the handle (``lib(name).llt2i_...`` reads the cached function
    object)."""
    handle = _libs.get(name)
    return handle if handle is not None else _load(name)


def _load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            if not all(lib_path(n).exists() for n in SOURCES):
                build_all()
            handle = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(handle, fn)
                f.argtypes = argtypes
                f.restype = RESTYPES.get(fn, ctypes.c_int)
            _libs[name] = handle
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
