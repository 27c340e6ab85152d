"""The kernel path of the FF and GEMM wrappers on the CPU, for route tests.

The wrappers of ``kernels/ffn.py`` (K4, K6, K7) and ``kernels/matmul.py``
(K8a, K8b) take their kernel path only for CUDA tensors. ``stub_kernels``
makes them take it for CPU tensors and puts a recording stub in place of
the built libraries, so a test sees which C entry each call reaches (the
bf16 or the f32 form, picked from the operand type) with no card. The
wrappers still check every operand's type and contiguity, its shapes and
its alignment; the stub writes nothing, so their outputs are left unset.
"""
from layoutllm_t2i_torch.kernels import ffn, matmul

# kernel id -> its f32 form's C entry
F32_ENTRY = {"K4": "llt2i_ffn_ln_geglu_f32", "K6": "llt2i_ffn_geglu_f32",
             "K7": "llt2i_ffn_ln_geglu_q_f32", "K8a": "llt2i_linear_f32",
             "K8b": "llt2i_geglu_f32"}


class RecordingLib:
    """Stands for a built library: every ``llt2i_*`` entry records its name
    and returns 0 (cudaSuccess)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("llt2i_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


def _check_operand(t, name, device, dtype):
    if t.dtype is not dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _scale_operand(s, x, what):
    return None, float(s), None


def stub_kernels(monkeypatch) -> RecordingLib:
    """Put the FF and GEMM wrappers on their kernel path for CPU tensors,
    with one RecordingLib for both libraries; returns it."""
    rec = RecordingLib()
    for mod in (ffn, matmul):
        monkeypatch.setattr(mod, "use_kernel", lambda x: True)
        monkeypatch.setattr(mod, "check_operand", _check_operand)
        monkeypatch.setattr(mod, "stream_handle", lambda device: 0)
        monkeypatch.setattr(mod, "lib", lambda name: rec)
    monkeypatch.setattr(ffn, "_scale_operand", _scale_operand)
    return rec


# -- a stub build, for the build lock's test (tests/test_torch_parallel_serve.py)

# writes its output in two halves half a second apart, and logs each call
FAKE_NVCC = '''#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(out + "\\n")
with open(out, "wb") as f:
    f.write(b"A" * 4096)
    f.flush()
    time.sleep(0.5)
    f.write(b"B" * 4096)
'''
STUB_LIBRARY = b"A" * 4096 + b"B" * 4096


def stub_build(root: str) -> bytes:
    """``build.build_all`` of one stub source under ``root`` (csrc/stub.cu,
    build/, the fake nvcc at root/nvcc); returns the library's bytes as
    this process finds them after the build."""
    import pathlib

    from layoutllm_t2i_torch.kernels import build

    root = pathlib.Path(root)
    build.CSRC_DIR = root / "csrc"
    build.BUILD_DIR = root / "build"
    build.SOURCES = ("stub",)
    build.nvcc_path = lambda: str(root / "nvcc")
    build.build_all()
    return build.lib_path("stub").read_bytes()


if __name__ == "__main__":
    import sys

    print("whole" if stub_build(sys.argv[1]) == STUB_LIBRARY else "torn")
