"""The kernels' host path on the CPU: the checks a wrapper makes before a
pointer reaches C, the library binding and the stream handle.

``check_operand`` raises the messages the card tests match, on a wrong
dtype, a non-contiguous operand and an operand on another device (CPU and
meta tensors against a CUDA device index); ``use_kernel`` sends CPU
tensors to the plain versions and refuses other devices; ``lib`` builds and
binds each library once, however many calls and threads ask for it;
``stream_handle`` reads the current stream at every call. The card's side
(the raw handle against ``torch.cuda.current_stream().cuda_stream``) is
checked by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import ctypes
import sys
import threading

import pytest
import torch

from layoutllm_t2i_torch.kernels import build
from layoutllm_t2i_torch.kernels.dispatch import (check_operand, needs_grad,
                                                  require_aligned,
                                                  stream_handle, use_kernel)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("make,dtype,match", [
    (lambda: torch.zeros(4, 8), torch.bfloat16,
     "layer_norm: x: dtype torch.float32, expected torch.bfloat16"),
    (lambda: torch.zeros(4, 8, dtype=torch.int8), torch.float32,
     "layer_norm: x: dtype torch.int8, expected torch.float32"),
    (lambda: torch.zeros(8, 4, dtype=torch.bfloat16).t(), torch.bfloat16,
     "layer_norm: x: must be contiguous"),
    (lambda: torch.zeros(4, 8, dtype=torch.bfloat16), torch.bfloat16,
     "layer_norm: x: on cpu, expected cuda:0"),
    (lambda: torch.zeros(4, 8, dtype=torch.bfloat16, device="meta"),
     torch.bfloat16, "layer_norm: x: on meta, expected cuda:0"),
])
def test_check_operand_raises_the_card_tests_messages(make, dtype, match):
    with pytest.raises(ValueError) as err:
        check_operand(make(), "layer_norm: x", 0, dtype)
    assert str(err.value) == match


def test_require_aligned_raises_on_a_view_off_the_boundary():
    buf = torch.zeros(64, dtype=torch.int8)
    require_aligned(buf, "q1", 16)
    with pytest.raises(ValueError,
                       match="q1: data_ptr\\(\\) must be 16-byte aligned"):
        require_aligned(buf[1:], "q1", 16)


def test_use_kernel_sends_cpu_to_the_plain_version_and_refuses_others():
    assert use_kernel(torch.zeros(2)) is False
    with pytest.raises(ValueError, match="unsupported device meta"):
        use_kernel(torch.zeros(2, device="meta"))


def test_needs_grad():
    x, w = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert not needs_grad(x, 1.0, None)
    assert needs_grad(x, w)
    with torch.no_grad():
        assert not needs_grad(x, w)


@pytest.fixture
def fake_libs(monkeypatch, tmp_path):
    """``build`` with nvcc and the loader faked: build_all writes empty
    library files and counts its calls, ctypes.CDLL counts the loads."""
    calls = {"build_all": 0, "cdll": []}
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "lib_path", lambda name: tmp_path / f"{name}.so")

    def build_all():
        calls["build_all"] += 1
        for name in build.SOURCES:
            build.lib_path(name).write_bytes(b"")
        return {}

    class FakeFunc:
        argtypes = restype = None

        def __call__(self, *args):
            return 0

    class FakeCDLL:
        def __init__(self, path):
            calls["cdll"].append(path)

        def __getattr__(self, fn):
            f = FakeFunc()
            setattr(self, fn, f)  # bound once, as CDLL caches its functions
            return f

    monkeypatch.setattr(build, "build_all", build_all)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeCDLL)
    return calls


@pytest.mark.parametrize("threads", [1, 16])
def test_lib_builds_and_binds_each_library_once(fake_libs, threads):
    # more threads than cores, switching often: a load outside the lock
    # would build or bind twice
    handles = []

    def ask():
        for _ in range(50):
            handles.append(build.lib("layer_norm"))

    workers = [threading.Thread(target=ask) for _ in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert len(handles) == 50 * threads
    assert fake_libs["build_all"] == 1
    assert len(fake_libs["cdll"]) == 1
    assert all(h is handles[0] for h in handles)
    fn = handles[0].llt2i_layer_norm
    assert fn is build.lib("layer_norm").llt2i_layer_norm
    assert fn.argtypes == build.SIGNATURES["layer_norm"]["llt2i_layer_norm"]
    assert fn.restype is ctypes.c_int
    # a second library is loaded without another build
    build.lib("ffn")
    assert fake_libs["build_all"] == 1 and len(fake_libs["cdll"]) == 2


def test_stream_handle_reads_the_current_stream_at_every_call(monkeypatch):
    current = {0: 1111, 1: 2222}
    asked = []

    def raw(index):
        asked.append(index)
        return current[index]

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw,
                        raising=False)
    assert stream_handle(0) == 1111
    current[0] = 3333  # a torch.cuda.stream(...) block entered
    assert stream_handle(0) == 3333 and stream_handle(1) == 2222
    assert asked == [0, 0, 1]
