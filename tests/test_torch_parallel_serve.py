"""The port's parallel/ entry points at world 2 on the CPU (gloo), port
against port, and the kernel build's lock.

* Two ranks of ``tests/torch_parallel_worker.py`` (job ``paths``, run once
  for the module): ``sample_latents_tp`` ('spatial' and 'heads') on an int8
  bundle with DPM-Solver++, the guidance interval and the encoder cache
  (tests/test_tp.py:152-168's composition) against the same pipeline in
  one process, within 2e-4; ``generate_sharded`` against ``generate`` for
  the same seed, per-request seeds and DDIM at eta 0.5 (its step noise
  drawn for the whole batch); ``cli/bench.py --sharded``, ``eval/nss1k.py
  --sharded`` (3 examples at batch 2: a padded tail) and ``cli/txt2img.py``'s
  sharded sweep through their main().
* ``cli/serve.py --tp`` as two processes: rank 0 answers two POSTs with
  PNGs and counts them in /metrics; on SIGINT it broadcasts the stop and
  both ranks exit 0, the follower having run every batch. A fault planted
  on rank 1 in the middle of a batch ends both ranks with an error.
* ``kernels/build.py``: two processes build one stub source at once; one
  compiles, and neither sees a half-written library.
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from layoutllm_t2i_torch.utils.images import read_png
from torch_kernel_stub import FAKE_NVCC
from torch_parallel_worker import REPO, spawn_world, wait_world
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SINGLE_TOL = 2e-4   # tests/test_tp.py:41
SHARDED_TOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = [
    {"img_id": i, "name": f"{i}.png", "width": 640, "height": 480,
     "bbox": [[0.3, 0.6, 0.4, 0.5]], "label": [lab],
     "captions": f"a {lab} on the grass"}
    for i, lab in enumerate(("dog", "cat", "horse"), start=1)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("paths")
    (d / "split.json").write_text(json.dumps(EXAMPLES))
    procs = spawn_world([os.path.join(HERE, "torch_parallel_worker.py"),
                         "paths", str(d)])
    wait_world(procs, timeout=300)
    # written by the ranks just now
    return torch.load(d / "paths.pt", weights_only=False)


@pytest.mark.parametrize("style", ["spatial", "heads"])
def test_tp_composes_with_int8_dpm_interval_and_cache(paths, style):
    got, ref = paths[f"compose_{style}"].numpy(), paths["compose_ref"].numpy()
    assert got.shape == ref.shape == (1, 16, 16, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=SINGLE_TOL)


@pytest.mark.parametrize("case", ["plms", "seeds", "ddim"])
def test_generate_sharded_equals_generate(paths, case):
    got, ref = paths[f"sharded_{case}"], paths[f"single_{case}"]
    assert got.shape == ref.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(got, ref, atol=SHARDED_TOL)


def test_bench_sharded_runs_at_world_2(paths):
    rec = json.loads(paths["bench"].strip().splitlines()[-1])
    assert rec["metric"] == "images_per_sec_per_chip" and rec["value"] > 0
    assert rec["ranks"] == 2 and "fast_value" not in rec


def test_nss1k_sharded_pads_the_tail_at_world_2(paths):
    rec = json.loads(paths["nss1k"].strip().splitlines()[-1])
    assert rec["n"] == 3 and np.isfinite(rec["clip_score_mean"])


def test_txt2img_sharded_sweep_writes_on_rank_0(paths):
    names = [os.path.basename(p) for p in paths["txt2img"]]
    assert names == ["a dog_0.png", "a dog_1.png"]
    assert paths["txt2img_files"] == names


def _get(conn, method, path, body=None):
    conn.request(method, path, body=body)
    r = conn.getresponse()
    return r.status, r.read()


SERVE_TP = ["--small", "--device", "cpu", "--tp", "--steps", "2", "--host",
            "127.0.0.1", "--port", "0"]


def _spawn_serve(code: str):
    """Two ranks of ``python -c CODE`` (which runs cli/serve.py's main),
    their output piped; a native abort dumps its Python stacks."""
    return spawn_world(["-c", code], env_extra={"PYTHONFAULTHANDLER": "1"},
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)


def _port_of(proc) -> int:
    line = next((l for l in proc.stdout if l.startswith("serving on ")), "")
    assert line.startswith("serving on 127.0.0.1:"), proc.poll()
    assert "batch=1" in line
    return int(line.split(":")[1].split()[0])


def _finish(procs, timeout: float):
    """Every rank's exit code ("timeout" where it ran past ``timeout`` s
    of the call and was killed) and its remaining output."""
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append("timeout")
    return codes, [p.stdout.read() for p in procs]


def test_serve_tp_world_2_answers_and_stops():
    procs = _spawn_serve("from layoutllm_t2i_torch.cli import serve; "
                         f"serve.main({SERVE_TP!r})")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", _port_of(procs[0]),
                                          timeout=240)
        deadline = time.monotonic() + 240
        while _get(conn, "GET", "/healthz")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.2)
        assert _get(conn, "POST", "/metrics/reset")[0] == 200
        for prompt in ("a dog", "a cat on a chair"):
            status, png = _get(conn, "POST", "/generate", json.dumps({
                "prompt": prompt, "layout": [{"phrase": prompt.split()[1],
                                              "box": [0.2, 0.4, 0.5, 0.9]}]}))
            assert status == 200 and read_png(png).shape == (16, 16, 3)
        status, body = _get(conn, "GET", "/metrics")
        assert status == 200 and json.loads(body)["requests"] == 2
        procs[0].send_signal(signal.SIGINT)
        codes, outs = _finish(procs, timeout=120)
        assert codes == [0, 0], (codes, outs)
        assert "rank 1: 3 batches, stopped" in outs[1]   # the warm-up and 2
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()


FAULT = """
import os
from layoutllm_t2i_torch.cli import serve
from layoutllm_t2i_torch.parallel import collectives
if os.environ["RANK"] == "1":
    real, n = collectives.all_gather, [0]
    def all_gather(*a, **kw):
        n[0] += 1
        if n[0] == 5:
            raise RuntimeError("planted fault on rank 1")
        return real(*a, **kw)
    collectives.all_gather = all_gather
serve.main(%r)
"""


def test_serve_tp_a_fault_on_one_rank_ends_both():
    """Rank 1 raises in the middle of a batch, where rank 0 is in a
    collective it will never join: rank 0's collective fails, the request
    gets no image, and both ranks exit non-zero well inside the group's
    seven-day timeout."""
    procs = _spawn_serve(FAULT % (SERVE_TP + ["--no_warmup"]))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", _port_of(procs[0]),
                                          timeout=120)
        try:
            status = _get(conn, "POST", "/generate", json.dumps({
                "prompt": "a dog", "layout": [{"phrase": "dog",
                                               "box": [0.2, 0.4, 0.5, 0.9]}]}))[0]
        except (ConnectionError, http.client.HTTPException):
            status = None     # the server went down before its reply
        assert status != 200
        codes, outs = _finish(procs, timeout=120)
        assert "timeout" not in codes and 0 not in codes, (codes, outs)
        assert "planted fault on rank 1" in outs[1]
        assert "serve --tp: a batch failed" in outs[0], outs[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()


def test_build_lock_two_processes_one_compile(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "stub.cu").write_text("// stub\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    env = dict(os.environ, FAKE_NVCC_LOG=str(tmp_path / "nvcc.log"),
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_kernel_stub.py"),
         str(tmp_path)], env=env, cwd=REPO, stdout=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs == [["whole"], ["whole"]]
    assert len((tmp_path / "nvcc.log").read_text().splitlines()) == 1
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_chip_smoke_parallel_child_rehearses_on_the_cpu(tmp_path):
    """chip_smoke.py phase parallel's rank at the small geometry on the CPU
    (gloo, world 2): every run's images against its own generate at the
    phase's PSNR gate, the K2 split pair's calls recorded."""
    code = ("import sys, torch; torch.set_num_threads(1); import chip_smoke; "
            f"sys.exit(chip_smoke.parallel_child('gloo', {str(tmp_path)!r}, "
            "'cpu', True))")
    procs = spawn_world(["-c", code], env_extra={"PYTHONHASHSEED": "0"})
    wait_world(procs, timeout=300)
    for rank in range(2):
        rec = json.loads((tmp_path / f"rank{rank}.json").read_text())
        assert rec["world"] == 2 and rec["backend"] == "gloo"
        assert set(rec["psnr_db"]) == {"sharded", "heads", "spatial"}
        assert all(v >= 35.0 for v in rec["psnr_db"].values()), rec["psnr_db"]
        assert any(kid == "K2" and "split2" in args for kid, args in rec["calls"])
