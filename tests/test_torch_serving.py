"""The port's serving path on the CPU (tests/test_serving.py's checks):
the micro-batcher's coalescing, padding, per-request seeds across batch
compositions and close(); the HTTP endpoints; the speed modes with int8;
the stdlib PNG writer against Pillow's decode; ``cli/serve.py`` as a
process (``--small --device cpu --fast``) answering /generate with a PNG,
and its refusal of ``--tp``.
"""
import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from layoutllm_t2i_torch.cli import serve as serve_cli
from layoutllm_t2i_torch.pipeline.inference import InferencePipeline
from layoutllm_t2i_torch.pipeline.loaders import quantize_unet_int8, random_models
from layoutllm_t2i_torch.serving.batcher import MicroBatcher
from layoutllm_t2i_torch.serving.server import GenerationServer, _png_bytes
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
BOX, PHRASE = [[0.2, 0.2, 0.7, 0.7]], ["cat"]


@pytest.fixture(scope="module")
def pipe():
    return InferencePipeline(random_models(small=True, device="cpu"), steps=2,
                             guidance_scale=7.5)


def _concurrently(calls):
    threads = [threading.Thread(target=c) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)


def test_batcher_coalesces_concurrent_requests(pipe):
    b = MicroBatcher(pipe, batch_size=2, max_delay_ms=2000)
    try:
        results = {}

        def call(i):
            results[i] = b.submit(f"prompt {i}", [[0.1, 0.1, 0.6, 0.6]],
                                  ["thing"], seed=7, timeout=600)

        _concurrently([lambda i=i: call(i) for i in range(2)])
        m = b.metrics()
        assert (m["requests"], m["batches"], m["padded_rows"]) == (2, 1, 0)
        assert m["latency_p50_ms"] > 0
        for i in range(2):
            assert results[i].shape == (16, 16, 3)
        # different prompts in one batch: different images
        assert not np.allclose(results[0], results[1])
    finally:
        b.close()


def test_per_request_seed_reproducible_across_batch_compositions(pipe):
    """A request's image is a function of its own seed, not of the batch it
    was served in: solo (padded) and coalesced with a stranger agree."""
    b1 = MicroBatcher(pipe, batch_size=2, max_delay_ms=10)
    try:
        solo = b1.submit("a cat", BOX, PHRASE, seed=5, timeout=600)
    finally:
        b1.close()

    b2 = MicroBatcher(pipe, batch_size=2, max_delay_ms=2000)
    try:
        results = {}

        def call(name, prompt, seed):
            results[name] = b2.submit(prompt, BOX, PHRASE, seed=seed, timeout=600)

        _concurrently([lambda: call("mine", "a cat", 5),
                       lambda: call("other", "a dog", 9)])
        assert b2.metrics()["batches"] == 1
    finally:
        b2.close()
    np.testing.assert_allclose(solo, results["mine"], atol=1e-5, rtol=1e-5)


def test_row_noise_depends_on_its_seed_alone(pipe):
    a, _ = pipe._batch_noise(3, 0, seeds=[5, 9, 5])
    b, _ = pipe._batch_noise(1, 0, seeds=[5])
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[0])
    assert not torch.equal(a[0], a[1])
    # without seeds: one batch draw from the seed, as before
    c, _ = pipe._batch_noise(2, 3)
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(c, torch.randn((2, 8, 8, 4), generator=gen))
    with pytest.raises(ValueError, match="seeds"):
        pipe._batch_noise(2, 0, seeds=[1])


def test_batcher_pads_short_batches(pipe):
    b = MicroBatcher(pipe, batch_size=2, max_delay_ms=10)
    try:
        img = b.submit("solo", BOX, PHRASE, timeout=600)
        assert img.shape[-1] == 3
        m = b.metrics()
        assert m["batches"] == 1 and m["padded_rows"] == 1
        b.reset_metrics()
        assert b.metrics() == {"requests": 0, "batches": 0, "padded_rows": 0,
                               "errors": 0}
    finally:
        b.close()


def test_batcher_close_unblocks_queued_requests(pipe):
    b = MicroBatcher(pipe, batch_size=1, max_delay_ms=10)
    b.close()
    with pytest.raises(RuntimeError):
        b.submit("late", [[0.1, 0.1, 0.5, 0.5]], ["x"], timeout=5)


def test_batcher_delivers_pipeline_errors(pipe):
    class Broken:
        def generate(self, *a, **kw):
            raise RuntimeError("boom")

    b = MicroBatcher(Broken(), batch_size=1, max_delay_ms=10)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b.submit("x", BOX, PHRASE, timeout=60)
        assert b.metrics()["errors"] == 1
    finally:
        b.close()


def test_http_server_endpoints(pipe):
    srv = GenerationServer(pipe, batch_size=2, max_delay_ms=10, port=0,
                           warmup=True)
    srv.start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert (r.status, json.loads(r.read())["ok"]) in ((503, False), (200, True))
        assert srv.ready.wait(600)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["ok"]

        # the warm-up request is counted: zero the counters after it
        conn.request("POST", "/metrics/reset")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["ok"]
        body = json.dumps({
            "prompt": "a dog in a park",
            "layout": [{"phrase": "dog", "box": [0.2, 0.4, 0.5, 0.9]}],
            "relations": ["dog in park"], "seed": 3})
        conn.request("POST", "/generate", body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        png = r.read()
        assert r.status == 200 and r.getheader("Content-Type") == "image/png"
        want = pipe.generate(["a dog in a park"] * 2,
                             [([[0.2, 0.4, 0.5, 0.9]], ["dog"])] * 2,
                             [["dog in park"]] * 2, seeds=[3, 3])[0]
        assert png == _png_bytes(want)

        conn.request("POST", "/generate", body=json.dumps(
            {"prompt": "x", "layout": [], "format": "json"}))
        r = conn.getresponse()
        assert r.status == 200 and "image_b64" in json.loads(r.read())

        conn.request("POST", "/generate", body=json.dumps({"layout": []}))
        r = conn.getresponse()
        assert r.status == 400 and "prompt" in json.loads(r.read())["error"]

        conn.request("GET", "/nowhere")
        r = conn.getresponse()
        assert r.status == 404 and r.read()

        conn.request("GET", "/metrics")
        m = json.loads(conn.getresponse().read())
        assert (m["requests"], m["batches"], m["padded_rows"], m["errors"]) == (
            2, 2, 2, 0)
    finally:
        srv.shutdown()


def test_batcher_with_speed_modes():
    """int8 weights, DPM at 4 steps and a guidance interval through the
    batcher: finite, and a request repeats bit for bit."""
    models = quantize_unet_int8(random_models(small=True, device="cpu"),
                                min_size=128)
    pipe = InferencePipeline(models, steps=4, sampler="dpm", guidance_scale=7.5,
                             alpha_type=(0.3, 0.0, 0.7), cfg_interval=(0.1, 0.85),
                             encoder_cache_interval=2)
    b = MicroBatcher(pipe, batch_size=2, max_delay_ms=50)
    try:
        img = b.submit("a dog", [[0.2, 0.2, 0.8, 0.8]], ["dog"], seed=3, timeout=600)
        assert img.ndim == 3 and np.isfinite(img).all()
        again = b.submit("a dog", [[0.2, 0.2, 0.8, 0.8]], ["dog"], seed=3,
                         timeout=600)
        np.testing.assert_array_equal(img, again)
        assert b.metrics()["errors"] == 0
    finally:
        b.close()


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (16, 16, 3)])
def test_png_writer_matches_pillow_decode(rng, shape):
    img = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    png = _png_bytes(img)
    decoded = Image.open(io.BytesIO(png))
    assert decoded.mode == "RGB" and decoded.size == (shape[1], shape[0])
    np.testing.assert_array_equal(np.asarray(decoded),
                                  (np.clip(img, 0, 1) * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="RGB"):
        _png_bytes(img[..., :1])


def test_tp_is_refused():
    """--tp runs (tests/test_torch_parallel_serve.py); NCCL on the CPU is
    refused, before any group or model is made."""
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        serve_cli.main(["--small", "--device", "cpu", "--tp", "--tp_backend",
                        "nccl", "--port", "0"])


def test_cli_fast_flags_build_the_preset_pipeline():
    srv, steps = serve_cli.build_server(serve_cli.parse_args(
        ["--small", "--device", "cpu", "--fast", "--port", "0", "--host",
         "127.0.0.1", "--no_warmup", "--batch", "2"]))
    srv.start_background()
    try:
        pipe = srv.batcher.pipeline
        assert (pipe.sampler, steps, pipe.cfg_interval,
                pipe.encoder_cache_interval) == ("dpm", 15, (0.0, 0.75), 2)
        assert srv.batcher.batch_size == 2 and srv.ready.is_set()
    finally:
        srv.shutdown()


def test_cli_serves_a_png_on_the_cpu():
    """``python -m layoutllm_t2i_torch.cli.serve --small --device cpu
    --fast`` as a process: /healthz turns 200, /generate answers a PNG."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "layoutllm_t2i_torch.cli.serve", "--small",
         "--device", "cpu", "--fast", "--host", "127.0.0.1", "--port", "0",
         "--batch", "1"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        # the first line that names the port (a library may warn before it)
        line = next((l for l in proc.stdout if l.startswith("serving on ")), "")
        assert line.startswith("serving on 127.0.0.1:"), proc.poll()
        port = int(line.split(":")[1].split()[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        deadline = time.monotonic() + 300
        while True:
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            r.read()
            if r.status == 200 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert r.status == 200
        conn.request("POST", "/generate", body=json.dumps({
            "prompt": "a dog", "layout": [{"phrase": "dog",
                                           "box": [0.2, 0.4, 0.5, 0.9]}]}))
        r = conn.getresponse()
        png = r.read()
        assert r.status == 200
        assert np.asarray(Image.open(io.BytesIO(png))).shape == (16, 16, 3)
    finally:
        proc.terminate()
        proc.wait(60)
        proc.stdout.close()
