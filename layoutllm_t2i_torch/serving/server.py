"""HTTP serving frontend (stdlib only) over the MicroBatcher
(layoutllm_t2i_tpu/serving/server.py).

Endpoints:
  POST /generate   JSON {"prompt": str,
                         "layout": [{"phrase": str, "box": [l,t,r,b]}, ...],
                         "relations": [str, ...]?, "seed": int?,
                         "format": "png" | "json"}
                   -> image/png bytes, or JSON {"image_b64": ...}.
  GET  /healthz    -> 200 {"ok": true} once the warm-up request is served.
  GET  /metrics    -> batcher counters + latency percentiles.
  POST /metrics/reset -> zero them.

The threading server gives each connection a thread; all of them funnel into
the single batcher worker, which turns concurrency into fixed-size batches
on the card. Boxes are normalized xyxy in [0, 1] (reference
interface.py:157-219). Images are written as 8-bit RGB PNG by
utils/images.py's writer (zlib + struct): the same pixels the JAX package's
Pillow writer stores, with no imaging library needed.
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.images import png_bytes as _png_bytes
from .batcher import MicroBatcher


class GenerationServer:
    def __init__(self, pipeline, batch_size: int = 4, max_delay_ms: float = 50.0,
                 host: str = "127.0.0.1", port: int = 8501, warmup: bool = True):
        self.batcher = MicroBatcher(pipeline, batch_size, max_delay_ms)
        self.ready = threading.Event()

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    ok = server.ready.is_set()
                    self._json(200 if ok else 503, {"ok": ok})
                elif self.path == "/metrics":
                    self._json(200, server.batcher.metrics())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path == "/metrics/reset":
                    server.batcher.reset_metrics()
                    return self._json(200, {"ok": True})
                if self.path != "/generate":
                    return self._json(404, {"error": "not found"})
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    prompt = req["prompt"]
                    layout = req.get("layout", [])
                    boxes = [item["box"] for item in layout]
                    phrases = [item["phrase"] for item in layout]
                    img = server.batcher.submit(
                        prompt, boxes, phrases,
                        relations=req.get("relations"),
                        seed=int(req.get("seed", 42)),
                        timeout=float(req.get("timeout_s", 600)),
                    )
                except KeyError as e:
                    return self._json(400, {"error": f"missing field {e}"})
                except Exception as e:
                    return self._json(500, {"error": f"{type(e).__name__}: {e}"})
                png = _png_bytes(img)
                if req.get("format", "png") == "json":
                    return self._json(200, {
                        "image_b64": base64.b64encode(png).decode()})
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

        # bind the socket before warming up, so deployments can probe
        # /healthz (503 until the warm-up request is served: the kernels'
        # first launches and cuDNN's algorithm selection) instead of being
        # refused
        if warmup:
            def _warm():
                try:
                    self.batcher.submit("warmup", [[0.25, 0.25, 0.75, 0.75]],
                                        ["warmup"])
                finally:
                    self.ready.set()

            self._warmup_thread = threading.Thread(target=_warm, daemon=True)
            self._warmup_thread.start()
        else:
            self.ready.set()

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
