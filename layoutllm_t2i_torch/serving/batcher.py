"""Micro-batcher: coalesce concurrent generate requests into fixed-size
batches (layoutllm_t2i_tpu/serving/batcher.py).

The batcher holds a request queue, waits up to ``max_delay_ms`` after the
first request for the batch to fill, pads the remainder by repeating the
last request (padded rows are computed and discarded), and fans results
back out to the callers. A fixed batch keeps one set of kernel shapes and
cuDNN/cuBLAS algorithm choices warm, and every request carries its own
seed (InferencePipeline.generate ``seeds``), so its image does not depend
on the batch it lands in.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class _Request:
    prompt: str
    layout: Tuple[Sequence[Sequence[float]], Sequence[str]]
    relations: Optional[Sequence[str]]
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    t_enqueue: float = field(default_factory=time.monotonic)


class MicroBatcher:
    """Thread-safe request coalescer in front of ``InferencePipeline``.

    submit() blocks the calling thread until its image is ready; a single
    worker thread owns the card, so one generation runs at a time.
    """

    def __init__(self, pipeline, batch_size: int = 4, max_delay_ms: float = 50.0):
        self.pipeline = pipeline
        self.batch_size = int(batch_size)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stats: Dict[str, Any] = {
            "requests": 0, "batches": 0, "padded_rows": 0,
            "errors": 0, "latencies_ms": [],
        }
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, prompt: str, boxes: Sequence[Sequence[float]],
               phrases: Sequence[str], relations: Optional[Sequence[str]] = None,
               seed: int = 42, timeout: Optional[float] = None):
        """Returns the generated image (H, W, 3) float in [0, 1]."""
        if self._stop.is_set():
            raise RuntimeError("batcher closed")
        req = _Request(prompt, (list(boxes), list(phrases)),
                       list(relations) if relations else None, int(seed))
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout=5)
        # fail any requests still queued (e.g. behind the sentinel) so their
        # submit() callers unblock instead of hanging until timeout
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.done.is_set():
                req.error = RuntimeError("batcher closed before dispatch")
                req.done.set()

    # -- worker side ---------------------------------------------------------

    def _collect(self) -> List[_Request]:
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_delay_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            n = len(batch)
            pad = self.batch_size - n
            rows = batch + [batch[-1]] * pad  # fixed-shape padding
            try:
                imgs = self.pipeline.generate(
                    [r.prompt for r in rows],
                    [r.layout for r in rows],
                    relation_texts=([r.relations or [] for r in rows]
                                    if any(r.relations for r in rows) else None),
                    seeds=[r.seed for r in rows],
                )
                now = time.monotonic()
                with self._lock:
                    self.stats["requests"] += n
                    self.stats["batches"] += 1
                    self.stats["padded_rows"] += pad
                    lat = self.stats["latencies_ms"]
                    lat.extend((now - r.t_enqueue) * 1e3 for r in batch)
                    del lat[:-1000]  # keep a bounded window
                for i, r in enumerate(batch):
                    r.result = imgs[i]
                    r.done.set()
            except BaseException as e:  # deliver failures to callers
                with self._lock:
                    self.stats["errors"] += 1
                for r in batch:
                    r.error = e
                    r.done.set()

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            lat = sorted(self.stats["latencies_ms"])
            out = {k: v for k, v in self.stats.items() if k != "latencies_ms"}
        if lat:
            out["latency_p50_ms"] = lat[len(lat) // 2]
            out["latency_p99_ms"] = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
        return out

    def reset_metrics(self) -> None:
        """Zero the counters and the latency window: called after the
        warm-up, so the first request's kernel builds and algorithm
        selection stay out of the steady-state percentiles."""
        with self._lock:
            for k in self.stats:
                self.stats[k] = [] if k == "latencies_ms" else 0
