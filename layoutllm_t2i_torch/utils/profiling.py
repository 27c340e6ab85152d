"""Tracing and phase timers (layoutllm_t2i_tpu/utils/profiling.py).

Usage:
    with trace("plms_sample", logdir="/tmp/llt2i_trace"):
        pipe.sample_latents(...)
    # or phase timers:
    tm = PhaseTimer()
    with tm.phase("encode", block_on=tensor): ...
    print(tm.report())
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(name: str, logdir: Optional[str] = None):
    """torch.profiler trace of a block, the host and (where there is one)
    the card, written as a chrome trace ``{logdir}/{name}.json``; without
    a logdir, a named range in whatever profiler is running."""
    if not logdir:
        with torch.profiler.record_function(name):
            yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.json"))


def block_until_ready(value) -> None:
    """Wait for the card to finish the work behind ``value`` (the stream's
    work; a CPU value is ready)."""
    tensors = value if isinstance(value, (list, tuple)) else [value]
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


class PhaseTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        rows = [
            f"{name}: total {self.totals[name]:.3f}s over {self.counts[name]} "
            f"({self.totals[name] / self.counts[name] * 1000:.1f} ms avg)"
            for name in sorted(self.totals)
        ]
        return "\n".join(rows)


# the chrome trace's categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(trace: dict) -> list:
    """[(start us, end us)] of every device activity (kernel, copy, set) of
    a chrome trace as torch.profiler exports it, sorted by start."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in trace["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)


def union_ms(intervals) -> float:
    """ms that at least one of the sorted (start us, end us) intervals
    covers: activities that overlap in time count once."""
    total, end = 0.0, -math.inf
    for start, stop in intervals:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def traced_intervals(prof, path: str) -> list:
    """The device intervals of a finished torch.profiler run, through its
    chrome trace written to ``path``."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        return device_intervals(json.load(f))


def device_profile(run, logdir: Optional[str] = None,
                   on_card: Optional[bool] = None) -> dict:
    """``run()`` once under torch.profiler tracing the card only (each
    kernel once, little host overhead): the wall ms, the device's busy ms
    (the union of its kernels', copies' and sets' intervals: activities
    that overlap count once) and its idle share of the wall. With
    ``logdir`` the chrome trace is written there as ``trace.json``. A run
    off the card (``on_card`` False; None: whether there is a card) has
    only its wall: busy and idle are None."""
    from torch.profiler import ProfilerActivity, profile

    if on_card is None:
        on_card = torch.cuda.is_available()
    if not on_card:
        t0 = time.perf_counter()
        run()
        return {"wall_ms": (time.perf_counter() - t0) * 1e3,
                "device_busy_ms": None, "device_idle_share": None}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        intervals = traced_intervals(prof, os.path.join(logdir, "trace.json"))
    else:
        with tempfile.TemporaryDirectory() as tmp:
            intervals = traced_intervals(prof, os.path.join(tmp, "trace.json"))
    busy = union_ms(intervals)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3))}
