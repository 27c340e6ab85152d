"""Async checkpoint writer: snapshot on the caller, write on a background
thread (a copy of layoutllm_t2i_tpu/checkpoint/async_io.py).

The reference trainer blocks its train loop for the full serialize+write at
every save (trainer_combined_layout.py:523-535). Here the only synchronous
work is the device->host snapshot of the state, which correctness needs
anyway: the next optimizer step updates the parameters and moments in
place, so a lazy write would read tensors that have moved on. Serialization
and disk I/O then run on ONE background thread while training continues.

Semantics:
  * one write in flight — a second ``submit()`` first joins the pending one,
    so at most two snapshots are alive (bounded host memory) and checkpoint
    files on disk are always whole (io.py's tmp+rename stays atomic);
  * ``wait()`` joins the pending write and re-raises any background
    exception;
  * ``submit()`` also re-raises an exception from the PREVIOUS write, so a
    failed save surfaces at the next save at the latest, not silently.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional


class AsyncWriter:
    """Single-slot background executor for checkpoint disk writes."""

    def __init__(self) -> None:
        self._pending: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def submit(self, write_fn: Callable[[], None]) -> None:
        """Run ``write_fn`` (pure host serialization + disk I/O — it must not
        touch device tensors) on the background thread. Joins any in-flight
        write first and re-raises its error here on the caller."""
        self.wait()

        def _run() -> None:
            try:
                write_fn()
            except BaseException as e:  # surfaced by the next wait/submit
                self._err = e

        t = threading.Thread(target=_run, name="ckpt-writer", daemon=True)
        t.start()
        self._pending = t

    def wait(self) -> None:
        """Block until the in-flight write (if any) finishes; re-raise its
        exception on the caller."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err
