"""Logging: file+stdout tee (reference utils.py:49-76) and a JSONL metrics
writer (a copy of layoutllm_t2i_tpu/utils/logging.py's ``Logger`` and
``MetricsWriter``, with ``close``). The JSONL file is the record of a run;
TensorBoard is not wired in."""
from __future__ import annotations

import json
import os
import time


def _open_append(path: str):
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    return open(path, "a")


class Logger:
    def __init__(self, output_name: str):
        self.log_file = _open_append(output_name)

    def write(self, msg):
        self.log_file.write(str(msg) + "\n")
        self.log_file.flush()
        print(msg)

    def close(self) -> None:
        self.log_file.close()


class MetricsWriter:
    """Appends {'step': n, 'wall': t, **scalars} JSON lines."""

    def __init__(self, path: str):
        self._f = _open_append(path)
        self._t0 = time.time()

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
