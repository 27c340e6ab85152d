"""Tensor-parallel serving: one image's compute over every rank
(layoutllm_t2i_tpu/cli/serve.py TPPipeAdapter).

The JAX server is one controller over all the chips. Here every rank is a
process running the same program: rank 0 runs the HTTP server and the
micro-batcher with a ``TPPipeAdapter`` in place of the pipeline, and before
each ``generate_tp`` broadcasts the batch (prompts, layouts, relation
texts, seed and seeds) to the other ranks, which run ``follow`` and take
part in the same ``generate_tp`` until rank 0 broadcasts the stop
(``TPPipeAdapter.close``).

A batch that raises on any rank ends the group: after it the ranks may
wait on different collectives. A follower re-raises (its process exits,
and rank 0's next collective with it fails); rank 0 destroys the group (a
follower waiting in a collective fails), refuses every later batch and
sets ``failed``, on which ``cli/serve.py`` shuts the server down.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch.distributed as dist

from ..parallel.mesh import share

STOP = "stop"


def _generate(pipe, mesh, style: str, req: dict):
    return pipe.generate_tp(mesh, req["prompts"], req["layouts"],
                            relation_texts=req["relation_texts"],
                            seed=req["seed"], seeds=req["seeds"], style=style)


class TPPipeAdapter:
    """Rank 0's generate_tp under MicroBatcher's generate() contract
    (per-request seeds included), the mesh and style bound; each call's
    batch is broadcast to the followers first."""

    def __init__(self, pipe, mesh, style: str = "spatial"):
        self._pipe = pipe
        self._mesh = mesh
        self._style = style
        self.models = pipe.models
        # one broadcast-then-generate at a time, and none after the stop
        self._lock = threading.Lock()
        self._closed = False
        self.failed = threading.Event()
        self.failure: Optional[str] = None

    def generate(self, prompts, layouts, relation_texts=None, seed: int = 42,
                 seeds=None):
        req = {"prompts": list(prompts),
               "layouts": [(list(b), list(p)) for b, p in layouts],
               "relation_texts": relation_texts, "seed": int(seed),
               "seeds": None if seeds is None else [int(s) for s in seeds]}
        with self._lock:
            if self._closed:
                raise RuntimeError("the TP group is stopped"
                                   + (f" ({self.failure})" if self.failure
                                      else ""))
            try:
                share(self._mesh, req)
                return _generate(self._pipe, self._mesh, self._style, req)
            except Exception as exc:
                self._closed = True
                self.failure = f"a batch failed: {type(exc).__name__}: {exc}"
                if dist.is_initialized():
                    dist.destroy_process_group()
                self.failed.set()
                raise

    def close(self) -> None:
        """Broadcast the stop: every follower's ``follow`` returns."""
        with self._lock:
            if not self._closed:
                self._closed = True
                share(self._mesh, STOP)


def follow(pipe, mesh, style: str = "spatial") -> int:
    """A follower rank's loop: run every batch rank 0 broadcasts, until the
    stop; returns the batches run. A batch that raises ends the loop with
    its exception."""
    n = 0
    while True:
        req = share(mesh)
        if req == STOP:
            return n
        _generate(pipe, mesh, style, req)
        n += 1
