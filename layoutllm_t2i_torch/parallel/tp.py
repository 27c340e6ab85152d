"""Tensor-parallel latency mode for inference (layoutllm_t2i_tpu/parallel/
tp.py).

``generate_sharded`` (prompt-parallel) splits a batch's rows over the ranks
and needs no collective until the images are gathered. TP splits each
image's own compute, for the wait of one request. The JAX package states
its two layouts as GSPMD sharding constraints (``shard_q``, ``shard_kv``,
``shard_scores``, ``shard_inner``, ``replicate_out``, ``shard_rows``) and
lets the partitioner derive the collectives; here each is an explicit
operation on the group: take this rank's block (``block``: of the
weights' head and inner columns, so a rank computes only its slice;
``shard_rows``), all-gather a block back whole (``gather_rows``,
``gather_tokens``: K and V), or all-reduce the partial sums of a
row-parallel product (``replicate_out``).

* 'heads' (Megatron): each rank keeps its heads' columns of to_q/to_k/to_v
  and its slice of GEGLU's a and gate halves (each half sliced on its own:
  a contiguous slice of the packed weight would put a and gate on
  different ranks); the output and down projections run on the local
  slice and are all-reduced, the bias added once after. Convolutions and
  norms stay whole on every rank.
* 'spatial': image rows (and their tokens) are split over the ranks in the
  UNet and the VAE decoder. 3x3 and stride-2 convolutions exchange halo
  rows with their neighbours, self-attention all-gathers K and V against
  its local q rows, GroupNorm's statistics cover every rank's rows, the FF
  and the 1x1 and linear layers are row-local, and the output is gathered.

``_shard_dim_or_replicate``'s rule is kept: a dimension that the world
does not divide, or that leaves a rank fewer than ``min_per_shard`` (2 for
image rows, ``shard_rows``), stays whole on every rank. Under 'spatial'
the UNet and the VAE decoder are square, so a rank's block of an image's
rows is told from the whole image by its shape alone: it has H / world
rows of W = H (``row_block``). Rows are split only where the UNet or the
decoder enters them (``shard_rows``) and at an upsampling to a level that
splits; an op given a whole image keeps it whole, so the grounding
tokenizers' convolutions run as on one device.

The context is run-time state of this thread: ``tp_mode(mesh, style)``
around the sampler and the decoder (InferencePipeline.sample_latents_tp).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import collectives
from .mesh import Mesh, make_mesh

STYLES = ("heads", "spatial")
MIN_ROWS = 2  # image rows a rank at least (tests/test_tp.py:94)

_CTX = threading.local()


@dataclasses.dataclass(frozen=True)
class TPState:
    mesh: Mesh
    style: str


def current_tp() -> Optional[TPState]:
    """The (mesh, style) of the enclosing ``tp_mode``, else None."""
    return getattr(_CTX, "state", None)


@contextlib.contextmanager
def tp_mode(mesh: Mesh, style: str = "heads"):
    if style not in STYLES:
        raise ValueError(f"style {style!r}: want one of {STYLES}")
    prev = current_tp()
    _CTX.state = TPState(mesh, style)
    try:
        yield
    finally:
        _CTX.state = prev


def tp_mesh(num_devices: Optional[int] = None, **kw) -> Mesh:
    """The group of the TP mode: every rank of ``make_mesh``."""
    return make_mesh(num_devices, **kw)


def _active(style: str) -> Optional[Mesh]:
    """The mesh where ``style`` is on over more than one rank, else None."""
    state = current_tp()
    if state is None or state.style != style or state.mesh.size == 1:
        return None
    return state.mesh


def block(n: int, min_per_shard: int = 1, style: str = "heads"
          ) -> Optional[slice]:
    """This rank's block of a dimension of ``n`` under ``style``, or None
    where it stays whole: not ``style``, one rank, a world that does not
    divide ``n`` or leaves fewer than ``min_per_shard`` a rank
    (``_shard_dim_or_replicate``, layoutllm_t2i_tpu/parallel/tp.py:82)."""
    mesh = _active(style)
    if mesh is None or n % mesh.size or n // mesh.size < min_per_shard:
        return None
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicate_out(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a row-parallel product's partial output under
    'heads' (the one all-reduce of a block); ``x`` otherwise."""
    mesh = _active("heads")
    return x if mesh is None else collectives.all_reduce_sum(mesh, x)


# ---------------------------------------------------------------------------
# 'spatial': row blocks of square NCHW images and of their tokens


def row_block(x: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(rows in all, first row) where the NCHW ``x`` is this rank's block of
    an image's rows under 'spatial', else None (a whole image)."""
    mesh = _active("spatial")
    if mesh is None or x.dim() != 4 or x.shape[2] == x.shape[3]:
        return None
    h, w = x.shape[2], x.shape[3]
    if h * mesh.size != w:
        raise ValueError(f"'spatial' TP splits square images: {h} rows of "
                         f"{w} over {mesh.size} ranks")
    return w, mesh.rank * h


def splits(rows: int) -> bool:
    """Whether an image of ``rows`` rows splits under 'spatial'."""
    return block(rows, MIN_ROWS, "spatial") is not None


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the whole NCHW image ``x`` where they split
    (``shard_rows``, layoutllm_t2i_tpu/parallel/tp.py:153); ``x`` where it
    stays whole or is a block already."""
    blk = None if row_block(x) is not None else block(x.shape[2], MIN_ROWS,
                                                      "spatial")
    if blk is None:
        return x
    return x[:, :, blk].contiguous(memory_format=torch.channels_last)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole NCHW image of which ``x`` is this rank's block; ``x`` where
    it is whole."""
    if row_block(x) is None:
        return x
    whole = collectives.all_gather(_active("spatial"), x, dim=2)
    return whole.contiguous(memory_format=torch.channels_last)


def gather_tokens(t: torch.Tensor, total: int) -> torch.Tensor:
    """(b, n, ...) tokens: the whole ``total`` rows where ``t`` holds this
    rank's block of them (n < total); ``t`` where it is whole."""
    mesh = _active("spatial")
    if mesh is None or t.shape[1] == total:
        return t
    if t.shape[1] * mesh.size != total:
        raise ValueError(f"{t.shape[1]} token rows a rank of {total} over "
                         f"{mesh.size} ranks")
    return collectives.all_gather(mesh, t, dim=1)


def token_block(n: int, total: int) -> Optional[slice]:
    """This rank's rows of ``total`` tokens where it holds ``n`` of them
    (n < total), else None."""
    mesh = _active("spatial")
    if mesh is None or n == total:
        return None
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def sum_over_rows(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of per-rank partial sums over their rows."""
    mesh = _active("spatial")
    return x if mesh is None else collectives.all_reduce_sum(mesh, x)


def gather_partials(part: torch.Tensor) -> torch.Tensor:
    """(N, G, chunks, 3) GroupNorm partials of each rank's rows -> (N, G,
    world * chunks, 3): every rank's, for the apply pass to merge."""
    return collectives.all_gather(_active("spatial"), part, dim=2)


def halo_conv2d(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int,
                padding: int) -> torch.Tensor:
    """F.conv2d on this rank's block of rows, exact against the whole
    image's: ``padding`` rows from the rank above and k - stride - padding
    from the rank below (zeros at the image's edges, which are the
    padding), exchanged as one all-gather of every rank's edge rows; the
    output is a block where its rows split, else gathered whole."""
    mesh = _active("spatial")
    rows, _ = row_block(x)
    h = x.shape[2]
    k = weight.shape[2]
    top, bottom = padding, k - stride - padding
    if h % stride or top < 0 or bottom < 0 or top > h or bottom > h:
        raise ValueError(f"halo conv: k {k}, stride {stride}, padding "
                         f"{padding} on {h} rows a rank")
    if top or bottom:
        edges = torch.cat([x[:, :, h - top:], x[:, :, :bottom]], dim=2)
        every = collectives.all_gather(mesh, edges.contiguous(), dim=2)
        every = every.reshape(*every.shape[:2], mesh.size, top + bottom,
                              every.shape[3])
        n, c, _, w = x.shape
        above = (every[:, :, mesh.rank - 1, :top] if mesh.rank > 0
                 else x.new_zeros(n, c, top, w))
        below = (every[:, :, mesh.rank + 1, top:] if mesh.rank < mesh.size - 1
                 else x.new_zeros(n, c, bottom, w))
        x = torch.cat([above, x, below], dim=2)
    y = F.conv2d(x.contiguous(memory_format=torch.channels_last), weight, bias,
                 stride=stride, padding=(0, padding))
    y = y.contiguous(memory_format=torch.channels_last)
    return y if splits(rows // stride) else gather_rows(y)
