"""Host-side prefetching batch loader (layoutllm_t2i_tpu/data/loader.py).

The reference feeds trainers through torch DataLoader worker processes and
DistributedSampler (trainer.py:274-279, trainer_combined_layout.py:288).
Here a thread pool decodes and transforms the next batches while the card
runs the current step; each process of a group takes a disjoint slice of
every epoch, like DistributedSampler. Threads suffice: an item's work is
zlib or Pillow decoding and numpy, which release the interpreter lock in
their hot parts.

The epochs, their order and their batches are the JAX loader's. Unlike it,
batches are submitted as the consumer takes them, not a whole epoch at
once: at most ``prefetch + num_workers`` batches are decoded or being
decoded and not yet taken.
"""
from __future__ import annotations

import collections
import itertools
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Sequence


def collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack array fields, keep strings/lists as lists (reference
    dataloader collation for the layout batch schema)."""
    import numpy as np

    out: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        first = vals[0]
        if hasattr(first, "shape"):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class PrefetchLoader:
    """Infinite epoch-shuffled batch iterator with background prefetch.

    dataset: indexable with __len__; batch_size is the PER-PROCESS batch;
    process_index/process_count shard each epoch like DistributedSampler
    (disjoint, padded by dropping the remainder). A fetch that raises
    raises in the consumer. Closing the iterator (or dropping it) stops
    its producer thread."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        if batch_size <= 0 or prefetch < 1:
            raise ValueError(f"batch_size {batch_size} and prefetch "
                             f"{prefetch} must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count

    def _epoch_batches(self, epoch: int) -> List[Sequence[int]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + epoch).shuffle(order)
        local = order[self.process_index::self.process_count]
        n_full = len(local) // self.batch_size
        return [local[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(n_full)]

    def _batch_indices(self) -> Iterator[Sequence[int]]:
        """Every epoch's batches of indices, in order, without end."""
        if not self._epoch_batches(0):
            raise ValueError(
                f"{len(self.dataset)} items give this process no batch of "
                f"{self.batch_size}")
        for epoch in itertools.count():
            yield from self._epoch_batches(epoch)

    def _fetch(self, idxs):
        return collate([self.dataset[i] for i in idxs])

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            pending: collections.deque = collections.deque()
            batches = self._batch_indices()
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    while not stop.is_set():
                        # the window: num_workers batches submitted, one of
                        # them possibly waiting for room in the queue
                        while len(pending) < self.num_workers:
                            pending.append(pool.submit(self._fetch, next(batches)))
                        if not put(pending.popleft().result()):
                            return
                except Exception as exc:  # a failed fetch: the consumer raises it
                    put(exc)
                finally:
                    for fut in pending:
                        fut.cancel()

        thread = threading.Thread(target=producer, name="PrefetchLoader",
                                  daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()
