"""Seeded shuffling batcher (JAX ``data/loader.py``), one process.

Each epoch shuffles the indices with ``numpy.random.default_rng(seed +
epoch)``, as JAX does, drops the last partial batch, and stacks the items
into numpy arrays (``_collate``) on a background thread that keeps
``PREFETCH`` batches ready while the device computes.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np


def _collate(samples: Sequence) -> tuple:
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples]) for i in range(len(first)))
    return (np.stack([np.asarray(s) for s in samples]),)


PREFETCH = 2


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.skip = 0  # batches the next iteration starts after (a resumed run)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[tuple]:
        idx = self._indices()
        self.epoch += 1
        first, self.skip = self.skip, 0
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(first, len(self)):
                    part = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    if not put(_collate([self.dataset[int(i)] for i in part])):
                        return
                put(None)
            except BaseException as e:  # surfaced in the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()


__all__ = ["DataLoader"]
