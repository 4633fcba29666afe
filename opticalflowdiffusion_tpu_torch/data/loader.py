"""Seeded, sharded, threaded batcher (JAX ``data/loader.py``).

Each epoch shuffles the indices with ``numpy.random.default_rng(seed +
epoch)``, as JAX does, takes this shard's every ``num_shards``-th of them
from ``shard_index`` (each shard sees ``len // num_shards`` items), cuts
batches (the last partial one dropped unless ``drop_last`` is false), and
stacks the items into numpy arrays (``_collate``) on a background thread
that keeps ``prefetch`` batches ready while the device computes.  With
``num_workers`` > 0 a pool of that many threads loads items side by side,
up to ``num_workers`` of them in flight across the next batches (JAX's
pool works on one batch at a time, so at b2 it runs two threads; the
readers' decode, resize and inpaint release the GIL: zlib, numpy and the
ctypes host helper), and the batches are collated in order, so they are
those of the serial path.  ``skip`` is the number of batches the next iteration
starts after (a resumed run).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np


def _collate(samples: Sequence) -> tuple:
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples]) for i in range(len(first)))
    return (np.stack([np.asarray(s) for s in samples]),)


PREFETCH = 2


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, prefetch: int = PREFETCH, num_shards: int = 1,
                 shard_index: int = 0, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = int(prefetch)
        self.num_shards = int(num_shards)
        self.shard_index = int(shard_index)
        self.num_workers = int(num_workers)
        self.epoch = 0
        self.skip = 0  # batches the next iteration starts after (a resumed run)

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_index:: self.num_shards]

    def __iter__(self) -> Iterator[tuple]:
        idx = self._indices()
        self.epoch += 1
        first, self.skip = self.skip, 0
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 0 else None
        load = lambda i: self.dataset[int(i)]

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def part(b):
            return idx[b * self.batch_size:(b + 1) * self.batch_size]

        def producer():
            try:
                if pool is None:
                    for b in range(first, len(self)):
                        if not put(_collate([load(i) for i in part(b)])):
                            return
                else:
                    # keep the pool busy across batches: the items of the
                    # next batches are loading while one is collated
                    pending, ahead = collections.deque(), first
                    while pending or ahead < len(self):
                        while ahead < len(self) and (
                                not pending or sum(map(len, pending)) < self.num_workers):
                            pending.append([pool.submit(load, i) for i in part(ahead)])
                            ahead += 1
                        if not put(_collate([f.result() for f in pending.popleft()])):
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
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)


__all__ = ["DataLoader"]
