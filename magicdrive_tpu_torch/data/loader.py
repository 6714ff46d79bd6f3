"""Host-side batching data loader with background prefetch (counterpart of
``data/loader.py``; ref:magicdrive/runner/base_runner.py:116-146).

A thread pool maps the (numpy) sample pipeline and batches with
:func:`collate_fn`, and a bounded queue holds the ready batches so that the
card does not wait on the host. Each pass is an epoch: with ``shuffle`` its
order is a permutation drawn from (seed, epoch), and each batch's collate
draws (training augmentation only) come from (seed, epoch, its first
index), as in the JAX package, so a run's batches repeat from its seed.

With ``shard=(i, parts)`` the loader is one rank's of a data-parallel job:
it walks the global batches of ``batch_size * parts`` samples in the order
every rank draws alike, and loads only rows [i b, (i+1) b) of each. A
rank's collate draws come from its own first index, so where the collate
draws (``bbox_drop_ratio``/``bbox_add_ratio`` > 0) they follow another
stream than one process's at the global batch.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from .collate import CollateConfig, collate_fn


class DataLoader:
    """Iterable over collated numpy batches of ``batch_size``, in the
    dataset's order or, with ``shuffle``, in a new order each epoch; with
    ``drop_last`` an incomplete tail batch is dropped, so every batch has
    the same shapes. ``shard``: see the module docstring."""

    def __init__(self, dataset, batch_size: int, cfg: CollateConfig,
                 shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = False, shard: Tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = shard
        self.cfg = cfg
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        size = self.batch_size * self.shard[1]
        n = len(self.dataset) // size
        if not self.drop_last and len(self.dataset) % size:
            n += 1
        return n

    def _batches(self, order: np.ndarray):
        index, parts = self.shard
        size = self.batch_size * parts
        for i in range(0, len(order), size):
            idx = order[i:i + size]
            if self.drop_last and len(idx) < size:
                return
            if parts > 1:
                idx = idx[index * self.batch_size:
                          (index + 1) * self.batch_size]
                if not len(idx):  # a short tail without rows for this rank
                    return
            yield idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        self.epoch += 1
        epoch = self.epoch
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def make_batch(idx):
            return collate_fn([self.dataset[int(j)] for j in idx], self.cfg,
                              rng=np.random.default_rng(
                                  (self.seed, epoch, int(idx[0]))))

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = [pool.submit(make_batch, idx)
                           for idx in self._batches(order)]
                for fut in futures:
                    if stop.is_set():
                        fut.cancel()
                        continue
                    try:
                        q.put(fut.result())
                    except Exception as e:  # surface worker errors
                        q.put(e)
                        return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def shard_for_process(indices: Sequence[int], process_index: int,
                      process_count: int) -> list:
    """Strided sharding of sample indices across processes, the analogue
    of accelerate's distributed sampler
    (ref:perception/data_prepare/val_set_gen.py:79)."""
    return list(indices)[process_index::process_count]
