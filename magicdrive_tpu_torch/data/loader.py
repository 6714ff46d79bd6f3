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
every rank draws alike, and loads only rows [i b, (i+1) b) of each. Where
the collate draws (``bbox_drop_ratio``/``bbox_add_ratio`` > 0), each rank
draws the boxes of the whole global batch from the global batch's
generator (``preprocess_bbox``, which reads each sample's boxes, labels
and view matrices, ``box_sample``) and keeps its rows, so its boxes and
masks are one process's at the global batch (JAX's runner collates the
global batch, ``train/runner.py:229-232``).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from .collate import CollateConfig, collate_fn, preprocess_bbox


def box_sample(dataset, i: int, cfg: CollateConfig) -> dict:
    """What ``preprocess_bbox`` reads of sample ``i`` (boxes, labels, view
    matrices): the dataset's ``box_sample`` (without images or map) where
    it has one and the 3D filter is on (the canvas filter reads the image
    augmentation's matrix), else the sample itself."""
    fn = getattr(dataset, "box_sample", None)
    return fn(i) if fn is not None and cfg.use_3d_filter else dataset[i]


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

    def _rows(self, n: int) -> slice:
        """This rank's rows of a global batch of n samples."""
        index, parts = self.shard
        if parts == 1:
            return slice(None)
        b = self.batch_size
        return slice(min(index * b, n), min((index + 1) * b, n))

    def _batches(self, order: np.ndarray):
        """The global batches' sample indices, up to a short tail without
        rows for this rank."""
        size = self.batch_size * self.shard[1]
        for i in range(0, len(order), size):
            idx = order[i:i + size]
            if self.drop_last and len(idx) < size:
                return
            if not len(idx[self._rows(len(idx))]):
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
            rng = np.random.default_rng((self.seed, epoch, int(idx[0])))
            rows = self._rows(len(idx))
            own = [self.dataset[int(j)] for j in idx[rows]]
            c = self.cfg
            if rows == slice(None) or not c.is_train or not (
                    c.bbox_drop_ratio > 0 or c.bbox_add_ratio > 0):
                return collate_fn(own, c, rng=rng)
            every = [own[k - rows.start] if rows.start <= k < rows.stop
                     else box_sample(self.dataset, int(j), c)
                     for k, j in enumerate(idx)]
            boxes = preprocess_bbox(every, c, rng)
            return collate_fn(own, c, boxes={k: v[rows]
                                             for k, v in boxes.items()})

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
