"""Threaded prefetching batch loader (host numpy).

Copy of the JAX package's ``data/loader.py``: a thread pool decodes and
augments clips while the card computes (PIL decode and the native ops
release the GIL, so threads scale); batches are stacked channels-last
numpy arrays (``paths`` stay lists).  Each epoch's order is shuffled by
``random.Random(seed + epoch)`` and each clip's augmentation draws from
``random.Random(seed * 7919 + epoch * 131 + i)`` of its global index ``i``,
so a run's batches are reproducible and equal to the JAX loader's.
"""

from __future__ import annotations

import queue
import random as _random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def block_rows(n: int, index: int, count: int, micro_batches: int = 1):
    """Rows of a batch of ``n`` that process ``index`` of ``count`` holds:
    its contiguous block of each of ``micro_batches`` contiguous
    micro-batches, so that its i-th local micro-batch is its block of the
    global i-th (with one micro-batch, its block of the batch)."""
    if n % (count * micro_batches):
        raise ValueError(f"a batch of {n} does not split into "
                         f"{micro_batches} micro-batches over {count} "
                         "processes")
    mb, local = n // micro_batches, n // micro_batches // count
    return [i * mb + index * local + j for i in range(micro_batches)
            for j in range(local)]


class DataLoader:
    """Iterates shuffled, batched clips with background prefetch.

    Args:
      dataset: ClipDataset-like (len, load_clip(idx, rng)).
      batch_size: clips per batch.
      shuffle: reshuffle each epoch with seed+epoch.
      num_workers: decode threads (0 = synchronous).
      drop_last: drop the trailing partial batch.
      prefetch: max batches queued ahead.
      seed: shuffle/augmentation base seed.
      process_index / process_count: input sharding over processes.  Every
        process computes the same global order and batches, then loads only
        its contiguous ``batch_size // process_count`` block of each batch;
        the augmentation rng is keyed by the global sample index, so the
        blocks concatenated in process order are the one-process batch.
        Defaults (0, 1) are one process.
      micro_batches: with process sharding, the block is taken from each of
        this many contiguous micro-batches of the batch (``block_rows``),
        so a process's i-th micro-batch is its block of the global i-th.
    """

    def __init__(self, dataset, batch_size, shuffle=True, num_workers=4,
                 drop_last=True, prefetch=4, seed=42,
                 process_index=0, process_count=1, micro_batches=1):
        if batch_size % (process_count * micro_batches):
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly over "
                f"{process_count} processes x {micro_batches} "
                "micro-batches")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range "
                             f"for process_count {process_count}")
        if process_count > 1 and not drop_last:
            raise ValueError("sharding over processes needs drop_last=True: "
                             "a partial global batch would split unevenly")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.micro_batches = micro_batches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _order(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            _random.Random(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _rng_for(self, i):
        return _random.Random(self.seed * 7919 + self.epoch * 131 + i)

    @staticmethod
    def _collate(items):
        return {key: ([it[key] for it in items] if key == "paths"
                      else np.stack([it[key] for it in items]))
                for key in items[0]}

    def _batches(self):
        order = self._order()
        batches = [order[i * self.batch_size: (i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.process_count > 1:
            rows = block_rows(self.batch_size, self.process_index,
                              self.process_count, self.micro_batches)
            batches = [[b[r] for r in rows] for b in batches]
        return batches

    def __iter__(self):
        batches = self._batches()
        if self.num_workers <= 0:
            for bidx in batches:
                yield self._collate(
                    [self.dataset.load_clip(i, self._rng_for(i))
                     for i in bidx])
            return

        out_q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def produce():
            # submissions stay prefetch + 1 batches ahead of the consumer,
            # so the pool never holds a whole epoch of decoded clips
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending: deque = deque()
                    it = iter(batches)

                    def submit_next():
                        bidx = next(it, None)
                        if bidx is None:
                            return False
                        pending.append([pool.submit(self.dataset.load_clip, i,
                                                    self._rng_for(i))
                                        for i in bidx])
                        return True

                    for _ in range(max(1, self.prefetch) + 1):
                        if not submit_next():
                            break
                    while pending:
                        if stop.is_set():
                            return
                        out_q.put(self._collate(
                            [f.result() for f in pending.popleft()]))
                        submit_next()
            except Exception as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
