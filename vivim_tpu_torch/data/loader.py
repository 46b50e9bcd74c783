"""Threaded prefetching batch loader (host numpy).

Copy of the JAX package's ``data/loader.py``, eval subset (dataset order,
no multi-host sharding): a thread pool decodes clips while the device
computes; batches are stacked channels-last numpy arrays (``paths`` stay
lists).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class DataLoader:
    """Iterates batched clips in dataset order with background prefetch.

    dataset: ClipDataset-like (len, load_clip(idx)); num_workers: decode
    threads (0 = synchronous); drop_last: drop the trailing partial batch;
    prefetch: batches queued ahead.
    """

    def __init__(self, dataset, batch_size, num_workers=4, drop_last=True,
                 prefetch=4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def _batches(self):
        n, bs = len(self.dataset), self.batch_size
        return [list(range(i * bs, min((i + 1) * bs, n)))
                for i in range(len(self))]

    @staticmethod
    def _collate(items):
        return {key: ([it[key] for it in items] if key == "paths"
                      else np.stack([it[key] for it in items]))
                for key in items[0]}

    def __iter__(self):
        batches = self._batches()
        if self.num_workers <= 0:
            for bidx in batches:
                yield self._collate(
                    [self.dataset.load_clip(i) for i in bidx])
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
                        pending.append([pool.submit(self.dataset.load_clip, i)
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
