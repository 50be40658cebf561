"""Host-side batch pipeline: static-shape uint8 batches with validity masks
(``greedy_multimodal_learning_tpu/data/pipeline.py:68-184``).

* every batch has the same shape: the final partial batch is padded with
  zeros and comes with a (B,) validity mask, and ``indices`` is -1 on pad
  rows,
* batches are raw uint8; normalization runs on the device,
* a background thread collates ahead of the consumer.

Iteration yields dicts: {images: (B,V,H,W,C) u8, labels: (B,) i32,
indices: (B,) i32, mask: (B,) f32, size: int}.  The device-resident corpus
(``DeviceCachePipeline``) comes later.
"""

from __future__ import annotations

import queue
import threading
from typing import Sequence

import numpy as np


class BatchPipeline:
    def __init__(
        self,
        dataset,
        indices: Sequence[int],
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 777,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.indices = np.asarray(list(indices), np.int64)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.seed = seed
        # The order is a pure function of (seed, epoch); bare iteration
        # advances the epoch.
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        """Number of batches per epoch (the last one padded)."""
        n = len(self.indices)
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self):
        return len(self.indices)

    def _epoch_order(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            return rng.permutation(self.indices)
        return self.indices

    def _collate(self, batch_indices: np.ndarray) -> dict:
        b = self.batch_size
        size = len(batch_indices)
        items = [self.dataset[int(i)] for i in batch_indices]
        imgs = np.stack([it[1] for it in items])  # (size, V, ..., C)
        labels = np.array([it[2] for it in items], np.int32)
        idxs = np.array([it[0] for it in items], np.int32)
        if size < b:  # pad to the static shape; mask marks real rows
            pad = b - size
            imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
            labels = np.concatenate([labels, np.zeros((pad,), np.int32)])
            idxs = np.concatenate([idxs, np.full((pad,), -1, np.int32)])
        mask = np.zeros((b,), np.float32)
        mask[:size] = 1.0
        return {"images": imgs, "labels": labels, "indices": idxs, "mask": mask, "size": size}

    def __iter__(self):
        self.epoch += 1
        order = self._epoch_order()
        n = len(order)
        if n == 0:
            return
        starts = range(0, n, self.batch_size)

        if self.prefetch <= 0:
            for s in starts:
                yield self._collate(order[s : s + self.batch_size])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # consumer gone: unblock and end the producer
        failure = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for s in starts:
                    if not _put(self._collate(order[s : s + self.batch_size])):
                        return
            except BaseException as e:  # surfaced to the consumer below
                failure.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # An early consumer exit must not leave the producer blocked on a
            # full queue.
            stop.set()
        if failure:
            raise RuntimeError("BatchPipeline producer thread failed") from failure[0]
