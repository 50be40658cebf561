"""Batch pipelines: static-shape uint8 batches with validity masks
(``greedy_multimodal_learning_tpu/data/pipeline.py``).

* every batch has the same shape: the final partial batch is padded with
  zeros and comes with a (B,) validity mask, and ``indices`` is -1 on pad
  rows,
* batches are raw uint8; normalization runs on the device,
* :class:`BatchPipeline` streams: a background thread collates host batches
  (``csrc/fastio.cc``) ahead of the consumer,
* :class:`DeviceCachePipeline` uploads the split once and gathers every
  batch on its device.

Iteration yields dicts: {images: (B,V,H,W,C) u8 images or (B,M,T,H,W,C)
u8 clips, labels: (B,) i32,
indices: (B,) i32, mask: (B,) f32, size: int}; numpy arrays when streamed,
tensors on the pipeline's device (``indices`` and ``size`` on the host)
when cached.

Under data parallelism :func:`adopt_world` gives each pipeline its rank's
rows of every batch (``rows``, a slice of the B rows): ``images``,
``labels`` and ``mask`` then hold those rows only, streamed or gathered,
while ``indices`` and ``size`` stay the whole node batch's and ``rows``
names the slice (the counterpart of ``adopt_mesh_for_cache``,
``pipeline.py:404-436``).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Sequence

import numpy as np
import torch

from ..utils.native import collate_u8

logger = logging.getLogger(__name__)


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
        self.rows = None  # this rank's rows of every batch (adopt_world); None: all

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
        idxs = np.full((b,), -1, np.int32)  # -1 on pad rows
        idxs[:size] = batch_indices
        rows = self.rows or slice(0, b)
        width = rows.stop - rows.start
        # only this rank's rows are read and collated
        items = [self.dataset[int(i)] for i in batch_indices[rows]]
        if items:
            imgs = collate_u8([it[1] for it in items], width)  # rows past the real ones zero
        else:  # a block of padding only
            imgs = np.zeros((width,) + self.dataset[int(self.indices[0])][1].shape, np.uint8)
        labels = np.zeros((width,), np.int32)  # pad rows: label 0, mask 0
        labels[:len(items)] = [it[2] for it in items]
        mask = np.zeros((width,), np.float32)
        mask[:len(items)] = 1.0
        batch = {"images": imgs, "labels": labels, "indices": idxs, "mask": mask, "size": size}
        if self.rows is not None:
            batch["rows"] = self.rows
        return batch

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


class DeviceCachePipeline(BatchPipeline):
    """The split's uint8 image stack on ``device``, uploaded once at first
    iteration; every batch is then gathered there (``index_select``), so
    image bytes cross to the device once a run instead of once a batch
    (``pipeline.py:186-401``).

    Batches are byte for byte the streamed ones:

    * the per-epoch order is the inherited ``_epoch_order()``, a pure
      function of (seed, epoch), so ``set_epoch`` resumes it,
    * the corpus has one reserved all-zero row after the samples (label 0);
      partial batches are padded with it, with index -1 and mask 0, as
      ``_collate`` pads,
    * ``images``, ``labels`` and ``mask`` are tensors on ``device``;
      ``indices`` and ``size`` stay on the host for the history.

    The corpus may take ``budget_frac`` of the device's free memory
    (``torch.cuda.mem_get_info``); on the CPU, ``fallback_budget_bytes``.
    A corpus over budget is refused with a warning, and the pipeline then
    streams for the rest of the run.  Any other failure of the upload or
    the gather raises.  After the upload, the dataset's host sample-cache
    entries that the corpus assembly added are released.
    """

    #: fraction of the device's free memory the corpus may occupy
    budget_frac = 0.5
    #: budget on a device without memory statistics (the CPU)
    fallback_budget_bytes = 2 * 1024**3

    def __init__(self, dataset, indices, batch_size, *, device, **kw):
        super().__init__(dataset, indices, batch_size, **kw)
        self.device = torch.device(device)
        self._corpus = None  # (images, labels) on the device after the upload
        self._row_of = None  # dataset index -> corpus row
        self._pad_row = None
        self._streaming = False  # latched by a budget refusal

    @property
    def resident(self) -> bool:
        """Whether the corpus is on the device."""
        return self._corpus is not None

    def corpus_nbytes(self) -> int:
        """Bytes of the corpus image stack, the pad row included."""
        if len(self.indices) == 0:
            return 0
        _, img, _ = self.dataset[int(self.indices[0])]
        return (len(self.indices) + 1) * img.nbytes

    def _budget_ok(self) -> bool:
        nbytes = self.corpus_nbytes()
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if nbytes <= self.budget_frac * free:
                return True
            logger.warning(
                "device cache: corpus %.1f MB exceeds %.0f%% of free device memory (%.1f MB) on %s "
                "— falling back to streaming batches", nbytes / 1e6, 100 * self.budget_frac, free / 1e6, self.device,
            )
            return False
        if nbytes <= self.fallback_budget_bytes:
            return True
        logger.warning(
            "device cache: corpus %.1f MB exceeds the %.0f MB fallback budget (%s reports no memory "
            "statistics) — falling back to streaming batches",
            nbytes / 1e6, self.fallback_budget_bytes / 1e6, self.device,
        )
        return False

    def _ensure_corpus(self) -> bool:
        """Upload once; False (and streaming from then on) when the corpus
        is over budget."""
        if self._corpus is not None:
            return True
        if self._streaming or len(self.indices) == 0:
            return False
        # The assembly fills the dataset's host cache, which the cached path
        # never reads again: note what is there before (the budget probe
        # reads one sample) so that only the added entries are released.
        host_cache = getattr(self.dataset, "_cache", None)
        pre_cached = set(host_cache) if host_cache is not None else None
        if not self._budget_ok():
            self._streaming = True
            return False
        items = [self.dataset[int(i)] for i in self.indices]
        n = len(items)
        imgs = collate_u8([it[1] for it in items], n + 1)  # the samples, then the all-zero pad row
        labels = np.array([it[2] for it in items] + [0], np.int32)
        self._pad_row = n
        lut = np.zeros(int(self.indices.max()) + 1, np.int64)
        lut[self.indices] = np.arange(n)
        self._row_of = lut
        self._corpus = (torch.from_numpy(imgs).to(self.device), torch.from_numpy(labels).to(self.device))
        logger.info("device cache: %d samples (%.1f MB uint8) resident on %s", n, imgs.nbytes / 1e6, self.device)
        if pre_cached is not None:
            for k in [k for k in host_cache if k not in pre_cached]:
                del host_cache[k]
        return True

    def __iter__(self):
        if not self._ensure_corpus():
            yield from super().__iter__()
            return
        self.epoch += 1
        order = self._epoch_order()
        n, b = len(order), self.batch_size
        n_batches = -(-n // b)
        rows = np.full(n_batches * b, self._pad_row, np.int64)
        rows[:n] = self._row_of[order]
        # one host-to-device copy of the epoch's rows; every batch is a slice
        rows_dev = torch.from_numpy(rows).to(self.device)
        images, labels = self._corpus
        mine = self.rows or slice(0, b)  # only this rank's rows are gathered
        for k in range(n_batches):
            chunk = order[k * b:(k + 1) * b]
            size = len(chunk)
            idxs = np.full(b, -1, np.int32)
            idxs[:size] = chunk
            r = rows_dev[k * b + mine.start:k * b + mine.stop]
            batch = {
                "images": images.index_select(0, r),
                "labels": labels.index_select(0, r),
                "indices": idxs,
                "mask": (r != self._pad_row).to(torch.float32),
                "size": size,
            }
            if self.rows is not None:
                batch["rows"] = self.rows
            yield batch


def adopt_world(pipelines, world) -> None:
    """Give each pipeline this rank's rows of every batch of ``world``
    (:meth:`~..parallel.World.rows`: its data index's, the same on every
    rank of a model group); a batch size the node's data indices do not
    divide raises ValueError.  Each rank uploads its node's corpus to its
    own device and gathers its rows there, as the JAX package replicates the
    corpus over the mesh and gathers batches already sharded
    (``pipeline.py:318-343,404-436``)."""
    for pipe in pipelines:
        if pipe is not None:
            pipe.rows = world.rows(pipe.batch_size)


def wrap_device_cache(pipeline: BatchPipeline, enabled, device) -> BatchPipeline:
    """``pipeline`` as a :class:`DeviceCachePipeline` on ``device``, unless
    ``enabled`` is False (``True`` and ``"auto"`` both cache; the budget
    check decides at first iteration)."""
    if enabled is False:
        return pipeline
    if enabled not in (True, "auto"):
        raise ValueError(f"device_cache must be True, False or 'auto', got {enabled!r}")
    cached = DeviceCachePipeline(
        pipeline.dataset,
        pipeline.indices,
        pipeline.batch_size,
        device=device,
        shuffle=pipeline.shuffle,
        seed=pipeline.seed,
        prefetch=pipeline.prefetch,
    )
    cached.epoch = pipeline.epoch
    return cached
