"""Trainer: the engine around the model (``greedy_multimodal_learning_tpu/engine/framework.py``).

This slice carries the serving part only: ``load_weights``, ``predict`` and
``_predict_step`` (``framework.py:209-214, 622-677``).  The epoch loop,
callbacks and the train step come with the training slice.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np
import torch

from . import checkpoint as ckpt
from ..data.transforms import preprocess

logger = logging.getLogger(__name__)


def _cycle(iterable):
    while True:
        for x in iterable:
            yield x


class Trainer:
    def __init__(self, model, *, nummodalities: int = 2, device="cuda"):
        self.model = model
        self.nummodalities = nummodalities
        self.device = torch.device(device)

    def load_weights(self, filepath):
        ckpt.load_weights(self.model, filepath)

    @torch.no_grad()
    def predict(self, generator, steps=None):
        """Inference: iterate a batch pipeline and return per-sample
        predictions.

        Returns dict with ``indices`` (dataset order of the inputs),
        ``predictions`` (argmax of blended logits), ``probabilities``
        (softmax of blended logits) and per-view ``logits``, all numpy."""
        self.model.eval()
        if steps is None:
            steps = len(generator)
        all_idx, all_logits = [], []
        for batch in itertools.islice(_cycle(generator), steps):
            size = batch.pop("size")
            indices = batch.pop("indices")
            # The new MMTM state is discarded, as in the JAX package: predict
            # leaves the model's buffers as they were.
            _, logits = self._predict_step(batch)
            all_idx.append(np.asarray(indices)[:size])
            all_logits.append([l[:size] for l in logits])
        logits = [torch.cat([b[v] for b in all_logits]).cpu().numpy() for v in range(self.nummodalities)]
        blend = sum(logits) / float(self.nummodalities)
        ex = np.exp(blend - blend.max(axis=1, keepdims=True))
        return {
            "indices": np.concatenate(all_idx),
            "predictions": blend.argmax(axis=1),
            "probabilities": ex / ex.sum(axis=1, keepdims=True),
            "logits": logits,
        }

    @torch.no_grad()
    def _predict_step(self, batch):
        """One batch through the eval forward.  Returns (new MMTM state as
        ``{"mmtm2": {buffer: tensor}, ...}``, [per-view logits])."""
        images = torch.from_numpy(batch["images"]).to(self.device)
        mask = torch.from_numpy(batch["mask"]).to(self.device)
        x = preprocess(images, train=False, dtype=self.model.dtype)
        mmtm_state = {}
        _, logits, _, _ = self.model(x, valid_mask=mask, mmtm_state=mmtm_state)
        return mmtm_state, logits
