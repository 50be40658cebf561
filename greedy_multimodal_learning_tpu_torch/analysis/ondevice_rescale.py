"""The rescale means reduced on the device during the recording pass
(``greedy_multimodal_learning_tpu/analysis/ondevice_rescale.py:35-150``).

The default recording stores every sample's squeeze maps in
``history.pickle`` and :func:`~.utilization.get_rescale_weights` averages
them on the host.  When those means are all a run needs,
:class:`RescaleMeanAccumulator` sums each step's maps on the device, each
row weighted by how often its sample index occurs in the selected set, and
only the (C,) means cross to the host, written by ``evalution_loop`` as
``eval_history_batch/rescale_means.pkl``.  Under data parallelism each rank
sums its rows and the sums are added over the data group before the
division (the ranks of a model group hold the same rows).
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np
import torch

from ..parallel import mesh as parallel

logger = logging.getLogger(__name__)

RESCALE_MEANS_FILENAME = "rescale_means.pkl"


class RescaleMeanAccumulator:
    """Weighted row sums of recorded squeeze maps on the device.

    ``selected_indices`` are the dataset indices to average over, as
    ``get_rescale_weights`` selects them (the training run's
    ``train_indices`` or ``val_indices``).  An index selected twice counts
    twice, as ``maps[selected].mean(0)`` counts it (``ondevice_rescale.py:55-60``).
    With a ``world``, :meth:`means` sums the data group's sums first."""

    def __init__(self, selected_indices, device, world=None):
        self.world = world
        self.selected = np.asarray(selected_indices)
        self._weight_of = Counter(int(i) for i in self.selected)
        self.device = torch.device(device)
        self.sums = None  # [module][view] (C,) float32 on the device
        self.count = None  # () float32 on the device: the weight consumed

    def member_mask(self, indices_trimmed, size, batch_rows) -> np.ndarray:
        """(batch_rows,) float32 row weights: each real row's multiplicity
        in the selected set, 0 for other rows and for padding."""
        row = np.zeros((batch_rows,), np.float32)
        for j, idx in enumerate(np.asarray(indices_trimmed)[:size]):
            row[j] = self._weight_of.get(int(idx), 0.0)
        return row

    def consume(self, squeezes, member):
        """Add one step's maps: ``squeezes`` [module][view] (B, C) float32
        tensors on the device, ``member`` the (B,) host row weights."""
        w = torch.from_numpy(np.asarray(member, np.float32)).to(self.device, non_blocking=True)
        if self.sums is None:
            self.sums = [[torch.zeros(t.shape[1], dtype=torch.float32, device=self.device) for t in m]
                         for m in squeezes]
            self.count = torch.zeros((), dtype=torch.float32, device=self.device)
        for sums, maps in zip(self.sums, squeezes):
            for s, t in zip(sums, maps):
                s.add_((t * w[:, None]).sum(dim=0))
        self.count.add_(w.sum())

    def means(self):
        """The per-(module, view) means, fetched in one copy, as
        ({module: {view: (C,) float32}}, member count)."""
        if self.sums is None:
            raise RuntimeError("no squeeze maps were consumed: did the pass record them (saving_mmtm_squeeze_array)?")
        flat = torch.cat([s for sums in self.sums for s in sums] + [self.count[None]])
        if self.world is not None:
            flat = parallel.all_reduce_(flat, self.world.data_group)
        flat = flat.cpu().numpy()
        count = float(flat[-1])
        if count != len(self.selected):
            logger.warning(
                "on-device rescale reduction consumed %d member samples but %d were selected: the recording "
                "pass did not cover the selected index set", int(count), len(self.selected),
            )
        out, offset = {}, 0
        for mi, sums in enumerate(self.sums):
            for vi, s in enumerate(sums):
                n = s.numel()
                out.setdefault(mi, {})[vi] = flat[offset:offset + n].astype(np.float32) / max(count, 1.0)
                offset += n
        return out, int(count)
