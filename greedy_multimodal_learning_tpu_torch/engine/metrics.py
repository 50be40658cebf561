"""Loss and metrics (``greedy_multimodal_learning_tpu/engine/metrics.py:20-50``).

* ``blend_loss``: the sum over views of each view's mean cross-entropy,
* ``acc``: top-1 accuracy x100; on the mean of the per-view logits it is the
  blend accuracy, on one view's logits ``acc_modal_i``.

Every mean is mask-weighted over the real rows of a padded batch.  Under
data parallelism each rank's mean is its masked sum over the data group's
valid count (:func:`valid_count`), so the data group's means sum to the
joined batch's.
"""

from __future__ import annotations

import torch

from ..parallel import mesh as parallel


def valid_count(mask):
    """The valid rows of the batch, of the whole data group's under data
    parallelism, at least 1.  The clamp comes after the sum: a rank whose
    rows are all padding still divides by the world's count."""
    count = mask.float().sum()
    world = parallel.active()
    if world is not None:
        count = parallel.all_reduce_(count.clone(), world.data_group)
    return count.clamp(min=1.0)


def masked_mean(values, mask, count=None):
    """The mean of ``values`` over the rows ``mask`` marks; ``count``, when
    given, is the divisor (:func:`valid_count`)."""
    mask = mask.float()
    return (values * mask).sum() / (mask.sum().clamp(min=1.0) if count is None else count)


def cross_entropy(logits, labels, mask, count=None):
    """Mean CE over the valid rows (``torch.nn.CrossEntropyLoss`` semantics)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return masked_mean(logz - gold, mask, count)


def blend_loss(per_view_logits, labels, mask, count=None):
    return sum(cross_entropy(lg, labels, mask, count) for lg in per_view_logits)


def acc(logits, labels, mask, count=None):
    pred = logits.argmax(dim=-1)
    return masked_mean((pred == labels.long()).float(), mask, count) * 100.0


def blend_and_per_view_acc(per_view_logits, labels, mask, count=None):
    """(blend accuracy, (N,) per-view accuracies)."""
    blend = sum(lg.float() for lg in per_view_logits) / len(per_view_logits)
    return acc(blend, labels, mask, count), torch.stack([acc(lg, labels, mask, count) for lg in per_view_logits])
