"""Loss and metrics (``greedy_multimodal_learning_tpu/engine/metrics.py:20-50``).

* ``blend_loss``: the sum over views of each view's mean cross-entropy,
* ``acc``: top-1 accuracy x100; on the mean of the per-view logits it is the
  blend accuracy, on one view's logits ``acc_modal_i``.

Every mean is mask-weighted over the real rows of a padded batch.
"""

from __future__ import annotations

import torch


def masked_mean(values, mask):
    mask = mask.float()
    return (values * mask).sum() / mask.sum().clamp(min=1.0)


def cross_entropy(logits, labels, mask):
    """Mean CE over the valid rows (``torch.nn.CrossEntropyLoss`` semantics)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[:, None])[:, 0]
    return masked_mean(logz - gold, mask)


def blend_loss(per_view_logits, labels, mask):
    return sum(cross_entropy(lg, labels, mask) for lg in per_view_logits)


def acc(logits, labels, mask):
    pred = logits.argmax(dim=-1)
    return masked_mean((pred == labels.long()).float(), mask) * 100.0


def blend_and_per_view_acc(per_view_logits, labels, mask):
    """(blend accuracy, (N,) per-view accuracies)."""
    blend = sum(lg.float() for lg in per_view_logits) / len(per_view_logits)
    return acc(blend, labels, mask), torch.stack([acc(lg, labels, mask) for lg in per_view_logits])
