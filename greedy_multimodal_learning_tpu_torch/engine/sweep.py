"""K checkpoints evaluated in one pass over the data
(``greedy_multimodal_learning_tpu/engine/sweep.py``).

Each batch is moved and preprocessed once, then run under each
checkpoint's tensors through ``torch.func.functional_call``, with curation
off and the MMTM updates sent to a throwaway ``mmtm_state``: the sweep is a
pure map over checkpoints, as in the JAX package.  The JAX package vmaps
the forward over the stacked checkpoints; here the K forwards run one after
another, since the gating kernel (a ctypes launch) has no vmap rule: on the
kernel path the forward kernel runs 3·K times a batch.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..data.transforms import preprocess
from .fold_bn import fold_batchnorm
from .metrics import blend_and_per_view_acc, blend_loss


@torch.no_grad()
def eval_sweep(model, states: Sequence[dict], generator, steps=None, fold_bn: bool = False) -> List[dict]:
    """Evaluate the K state_dicts ``states`` (tensors on the model's device)
    over one pass of ``generator``; returns K dicts of size-weighted
    ``loss``, ``acc`` and ``acc_modal_<i>`` (``sweep.py:58-117``).
    ``fold_bn`` folds each checkpoint's BatchNorm statistics into its
    convolutions first (:func:`~.fold_bn.fold_batchnorm`)."""
    if fold_bn:
        states = [fold_batchnorm(s) for s in states]
    device = next(model.parameters()).device
    if steps is None:
        steps = len(generator)
    outs, sizes = [], []
    it = iter(generator)
    for _ in range(steps):
        batch = next(it)
        x = preprocess(torch.as_tensor(batch["images"]).to(device), train=False, dtype=model.dtype)
        labels = torch.as_tensor(batch["labels"]).to(device)
        mask = torch.as_tensor(batch["mask"]).to(device)
        per_ckpt = []
        for state in states:
            _, logits, _, _ = torch.func.functional_call(
                model, state, (x,), {"train": False, "valid_mask": mask, "mmtm_state": {}})
            blend_acc, per_view = blend_and_per_view_acc(logits, labels, mask)
            per_ckpt.append(torch.cat([blend_loss(logits, labels, mask).reshape(1), blend_acc.reshape(1), per_view]))
        outs.append(torch.stack(per_ckpt))
        sizes.append(float(batch["size"]))
    if not outs:
        raise ValueError("eval_sweep: the generator gave no batch")
    values = torch.stack(outs).double().cpu()  # (steps, K, 2 + N): one copy for the pass
    w = torch.tensor(sizes, dtype=torch.float64)
    means = (values * w[:, None, None]).sum(0) / max(w.sum().item(), 1.0)
    names = ["loss", "acc"] + [f"acc_modal_{i}" for i in range(values.shape[-1] - 2)]
    return [{name: float(v) for name, v in zip(names, row)} for row in means]
