"""The train step and the eval step (``greedy_multimodal_learning_tpu/engine/steps.py:87-145,177-222``).

One train step, in the JAX package's order:

  flips (given) -> preprocess -> forward with ``train=True`` and the
  curation flags left by the previous step -> blend loss -> backward ->
  BDR sums of the gradients and of the weights *before* the update ->
  SGD -> the controller's t -> t+1 update.

PyTorch updates the parameters in place, so the weight sums are read before
``optimizer.step()``; the JAX package reads ``state.params`` at the same
point (``steps.py:114-117``).  BatchNorm running statistics and the MMTM
running averages update in place during the forward.  Every output stays
on the device.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..data.transforms import preprocess
from .bdr import GroupReducer
from .controller import ControllerState
from .metrics import blend_and_per_view_acc, blend_loss


def _step_outputs(logits, labels, mask, loss):
    blend_acc, per_view_acc = blend_and_per_view_acc(logits, labels, mask)
    return {"loss": loss.detach(), "acc": blend_acc, "acc_modal": per_view_acc}


def train_step(
    model,
    optimizer: torch.optim.Optimizer,
    reducer: GroupReducer,
    controller_update: Callable,
    ctrl: ControllerState,
    batch: Dict[str, torch.Tensor],
    flips: torch.Tensor,
    unlock: torch.Tensor,
):
    """One guided training step on ``batch`` (device tensors: uint8
    ``images`` (B, V, H, W, C), ``labels``, ``mask``) with the (B, V) bool
    ``flips``.  Returns (new controller state, outputs)."""
    x = preprocess(batch["images"], train=True, flip=flips, dtype=model.dtype)
    mask, labels = batch["mask"], batch["labels"]
    _, logits, _, _ = model(x, ctrl.curation_mode, ctrl.caring_modality, train=True, valid_mask=mask)
    loss = blend_loss(logits, labels, mask)

    params = [p for group in optimizer.param_groups for p in group["params"]]
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        gn = reducer([p.grad for p in params])
        wn = reducer(params)
    optimizer.step()
    new_ctrl = controller_update(ctrl, gn, wn, unlock)

    with torch.no_grad():
        out = _step_outputs(logits, labels, mask, loss)
    out.update(d_BDR=new_ctrl.d_BDR, curation_mode=new_ctrl.curation_mode,
               caring_modality=new_ctrl.caring_modality, curated=ctrl.curation_mode)
    return new_ctrl, out


@torch.no_grad()
def eval_step(model, ctrl: ControllerState, batch: Dict[str, torch.Tensor]):
    """One eval batch: BatchNorm on its running statistics, the live
    curation flags, and the new MMTM running averages kept in the buffers,
    as the JAX package's trainer keeps them (``framework.py:481-482``)."""
    x = preprocess(batch["images"], train=False, dtype=model.dtype)
    mask, labels = batch["mask"], batch["labels"]
    _, logits, _, _ = model(x, ctrl.curation_mode, ctrl.caring_modality, train=False, valid_mask=mask)
    return _step_outputs(logits, labels, mask, blend_loss(logits, labels, mask))
