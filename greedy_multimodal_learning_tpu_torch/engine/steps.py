"""The train step, the eval step and the controller dispatch
(``greedy_multimodal_learning_tpu/engine/steps.py:43-65,87-145,152-224``).

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

When the model's ``saving_mmtm_scales`` / ``saving_mmtm_squeeze_array`` is
set, both steps also return the per-(MMTM, view) gates and squeeze maps as
float32 (B, C) tensors under ``mmtmscales_list`` /
``squeezedmaps_array_list``, nested [MMTM][view].  The JAX package packs
them into one flat buffer for its TPU's remote link (``steps.py:196-200``);
here they stay separate tensors, fetched once a pass by the trainer.

Under data parallelism (:func:`~..parallel.data_parallel`, entered by the
trainer) each rank runs the step on its rows of the global batch: the loss
divides its masked sums by the data group's valid count, the gradients are
summed over the data group right after the backward, before the BDR sums,
so the BDR norms, SGD and the controller see the global gradient and stay
identical on every rank, and the loss and accuracies are summed over the
data group into the joined batch's.  Under tensor parallelism a rank holds
its rows of the wide weights and their gradients, which are summed over the
data group, the replicated ones then broadcast from the model group's
first rank, so the copies of a model group stay equal; the BDR sums add the
rows over the model group.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from ..data.transforms import preprocess
from ..parallel import mesh as parallel
from ..parallel import tensor as tensor_parallel
from .bdr import GroupReducer
from .controller import (
    ControllerState,
    adaptive_weakest_update,
    guided_update,
    null_update,
    random_update,
    weakest_update,
)
from .metrics import blend_and_per_view_acc, blend_loss, valid_count


RECORD_KEYS = ("mmtmscales_list", "squeezedmaps_array_list")


def make_controller_update(kind: str, num_modalities: int, **kwargs) -> Callable:
    """The controller's t -> t+1 update ``(state, gn, wn, unlock) -> state``
    for ``kind`` (``steps.py:43-65``).  Any other kind keeps curation off."""
    if kind == "guided":
        return functools.partial(guided_update, epsilon=kwargs["epsilon"],
                                 curation_windowsize=kwargs["curation_windowsize"])
    if kind == "random":
        return functools.partial(random_update, num_modalities=num_modalities)
    if kind == "weakest":
        return functools.partial(weakest_update, curation_windowsize=kwargs["curation_windowsize"],
                                 duty_period=kwargs["duty_period"])
    if kind == "adaptive_weakest":
        return functools.partial(adaptive_weakest_update, curation_windowsize=kwargs["curation_windowsize"])
    return null_update


def _world_count(mask):
    """The world's valid count under data parallelism, else None (each
    mean then divides by its own batch's)."""
    return valid_count(mask) if parallel.active() is not None else None


def _bdr_sums(model, reducer, params, world):
    """The BDR sums of the gradients and of the weights.  Under tensor
    parallelism a sharded tensor's sum is its rows', so those are added over
    the model group (both in one collective) and each replicated tensor
    counts once."""
    grads = [p.grad for p in params]
    shards = tensor_parallel.sharded_weights(model) if world is not None and world.model_size > 1 else {}
    if not shards:
        return reducer(grads), reducer(params)
    sharded = [p in shards for p in params]
    (g_whole, g_rows), (w_whole, w_rows) = reducer.split(grads, sharded), reducer.split(params, sharded)
    rows = parallel.all_reduce_(torch.stack([g_rows, w_rows]), world.model_group)
    return g_whole + rows[0], w_whole + rows[1]


def _step_outputs(logits, labels, mask, loss, count):
    blend_acc, per_view_acc = blend_and_per_view_acc(logits, labels, mask, count)
    out = {"loss": loss.detach(), "acc": blend_acc, "acc_modal": per_view_acc}
    world = parallel.active()
    if world is not None:
        # the data group's shares of the joined batch's means, summed in one collective
        total = parallel.all_reduce_(torch.cat([out["loss"].reshape(1), blend_acc.reshape(1), per_view_acc]),
                                     world.data_group)
        out = {"loss": total[0], "acc": total[1], "acc_modal": total[2:]}
    return out


def _records(model, scales, squeezes) -> dict:
    """The recording outputs the model's saving flags ask for."""
    out = {}
    for key, value, enabled in (
        ("mmtmscales_list", scales, model.saving_mmtm_scales),
        ("squeezedmaps_array_list", squeezes, model.saving_mmtm_squeeze_array),
    ):
        if enabled:
            out[key] = [[t.detach().float() for t in per_mmtm] for per_mmtm in value]
    return out


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
    """One training step on ``batch`` (device tensors: uint8
    ``images`` (B, V, H, W, C) or clips (B, M, T, H, W, C), ``labels``,
    ``mask``) with the bool ``flips``, (B, V) or (B,)
    (:func:`~..data.transforms.flip_shape`).  Returns (new controller
    state, outputs)."""
    x = preprocess(batch["images"], train=True, flip=flips, dtype=model.dtype)
    mask, labels = batch["mask"], batch["labels"]
    _, logits, scales, squeezes = model(x, ctrl.curation_mode, ctrl.caring_modality, train=True, valid_mask=mask)
    count = _world_count(mask)
    loss = blend_loss(logits, labels, mask, count)

    params = [p for group in optimizer.param_groups for p in group["params"]]
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    world = parallel.active()
    if world is not None:
        tensor_parallel.all_reduce_grads_(model, params, world)
    with torch.no_grad():
        gn, wn = _bdr_sums(model, reducer, params, world)
    optimizer.step()
    new_ctrl = controller_update(ctrl, gn, wn, unlock)

    with torch.no_grad():
        out = _step_outputs(logits, labels, mask, loss, count)
    out.update(d_BDR=new_ctrl.d_BDR, curation_mode=new_ctrl.curation_mode,
               caring_modality=new_ctrl.caring_modality, curated=ctrl.curation_mode)
    out.update(_records(model, scales, squeezes))
    return new_ctrl, out


@torch.no_grad()
def eval_step(model, ctrl: ControllerState, batch: Dict[str, torch.Tensor], *, mmtm_off: bool = False,
              average_squeezemaps=None):
    """One eval batch: BatchNorm on its running statistics, the live
    curation flags, and the new MMTM running averages kept in the buffers,
    as the JAX package's trainer keeps them (``framework.py:481-482``).
    ``mmtm_off`` cuts the cross-modal flow with the 4-slot
    ``average_squeezemaps`` (see :func:`~..models.fusion.fused_towers_forward`)."""
    x = preprocess(batch["images"], train=False, dtype=model.dtype)
    mask, labels = batch["mask"], batch["labels"]
    _, logits, scales, squeezes = model(
        x, ctrl.curation_mode, ctrl.caring_modality, train=False, valid_mask=mask,
        mmtm_off=mmtm_off, average_squeezemaps=average_squeezemaps,
    )
    count = _world_count(mask)
    out = _step_outputs(logits, labels, mask, blend_loss(logits, labels, mask, count), count)
    out.update(_records(model, scales, squeezes))
    return out
