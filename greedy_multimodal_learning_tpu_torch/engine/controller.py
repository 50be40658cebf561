"""The guided balancing controller as tensor ops on the device
(``greedy_multimodal_learning_tpu/engine/controller.py``).

The decision is a pure function of (previous state, this step's BDR sums,
unlock): no ``.item()`` and no host branch on a device value, so the host
never waits for the step.  The decision made at step t applies to the
forward of step t+1.  The random, weakest and adaptive controllers are not
ported yet; their callbacks raise.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch


@dataclass
class ControllerState:
    """``controller.py:39-47`` without the PRNG key, which only the random
    controller reads."""

    M_main: torch.Tensor  # (N,) float32: accumulated sum|g|^2 / sum|w|^2, main branches
    M_bypass: torch.Tensor  # (N,) float32, MMTM bypass
    curation_mode: torch.Tensor  # () bool
    caring_modality: torch.Tensor  # () int32
    curation_step: torch.Tensor  # () int32
    d_BDR: torch.Tensor  # () float32

    def as_dict(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def init_controller_state(num_modalities: int = 2, device="cpu") -> ControllerState:
    return ControllerState(
        M_main=torch.zeros(num_modalities, dtype=torch.float32, device=device),
        M_bypass=torch.zeros(num_modalities, dtype=torch.float32, device=device),
        curation_mode=torch.zeros((), dtype=torch.bool, device=device),
        caring_modality=torch.zeros((), dtype=torch.int32, device=device),
        curation_step=torch.zeros((), dtype=torch.int32, device=device),
        d_BDR=torch.zeros((), dtype=torch.float32, device=device),
    )


def guided_update(
    state: ControllerState,
    gn: torch.Tensor,
    wn: torch.Tensor,
    unlock: torch.Tensor,
    *,
    epsilon: float,
    curation_windowsize: int,
) -> ControllerState:
    """``controller.py:62-119``.  ``gn``, ``wn``: (2N,) [main.., bypass..]
    sums of squares of this step's gradients and weights; ``unlock``: ()
    bool, epoch >= starting_epoch."""
    n = state.M_main.shape[0]
    advance = ~state.curation_mode | ~unlock
    M_main = torch.where(advance, state.M_main + gn[:n] / wn[:n], state.M_main)
    M_bypass = torch.where(advance, state.M_bypass + gn[n:] / wn[n:], state.M_bypass)

    bdr = torch.log10(M_bypass / M_main)
    if n == 2:
        d_all = torch.stack([bdr[0] - bdr[1], bdr[1] - bdr[0]])
        d_scalar, over = d_all[0], d_all[0].abs() > epsilon
    else:
        d_all = bdr - (bdr.sum() - bdr) / (n - 1)
        d_scalar = d_all.max()
        over = d_scalar > epsilon
    new_d = torch.where(advance, d_scalar, state.d_BDR)
    candidate = d_all.argmax().to(torch.int32)

    enter = unlock & ~state.curation_mode & over
    counting = unlock & state.curation_mode
    next_count = state.curation_step + 1
    window_done = next_count == curation_windowsize
    zero = torch.zeros_like(state.caring_modality)
    return ControllerState(
        M_main=M_main,
        M_bypass=M_bypass,
        curation_mode=unlock & torch.where(state.curation_mode, ~window_done, over),
        caring_modality=torch.where(enter, candidate, torch.where(counting, state.caring_modality, zero)),
        curation_step=torch.where(enter, zero, torch.where(counting, next_count, state.curation_step)),
        d_BDR=new_d,
    )


def null_update(state: ControllerState, gn, wn, unlock) -> ControllerState:
    """No controller configured: curation stays off (``controller.py:279-289``)."""
    return ControllerState(
        M_main=state.M_main,
        M_bypass=state.M_bypass,
        curation_mode=torch.zeros_like(state.curation_mode),
        caring_modality=torch.zeros_like(state.caring_modality),
        curation_step=state.curation_step,
        d_BDR=state.d_BDR,
    )
