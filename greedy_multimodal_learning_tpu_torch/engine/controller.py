"""The balancing controllers as tensor ops on the device
(``greedy_multimodal_learning_tpu/engine/controller.py``): guided, random,
weakest and adaptive-weakest.

Each decision is a pure function of (previous state, this step's BDR sums,
unlock), and for the random controller this step's draw: no ``.item()``
and no host branch on a device value, so the host never waits for the
step.  The decision made at step t applies to the forward of step t+1.

The random controller's draw for step t comes from a generator on the
device reseeded from (seed, t) (:func:`random_draw`), as the train flips
are; the JAX package carries a PRNG key instead, so the two packages' draws
agree only in distribution.  A resumed run draws what a straight run draws.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch


# Keeps the random controller's seeds apart from the train flips' (seed *
# 1_000_003 + step, Trainer.train_flips): the two streams never share a seed.
DRAW_STREAM = 1 << 62


@dataclass
class ControllerState:
    """``controller.py:39-47`` without the PRNG key: the random controller's
    draw is a function of (seed, step) instead."""

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


def _bdr_deviation(M_main, M_bypass):
    """The d_BDR telemetry: BDR_0 - BDR_1 for two modalities, else the
    largest deviation of a modality's BDR from the others' mean."""
    n = M_main.shape[0]
    bdr = torch.log10(M_bypass / M_main)
    if n == 2:
        return bdr[0] - bdr[1]
    return (bdr - (bdr.sum() - bdr) / (n - 1)).max()


def weakest_update(
    state: ControllerState,
    gn: torch.Tensor,
    wn: torch.Tensor,
    unlock: torch.Tensor,
    *,
    curation_windowsize: int,
    duty_period: int,
) -> ControllerState:
    """``controller.py:122-175``: the host designates the target once an
    epoch in ``caring_modality`` (-1: none yet; see
    :class:`~.callbacks.Bias_Mitigation_Weakest`), and the target is curated
    ``curation_windowsize`` of every ``duty_period`` unlocked steps.  The
    BDR sums advance every step and give the d_BDR telemetry only."""
    n = state.M_main.shape[0]
    M_main = state.M_main + gn[:n] / wn[:n]
    M_bypass = state.M_bypass + gn[n:] / wn[n:]
    target = state.caring_modality
    phase = torch.remainder(state.curation_step, duty_period)
    return ControllerState(
        M_main=M_main,
        M_bypass=M_bypass,
        curation_mode=unlock & (target >= 0) & (phase < curation_windowsize),
        caring_modality=target,
        curation_step=torch.where(unlock, state.curation_step + 1, state.curation_step),
        d_BDR=_bdr_deviation(M_main, M_bypass),
    )


def adaptive_weakest_update(
    state: ControllerState,
    gn: torch.Tensor,
    wn: torch.Tensor,
    unlock: torch.Tensor,
    *,
    curation_windowsize: int,
) -> ControllerState:
    """``controller.py:178-246``: the guided controller's windows (enter,
    count ``curation_windowsize`` steps down, leave, enter again) with
    "the host designated a target" (``caring_modality`` >= 0, see
    :class:`~.callbacks.Bias_Mitigation_AdaptiveWeakest`) in place of the
    BDR trigger.  The BDR sums freeze while curating, as guided's do."""
    n = state.M_main.shape[0]
    target = state.caring_modality
    over = target >= 0
    advance = ~state.curation_mode | ~unlock
    M_main = torch.where(advance, state.M_main + gn[:n] / wn[:n], state.M_main)
    M_bypass = torch.where(advance, state.M_bypass + gn[n:] / wn[n:], state.M_bypass)
    new_d = torch.where(advance, _bdr_deviation(M_main, M_bypass), state.d_BDR)

    enter = unlock & ~state.curation_mode & over
    counting = unlock & state.curation_mode
    next_count = state.curation_step + 1
    window_done = next_count == curation_windowsize
    return ControllerState(
        M_main=M_main,
        M_bypass=M_bypass,
        curation_mode=unlock & torch.where(state.curation_mode, ~window_done, over),
        caring_modality=target,
        curation_step=torch.where(enter, torch.zeros_like(next_count),
                                  torch.where(counting, next_count, state.curation_step)),
        d_BDR=new_d,
    )


def random_draw(generator: torch.Generator, seed: int, step: int, num_modalities: int) -> torch.Tensor:
    """The random controller's draw for ``step``: a () int64 uniform over
    {0, ..., N} on the generator's device, from ``generator`` reseeded by
    (seed, step)."""
    generator.manual_seed(DRAW_STREAM + seed * 1_000_003 + step)
    return torch.randint(0, num_modalities + 1, (), generator=generator, device=generator.device)


def random_update(
    state: ControllerState,
    gn: torch.Tensor,
    wn: torch.Tensor,
    unlock: torch.Tensor,
    mode: torch.Tensor,
    *,
    num_modalities: int = 2,
) -> ControllerState:
    """``controller.py:249-276``, with the step's draw ``mode`` (uniform over
    {0, ..., N}) given: 0 turns curation off, any other value curates, with
    the reference's mapping for two modalities (mode 1 cares for modality
    1, mode 2 for modality 0) and modality ``mode - 1`` for more.  The BDR
    sums, ``curation_step`` and ``d_BDR`` are left as they are."""
    curation = unlock & (mode != 0)
    if num_modalities == 2:
        caring = torch.where(mode == 1, 1, 0)
    else:
        caring = (mode - 1).clamp(min=0)
    caring = caring.to(state.caring_modality.dtype)
    return ControllerState(
        M_main=state.M_main,
        M_bypass=state.M_bypass,
        curation_mode=curation,
        caring_modality=torch.where(curation, caring, torch.zeros_like(caring)),
        curation_step=state.curation_step,
        d_BDR=state.d_BDR,
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
