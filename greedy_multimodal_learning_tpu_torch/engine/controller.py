"""The balancing controllers as tensor ops on the device
(``greedy_multimodal_learning_tpu/engine/controller.py``): guided, random,
weakest and adaptive-weakest.

Each decision is a pure function of (previous state, this step's BDR sums,
unlock): no ``.item()`` and no host branch on a device value, so the host
never waits for the step.  The decision made at step t applies to the
forward of step t+1.

The state carries the JAX package's PRNG key (``controller.py:39-58``), on
the host: the random controller splits it each step and draws
``randint(sub, (), 0, N + 1)`` there (:mod:`..utils.prng`), so its
decisions are the JAX package's for the same seed, and a checkpoint that
holds the key continues them.  The other controllers never move the key.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from ..utils import prng


def key_tensor(key) -> torch.Tensor:
    """A PRNG key (a (2,) uint32 key, or a tensor or array of its two
    words) as the (2,) int64 CPU tensor the state and the checkpoints hold."""
    if isinstance(key, torch.Tensor):
        if key.device.type == "cpu" and key.dtype == torch.int64 and key.shape == (2,):
            return key
        key = key.detach().cpu().to(torch.int64).numpy()
    return torch.from_numpy(np.asarray(key).astype(np.int64).reshape(2))


def key_array(key: torch.Tensor) -> np.ndarray:
    """:func:`key_tensor`'s inverse: the (2,) uint32 key."""
    return np.asarray(key.numpy(), np.int64).astype(np.uint32)


@dataclass
class ControllerState:
    """``controller.py:39-47``; ``rng`` is the PRNG key, a (2,) int64 CPU
    tensor of its two uint32 words (:func:`key_tensor`), kept on the host
    whatever device the other fields live on."""

    M_main: torch.Tensor  # (N,) float32: accumulated sum|g|^2 / sum|w|^2, main branches
    M_bypass: torch.Tensor  # (N,) float32, MMTM bypass
    curation_mode: torch.Tensor  # () bool
    caring_modality: torch.Tensor  # () int32
    curation_step: torch.Tensor  # () int32
    d_BDR: torch.Tensor  # () float32
    rng: torch.Tensor = field(default_factory=lambda: key_tensor(prng.PRNGKey(0)))

    def __post_init__(self):
        self.rng = key_tensor(self.rng)

    def as_dict(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def init_controller_state(num_modalities: int = 2, device="cpu", seed: int = 0) -> ControllerState:
    """A fresh state on ``device`` whose key is ``PRNGKey(seed)``
    (``controller.py:50-59``)."""
    return ControllerState(
        M_main=torch.zeros(num_modalities, dtype=torch.float32, device=device),
        M_bypass=torch.zeros(num_modalities, dtype=torch.float32, device=device),
        curation_mode=torch.zeros((), dtype=torch.bool, device=device),
        caring_modality=torch.zeros((), dtype=torch.int32, device=device),
        curation_step=torch.zeros((), dtype=torch.int32, device=device),
        d_BDR=torch.zeros((), dtype=torch.float32, device=device),
        rng=key_tensor(prng.PRNGKey(seed)),
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
        rng=state.rng,
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
        rng=state.rng,
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
        rng=state.rng,
    )


def random_draw(key, num_modalities: int):
    """(the next key, this step's draw): ``split(key)``, then
    ``randint(sub, (), 0, N + 1)`` from the second half
    (``controller.py:260-261``), on the host."""
    nxt, sub = prng.split(key)
    return nxt, int(prng.randint(sub, (), 0, num_modalities + 1))


def random_update(
    state: ControllerState,
    gn: torch.Tensor,
    wn: torch.Tensor,
    unlock: torch.Tensor,
    *,
    num_modalities: int = 2,
) -> ControllerState:
    """``controller.py:249-276``: the step's draw (:func:`random_draw` of
    the carried key; the state keeps the next key) is uniform over
    {0, ..., N}; 0 turns curation off, any other value curates, with the
    reference's mapping for two modalities (mode 1 cares for modality 1,
    mode 2 for modality 0) and modality ``mode - 1`` for more.  The draw is
    a host int, so the device sees it only through a fill; the BDR sums,
    ``curation_step`` and ``d_BDR`` are left as they are."""
    nxt, mode = random_draw(key_array(state.rng), num_modalities)
    if num_modalities == 2:
        caring = 1 if mode == 1 else 0
    else:
        caring = max(mode - 1, 0)
    curation = unlock & (mode != 0)
    return ControllerState(
        M_main=state.M_main,
        M_bypass=state.M_bypass,
        curation_mode=curation,
        caring_modality=torch.where(curation, caring, 0).to(state.caring_modality.dtype),
        curation_step=state.curation_step,
        d_BDR=state.d_BDR,
        rng=key_tensor(nxt),
    )


def controller_key(seed: int, kind: str, steps: int) -> np.ndarray:
    """The controller's key after ``steps`` train steps of a run of
    ``kind`` from ``PRNGKey(seed)``, for a checkpoint that does not hold it:
    the random controller's moves one split a step, the others' never
    moves.  Exact only when the run kept one controller kind."""
    key = prng.PRNGKey(seed)
    return prng.key_chain(key, steps) if kind == "random" else key


def null_update(state: ControllerState, gn, wn, unlock) -> ControllerState:
    """No controller configured: curation stays off (``controller.py:279-289``)."""
    return ControllerState(
        M_main=state.M_main,
        M_bypass=state.M_bypass,
        curation_mode=torch.zeros_like(state.curation_mode),
        caring_modality=torch.zeros_like(state.caring_modality),
        curation_step=state.curation_step,
        d_BDR=state.d_BDR,
        rng=state.rng,
    )
