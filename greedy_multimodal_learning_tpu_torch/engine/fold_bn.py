"""Running BatchNorm statistics folded into the convolutions before them
(``greedy_multimodal_learning_tpu/engine/fold_bn.py``), for the eval
forward, where BatchNorm is a per-channel affine map.

Pairing, in the port's (torchvision's) names, for 4-D and 5-D convolutions
alike: ``bn1``/``bn2`` normalize ``conv1``/``conv2`` of the same module,
``downsample.1`` normalizes ``downsample.0``.
"""

from __future__ import annotations

import torch


def _conv_of(bn_scope: str):
    """The convolution a BatchNorm scope normalizes, or None."""
    parent, _, name = bn_scope.rpartition(".")
    if bn_scope.endswith("downsample.1"):
        return f"{parent}.0"
    conv = name.replace("bn", "conv")
    if conv == name:
        return None
    return f"{parent}.{conv}" if parent else conv


@torch.no_grad()
def fold_batchnorm(state_dict: dict, eps: float = 1e-5) -> dict:
    """``state_dict`` with every paired BatchNorm folded into its
    convolution (``fold_bn.py:24-63``): with ``g = weight / sqrt(var + eps)``
    per output channel, ``w' = w * g``, ``bias' = bias - mean * g``,
    ``weight' = 1``, ``mean' = 0``, ``var' = 1 - eps``.  Exact at eval up to
    rounding; a train-mode forward must never see the result.  The changed
    entries are new tensors; the inputs are left as they were."""
    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith(".running_mean"):
            continue
        scope = key[: -len(".running_mean")]
        conv = _conv_of(scope)
        if conv is None or f"{conv}.weight" not in state_dict:
            continue
        w = state_dict[f"{conv}.weight"]
        g = state_dict[f"{scope}.weight"] * torch.rsqrt(state_dict[f"{scope}.running_var"] + eps)
        out[f"{conv}.weight"] = (w.float() * g.view((-1,) + (1,) * (w.dim() - 1))).to(w.dtype)
        out[f"{scope}.bias"] = state_dict[f"{scope}.bias"] - state_dict[key] * g
        out[f"{scope}.weight"] = torch.ones_like(g)
        out[key] = torch.zeros_like(state_dict[key])
        out[f"{scope}.running_var"] = torch.full_like(state_dict[f"{scope}.running_var"], 1.0 - eps)
    return out
