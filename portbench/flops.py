"""Operations and bytes from shapes: the model FLOPs of both families and
the fused gating kernels' least time.

Model FLOPs count the convolutions and the linear layers (2 per
multiply-add): the forward, and for training also the gradients with
respect to the data (none for the stem, whose input needs none) and to the
weights.  BatchNorm, pooling, activations and the loss are not counted, as
utilization is counted by convention.

The gating kernels' counts are those the kernels' own checks use: each
input byte read once and each output byte written once over the HBM
bandwidth, or the arithmetic over the float32 peak, whichever is longer.
"""

from __future__ import annotations

import math

from . import peaks
from .reference.nets import FUSION_GROUPS, WIDTHS


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def tower_layers(arch, spatial):
    """[(name, multiply-adds a sample)] of one tower's convolutions and its
    head on an input of ``spatial`` ((H, W) or (T, H, W)), and the output
    sizes after each group as {group: spatial}."""
    kernel, stride, padding = arch.stem()
    w = arch.width
    sp = tuple(_out(n, k, s, p) for n, k, s, p in zip(spatial, kernel, stride, padding))
    layers = [("stem", w(64) * 3 * math.prod(kernel) * math.prod(sp))]
    if arch.dims == 2:
        sp = tuple(_out(n, 3, 2, 1) for n in sp)
    k3 = 3 ** arch.dims
    cin, after = w(64), {}
    for g, width in enumerate((w(c) for c in WIDTHS), 1):
        for b in range(2):
            s = 2 if (g > 1 and b == 0) else 1
            out = tuple(_out(n, 3, s, 1) for n in sp)
            first_in = cin if b == 0 else width
            layers.append((f"layer{g}.{b}.conv1", width * first_in * k3 * math.prod(out)))
            layers.append((f"layer{g}.{b}.conv2", width * width * k3 * math.prod(out)))
            if g > 1 and b == 0:
                layers.append((f"layer{g}.{b}.downsample", width * first_in * math.prod(out)))
            sp = out
        cin = width
        after[g] = sp
    layers.append(("fc", arch.classes * cin))
    return layers, after


def mmtm_macs(arch):
    """Multiply-adds a sample of the MMTM linears (the squeeze layer over
    the joined squeezes, one excitation layer a modality)."""
    total = 0
    for g in FUSION_GROUPS:
        c = arch.width(WIDTHS[g - 1])
        d = arch.excitation(c)
        total += arch.towers * c * d + arch.towers * d * c
    return total


def forward_macs(arch, spatial):
    layers, _ = tower_layers(arch, spatial)
    return arch.towers * sum(m for _, m in layers) + mmtm_macs(arch)


def forward_flops(arch, spatial):
    """FLOPs of one sample's forward."""
    return 2 * forward_macs(arch, spatial)


def train_flops(arch, spatial):
    """FLOPs of one sample's training step: forward, data gradients (none
    for the stem) and weight gradients."""
    layers, _ = tower_layers(arch, spatial)
    stem = arch.towers * dict(layers)["stem"]
    return 2 * (3 * forward_macs(arch, spatial) - stem)


def gating_sites(arch, spatial):
    """(S, C) of each MMTM: the positions and channels of its maps."""
    _, after = tower_layers(arch, spatial)
    return [(math.prod(after[g]), arch.width(WIDTHS[g - 1])) for g in FUSION_GROUPS]


def gating_fwd_counts(B, S, C, itemsize=4):
    """(bytes, FLOPs) of one fused gating forward: the two maps read and the
    two scaled maps written, the weights read, the squeeze and gate rows
    written in float32; the products, the squeeze and the scale."""
    D = C
    maps = B * S * C * itemsize
    weights = (2 * C * D + D + 2 * (D * C + C)) * itemsize
    rows = 4 * B * C * 4
    flops = 2 * B * (2 * C * D + 2 * D * C) + 2 * 2 * B * S * C
    return 4 * maps + weights + rows, flops


def gating_bwd_counts(B, S, C, itemsize=4):
    """(bytes, FLOPs) of one fused gating backward: both cotangent maps and
    both feature maps read, both data gradients written, the weights and the
    eight float32 (B, C) rows read, the float32 weight gradients written;
    two spatial passes and five B x D x 2C products."""
    D = C
    weights = 2 * C * D + D + 2 * D * C
    nbytes = 6 * B * S * C * itemsize + weights * itemsize + 8 * B * C * 4 + (weights + 2 * C) * 4
    flops = 2 * 2 * B * S * C + 3 * 2 * B * S * C + 2 * 5 * B * D * 2 * C
    return nbytes, flops


def least_seconds(nbytes, flops):
    """The least time of a float32 call: its bytes over the HBM bandwidth or
    its FLOPs over the float32 peak, whichever is longer."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.F32_FLOPS)
