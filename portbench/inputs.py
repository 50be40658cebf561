"""Everything a run feeds both the program and the reference, made from
``--seed``: the weights (on the device, a few large draws of a
``torch.Generator`` there), the uint8 corpora (drawn on the device, kept on
the host, where the program's data layer reads them) and the order of the
serving requests.  The same seed gives the same inputs.

Weights follow the published initializations: He normal scaled by the
fan-out for convolutions, uniform within ``1/sqrt(fan_in)`` for linear
weights and biases, BatchNorm at scale 1, shift 0, mean 0, variance 1, the
MMTM running averages and counters at 0.  A served checkpoint has seen
training, so for serving the BatchNorm scales, shifts and statistics are
drawn too, near those values.

A corpus sample is uniform noise with a band of rows whose brightness
encodes the label, so training has something to learn.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import nets

# one generator stream each, from the seed
WEIGHTS, TRAIN_CORPUS, TEST_CORPUS, REQUESTS, CHECK_SAMPLE = range(5)


def stream_seed(seed: int, stream: int) -> int:
    return (int(seed) * 8 + stream) % (2 ** 63)


def generator(seed, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


@torch.no_grad()
def weights(arch, seed, device, serving=False):
    """{name: tensor} of every parameter and buffer, float32 (BatchNorm
    counters int64), on ``device``."""
    sch = nets.schema(arch)
    shapes = {n: s for n, s, _ in sch}
    g = generator(seed, WEIGHTS, device)
    convs = [(n, s) for n, s, k in sch if k == "conv"]
    normal = torch.randn(sum(math.prod(s) for _, s in convs), generator=g, device=device)
    linears = [(n, s) for n, s, k in sch if k in ("linear", "linear_bias")]
    unit = torch.rand(sum(math.prod(s) for _, s in linears), generator=g, device=device) * 2.0 - 1.0
    norms = [(n, s, k) for n, s, k in sch if k.startswith("bn_") and k != "bn_count"]
    spread = torch.rand(sum(math.prod(s) for _, s, _ in norms), generator=g, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for n, s in convs:
        size = math.prod(s)
        std = math.sqrt(2.0 / (s[0] * math.prod(s[2:])))
        out[n] = (normal[off:off + size] * std).view(s)
        off += size
    off = 0
    for n, s in linears:
        size = math.prod(s)
        fan_in = shapes[n.rsplit(".", 1)[0] + ".weight"][1]
        out[n] = (unit[off:off + size] / math.sqrt(fan_in)).view(s)
        off += size
    base = {"bn_weight": 1.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_var": 1.0}
    width = {"bn_weight": 0.25, "bn_bias": 0.1, "bn_mean": 0.1, "bn_var": 0.25}
    off = 0
    for n, s, k in norms:
        size = math.prod(s)
        value = torch.full(s, base[k], device=device)
        if serving:
            value = value + width[k] * spread[off:off + size].view(s)
        out[n] = value
        off += size
    for n, s, k in sch:
        if k == "bn_count":
            out[n] = torch.zeros(s, dtype=torch.int64, device=device)
        elif k in ("mmtm_avg", "mmtm_step"):
            out[n] = torch.zeros(s, device=device)
    return {n: out[n].contiguous() for n, _, _ in sch}


@torch.no_grad()
def corpus(sample_shape, n, classes, seed, stream, device):
    """(uint8 samples (n, *sample_shape), int32 labels (n,)) as host numpy
    arrays; ``sample_shape`` ends in (H, W, C)."""
    g = generator(seed, stream, device)
    images = torch.randint(0, 256, (n,) + tuple(sample_shape), dtype=torch.uint8, generator=g, device=device)
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    band = (20 + labels * 200 // max(classes - 1, 1)).to(torch.uint8)
    rows = sample_shape[-3] // 8
    view = images.movedim(-3, 1)[:, :rows]  # (n, rows, ...)
    view.copy_(band.view((n,) + (1,) * (view.dim() - 1)).expand_as(view))
    return images.cpu().numpy(), labels.to(torch.int32).cpu().numpy()


class ArrayDataset:
    """A map-style dataset over host arrays: item i is (i, sample i, label i)."""

    def __init__(self, images, labels):
        self.images = images
        self.labels = labels

    def __getitem__(self, i):
        return i, self.images[i], int(self.labels[i])


def request_indices(n, batch, seed):
    """The rows of each request, one after the other: seeded permutations
    of the corpus, joined, cut into batches."""
    rng = np.random.default_rng([int(seed), REQUESTS])
    pending = np.zeros(0, np.int64)
    while True:
        while len(pending) < batch:
            pending = np.concatenate([pending, rng.permutation(n)])
        yield pending[:batch]
        pending = pending[batch:]
