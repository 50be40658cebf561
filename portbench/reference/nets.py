"""Plain float32 PyTorch versions of the two MMTM families, written from
the published descriptions and nothing of the program.

* ResNet-18 (He et al., CVPR 2016; torchvision's layout and names): a 7x7
  stride-2 stem, a 3x3 stride-2 max-pool, four groups of two basic blocks
  at 64/128/256/512 channels, a 1x1 stride-2 projection in the first block
  of groups 2-4, global average pooling and a linear head.
* r3d-18 (Tran et al., CVPR 2018, "A Closer Look at Spatiotemporal
  Convolutions"): the same in 3-D, a (3, 7, 7) stem of stride (1, 2, 2)
  and no max-pool, 3x3x3 convolutions, 1x1x1 projections.
* MMTM (Joze et al., CVPR 2020), as the paper under study uses it
  (arXiv:2202.05306): after groups 2, 3 and 4 each modality's map is
  squeezed by a spatial mean, the squeezes are joined, one linear layer and
  a ReLU make the excitation (width ``2 * sum(C) / 4``), and one linear
  layer and a sigmoid a modality make its gate, which scales the map.  Each
  MMTM keeps a running mean of every modality's gate over the batches it
  has seen (``step`` counts them); with ``bug_compat`` (the original code's
  slip, two modalities) both averages take the first modality's gate.  While
  the guided controller curates modality m, m's map is scaled by its running
  average (after this batch's update) instead of its live gate.
* BatchNorm: in training, batch statistics over the rows the (B,) mask
  keeps and every spatial position, the biased variance to normalize and
  the unbiased one into the running variance (momentum 0.1, eps 1e-5); in
  evaluation, the running statistics.

Parameters live in a dict keyed by torchvision's names
(``net_view_<i>.layer2.0.downsample.0.weight``, ``mmtm3.fc_squeeze.bias``,
``mmtm3.running_avg_<name>``), so the benchmark can hand the same tensors
to the program.  Maps are (B, C, *spatial), float32, contiguous.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

WIDTHS = (64, 128, 256, 512)
FUSION_GROUPS = (2, 3, 4)
EPS = 1e-5
MOMENTUM = 0.1
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Arch:
    """The shapes of one family: ``dims`` 2 (images) or 3 (clips), towers,
    classes, modality names, the width multiplier and ``bug_compat``."""

    def __init__(self, dims, towers, classes, modality_names, width_multiplier=1.0, bug_compat=False):
        self.dims = int(dims)
        self.towers = int(towers)
        self.classes = int(classes)
        self.names = list(modality_names)
        self.width = lambda c: int(c * width_multiplier)
        self.bug_compat = bool(bug_compat)

    def stem(self):
        """(kernel, stride, padding) of the stem convolution."""
        if self.dims == 2:
            return (7, 7), (2, 2), (3, 3)
        return (3, 7, 7), (1, 2, 2), (1, 3, 3)

    def excitation(self, c):
        return int(2 * self.towers * c / 4.0)


def _conv_shape(arch, cout, cin, k):
    return (cout, cin) + ((k,) * arch.dims if isinstance(k, int) else tuple(k))


def tower_schema(arch):
    """[(name, shape, kind)] of one tower; kind is conv, bn, linear."""
    w = arch.width
    out = [("conv1.weight", _conv_shape(arch, w(64), 3, arch.stem()[0]), "conv")]
    out += _bn("bn1", w(64))
    cin = w(64)
    for g, width in enumerate((w(c) for c in WIDTHS), 1):
        for b in range(2):
            p = f"layer{g}.{b}"
            first_in = cin if b == 0 else width
            out.append((f"{p}.conv1.weight", _conv_shape(arch, width, first_in, 3), "conv"))
            out += _bn(f"{p}.bn1", width)
            out.append((f"{p}.conv2.weight", _conv_shape(arch, width, width, 3), "conv"))
            out += _bn(f"{p}.bn2", width)
            if b == 0 and g > 1:
                out.append((f"{p}.downsample.0.weight", _conv_shape(arch, width, first_in, 1), "conv"))
                out += _bn(f"{p}.downsample.1", width)
        cin = width
    out += [("fc.weight", (arch.classes, cin), "linear"), ("fc.bias", (arch.classes,), "linear_bias")]
    return out


def _bn(p, c):
    return [(f"{p}.weight", (c,), "bn_weight"), (f"{p}.bias", (c,), "bn_bias"),
            (f"{p}.running_mean", (c,), "bn_mean"), (f"{p}.running_var", (c,), "bn_var"),
            (f"{p}.num_batches_tracked", (), "bn_count")]


def schema(arch):
    """[(name, shape, kind)] of the whole model: the towers, then the MMTMs."""
    out = []
    for i in range(arch.towers):
        out += [(f"net_view_{i}.{n}", s, k) for n, s, k in tower_schema(arch)]
    for g in FUSION_GROUPS:
        c = arch.width(WIDTHS[g - 1])
        d = arch.excitation(c)
        out += [(f"mmtm{g}.fc_squeeze.weight", (d, arch.towers * c), "linear"),
                (f"mmtm{g}.fc_squeeze.bias", (d,), "linear_bias")]
        for name in arch.names:
            out += [(f"mmtm{g}.fc_{name}.weight", (c, d), "linear"), (f"mmtm{g}.fc_{name}.bias", (c,), "linear_bias")]
        out += [(f"mmtm{g}.running_avg_{name}", (c,), "mmtm_avg") for name in arch.names]
        out.append((f"mmtm{g}.step", (), "mmtm_step"))
    return out


TRAINABLE = ("conv", "linear", "linear_bias", "bn_weight", "bn_bias")


def trainable_names(arch):
    return [n for n, _, k in schema(arch) if k in TRAINABLE]


# ---- layers ---------------------------------------------------------------


def conv(x, w, stride, padding):
    op = F.conv2d if x.dim() == 4 else F.conv3d
    return op(x, w, None, stride, padding)


def batch_norm(x, p, prefix, state, train, mask):
    """BatchNorm of (B, C, *spatial) ``x`` with the parameters and
    statistics under ``prefix``; in training the new running statistics go
    into ``state`` (a dict of new buffers)."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    weight, bias = p[f"{prefix}.weight"], p[f"{prefix}.bias"]
    if not train:
        mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
        return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS) * weight.view(shape) + bias.view(shape)
    dims = (0,) + tuple(range(2, x.dim()))
    m = mask.view((-1,) + (1,) * (x.dim() - 1))
    n = mask.sum() * math.prod(x.shape[2:])
    mean = (x * m).sum(dims) / n
    var = (((x - mean.view(shape)) ** 2) * m).sum(dims) / n
    with torch.no_grad():
        state[f"{prefix}.running_mean"] = (1 - MOMENTUM) * p[f"{prefix}.running_mean"] + MOMENTUM * mean
        state[f"{prefix}.running_var"] = (1 - MOMENTUM) * p[f"{prefix}.running_var"] + MOMENTUM * var * n / (n - 1)
    return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + EPS) * weight.view(shape) + bias.view(shape)


def basic_block(x, p, prefix, stride, project, state, train, mask):
    identity = x
    if project:
        identity = batch_norm(conv(x, p[f"{prefix}.downsample.0.weight"], stride, 0), p, f"{prefix}.downsample.1",
                              state, train, mask)
    out = torch.relu(batch_norm(conv(x, p[f"{prefix}.conv1.weight"], stride, 1), p, f"{prefix}.bn1", state, train,
                                mask))
    out = batch_norm(conv(out, p[f"{prefix}.conv2.weight"], 1, 1), p, f"{prefix}.bn2", state, train, mask)
    return torch.relu(out + identity)


def stem(arch, x, p, t, state, train, mask):
    _, stride, padding = arch.stem()
    x = torch.relu(batch_norm(conv(x, p[f"{t}.conv1.weight"], stride, padding), p, f"{t}.bn1", state, train, mask))
    return F.max_pool2d(x, 3, 2, 1) if arch.dims == 2 else x


def group(arch, g, x, p, t, state, train, mask):
    for b in range(2):
        stride = 2 if (g > 1 and b == 0) else 1
        x = basic_block(x, p, f"{t}.layer{g}.{b}", stride, g > 1 and b == 0, state, train, mask)
    return x


def mmtm(arch, g, feats, p, state, mask, curating, caring):
    """MMTM after group ``g``; ``curating`` (bool) and ``caring`` (int) are
    host values.  The new running averages and step go into ``state``."""
    pre = f"mmtm{g}"
    squeezes = [f.mean(dim=tuple(range(2, f.dim()))) for f in feats]
    joint = torch.cat(squeezes, dim=1)
    exc = torch.relu(joint @ p[f"{pre}.fc_squeeze.weight"].t() + p[f"{pre}.fc_squeeze.bias"])
    gates = [torch.sigmoid(exc @ p[f"{pre}.fc_{n}.weight"].t() + p[f"{pre}.fc_{n}.bias"]) for n in arch.names]
    step = p[f"{pre}.step"]
    with torch.no_grad():
        count = mask.sum().clamp(min=1.0)
        means = [(gt * mask[:, None]).sum(0) / count for gt in gates]
        running = []
        for i, n in enumerate(arch.names):
            src = means[0] if (arch.bug_compat and arch.towers == 2) else means[i]
            running.append((src + p[f"{pre}.running_avg_{n}"] * step) / (step + 1.0))
            state[f"{pre}.running_avg_{n}"] = running[-1]
        state[f"{pre}.step"] = step + 1.0
    out = []
    for i, f in enumerate(feats):
        shape = (f.shape[0], f.shape[1]) + (1,) * (f.dim() - 2)
        scale = running[i].expand_as(gates[i]) if (curating and caring == i) else gates[i]
        out.append(f * scale.reshape(shape))
    return out


def forward(arch, p, x, *, train, mask, curating=False, caring=0):
    """Per-modality logits of the normalized input ``x`` ((B, V, H, W, C)
    images or (B, M, T, H, W, C) clips) and the new buffers (training)."""
    state = {}
    feats = []
    for i in range(arch.towers):
        xi = x[:, i].movedim(-1, 1).contiguous()
        t = f"net_view_{i}"
        feats.append(group(arch, 1, stem(arch, xi, p, t, state, train, mask), p, t, state, train, mask))
    for g in FUSION_GROUPS:
        feats = [group(arch, g, f, p, f"net_view_{i}", state, train, mask) for i, f in enumerate(feats)]
        feats = mmtm(arch, g, feats, p, state, mask, curating, caring)
    logits = []
    for i, f in enumerate(feats):
        pooled = f.mean(dim=tuple(range(2, f.dim())))
        logits.append(pooled @ p[f"net_view_{i}.fc.weight"].t() + p[f"net_view_{i}.fc.bias"])
    return logits, state


def normalize(images_u8, flips=None):
    """uint8 -> float32 in [0, 1] -> ImageNet-normalized; ``flips``, (B, V)
    for images or (B,) for clips, mirror along W."""
    x = images_u8.float() / 255.0
    if flips is not None:
        f = flips.view(tuple(flips.shape) + (1,) * (x.dim() - flips.dim()))
        x = torch.where(f, x.flip(-2), x)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def cross_entropy(logits, labels, mask):
    """Mean cross-entropy over the rows ``mask`` keeps."""
    per_row = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels.long()[:, None])[:, 0]
    return (per_row * mask).sum() / mask.sum().clamp(min=1.0)
