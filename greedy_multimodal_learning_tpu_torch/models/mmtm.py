"""MMTM squeeze-excitation cross-modal fusion, N-modality
(``greedy_multimodal_learning_tpu/models/mmtm.py``).

1. squeeze: per-modality spatial mean in float32,
2. joint excitation: relu(fc_squeeze(concat(squeezes))),
3. per-modality gates: sigmoid(fc_<name>(excitation)),
4. running-average gate buffers updated on every forward, eval included,
   with a step counter, from the gate means over the valid rows (over the
   data group's rows under data parallelism, on every branch); ``bug_compat``
   replicates the reference's update of every running average from the
   first modality's gate (2 modalities only),
5. curation: the cared-for modality's gate is replaced by the post-update
   running average,
6. ``turnoff_cross_modal_flow`` (``mmtm.py:150-166``): each modality sees its
   own live squeeze and, for every other modality, the dataset-average
   squeeze broadcast over the batch (the conditional-utilization eval).

Two gating paths compute steps 1-3 and the scale, as in the JAX package:
the eager path (``mmtm.py:212-217``), where ``fc_*`` add their bias in the
compute dtype, and the fused kernel path (``mmtm.py:168-211``,
``use_pallas``), where :class:`~..ops.mmtm_gating.MMTMGatingFunction` adds
it in float32 and differentiates with the fused backward.  On CUDA tensors
``use_pallas=True`` means the CUDA kernels, forward and backward.  Under
tensor parallelism the kernel takes its weights whole, joined over the model
group (:func:`~..parallel.tensor.full_weight`), as XLA hands the JAX
package's kernel whole operands; the eager paths run the ``fc_*`` linears
column-parallel.

The flow-off branch takes precedence over the kernel branch, as in the JAX
package: it runs no kernel.  Two variants (``mmtm.py:74-102,138-143``):
``SEonly`` squeezes each modality alone (``fc_squeeze_<name>``, no
cross-modal squeeze; its branch comes first, so it ignores
``turnoff_cross_modal_flow``), and ``shareweight`` shares one
``fc_excite`` among the modalities.  Neither takes the kernel path: the
kernels compute the joint squeeze with one excitation a modality.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from .. import config as cfg
from ..ops.mmtm_gating import MMTMGatingFunction
from ..parallel import mesh as parallel
from ..parallel.tensor import full_weight
from .layers import Linear


def mmtm_config_kwargs():
    """Read the ``MMTM_mitigate`` gin surface."""
    return dict(
        SEonly=bool(cfg.query("MMTM_mitigate", "SEonly", False)),
        shareweight=bool(cfg.query("MMTM_mitigate", "shareweight", False)),
        bug_compat=bool(cfg.query("MMTM_mitigate", "bug_compat", True)),
        use_pallas=bool(cfg.query("MMTM_mitigate", "use_pallas", False)),
    )


def _as_bsc(f):
    """(B, C, *spatial) map in channels-last memory -> (B, S, C) view.
    Raises instead of copying when the memory is not channels-last."""
    return f.movedim(1, -1).view(f.shape[0], -1, f.shape[1])


def _static_false(flag) -> bool:
    return flag is None or (not isinstance(flag, torch.Tensor) and not flag)


class MMTM(nn.Module):
    """N-modality MMTM fusion with running-average gate state.

    Attribute names (``fc_squeeze`` or ``fc_squeeze_<name>``, ``fc_<name>``
    or ``fc_excite``, ``running_avg_<name>``, ``step``) are the JAX
    package's, so its parameters load by name."""

    def __init__(
        self,
        dims: Sequence[int],
        ratio: float = 4.0,
        modality_names: Sequence[str] = ("visual", "skeleton"),
        SEonly: bool = False,
        shareweight: bool = False,
        bug_compat: bool = True,
        use_pallas: bool = False,
    ):
        super().__init__()
        if len(dims) != len(modality_names):
            raise ValueError(f"{len(dims)} dims for {len(modality_names)} modality names")
        if shareweight and len(set(dims)) != 1:
            raise ValueError(f"MMTM_mitigate.shareweight needs equal dims, got {list(dims)}")
        self.dims = list(dims)
        self.modality_names = list(modality_names)
        self.SEonly = SEonly
        self.shareweight = shareweight
        self.bug_compat = bug_compat
        self.use_pallas = use_pallas
        dim_out = int(2 * sum(dims) / ratio)
        if SEonly:
            for d, name in zip(dims, modality_names):
                setattr(self, f"fc_squeeze_{name}", Linear(d, dim_out))
        else:
            self.fc_squeeze = Linear(sum(dims), dim_out)
        if shareweight:
            self.fc_excite = Linear(dim_out, dims[0])
        else:
            for d, name in zip(dims, modality_names):
                setattr(self, f"fc_{name}", Linear(dim_out, d))
        for d, name in zip(dims, modality_names):
            self.register_buffer(f"running_avg_{name}", torch.zeros(d))
        self.register_buffer("step", torch.zeros(()))

    def _excite(self, i: int):
        return self.fc_excite if self.shareweight else getattr(self, f"fc_{self.modality_names[i]}")

    def _use_kernel(self, features) -> bool:
        """The JAX package's kernel guard (``mmtm.py:168-182``)."""
        return (
            self.use_pallas
            and not self.SEonly
            and not self.shareweight
            and len(features) == 2
            and len(set(self.dims)) == 1
            and features[0].dim() >= 3
            and features[0].shape == features[1].shape
        )

    def forward(
        self,
        features: List[torch.Tensor],
        *,
        curation_mode=None,
        caring_modality=None,
        turnoff_cross_modal_flow: bool = False,
        average_squeezemaps: Optional[Sequence[torch.Tensor]] = None,
        valid_mask: Optional[torch.Tensor] = None,
        return_scale: bool = False,
        return_squeezed_mps: bool = False,
        state_out: Optional[dict] = None,
    ):
        """Fuse ``features`` (list of (B, C_i, *spatial) maps).

        ``curation_mode`` / ``caring_modality`` are Python values or 0-dim
        tensors.  With ``turnoff_cross_modal_flow``, ``average_squeezemaps``
        holds one (C_i,) tensor a modality on the features' device.  The
        new running averages and step go into the module's buffers, or into
        ``state_out`` (keyed by buffer name) when it is given, leaving the
        buffers as they were.  Returns
        (scaled_features, scales, squeezes); scales/squeezes are None unless
        requested."""
        n = len(features)
        batch = features[0].shape[0]
        dtype = features[0].dtype
        device = features[0].device
        mask = torch.ones(batch, device=device) if valid_mask is None else valid_mask.float()

        pre_scaled = None  # the kernel path returns the live-gate-scaled features
        if self._use_kernel(features) and not turnoff_cross_modal_flow:
            f0, f1 = _as_bsc(features[0]), _as_bsc(features[1])
            cast = lambda t: t.to(dtype)
            e0, e1 = self._excite(0), self._excite(1)
            out0, out1, s0, s1, g0, g1 = MMTMGatingFunction.apply(
                f0, f1,
                cast(full_weight(self.fc_squeeze)), cast(self.fc_squeeze.bias),
                cast(full_weight(e0)), cast(e0.bias),
                cast(full_weight(e1)), cast(e1.bias),
            )
            squeezes, gates = [s0, s1], [g0, g1]
            pre_scaled = [
                out.view(f.movedim(1, -1).shape).movedim(-1, 1) for out, f in zip((out0, out1), features)
            ]
        else:
            squeezes = [f.mean(dim=tuple(range(2, f.dim())), dtype=torch.float32) for f in features]
            if self.SEonly:
                gates = [
                    torch.sigmoid(self._excite(i)(torch.relu(
                        getattr(self, f"fc_squeeze_{name}")(squeezes[i].to(dtype)))).float())
                    for i, name in enumerate(self.modality_names)
                ]
            elif not turnoff_cross_modal_flow:
                excitation = torch.relu(self.fc_squeeze(torch.cat(squeezes, dim=1).to(dtype)))
                gates = [torch.sigmoid(self._excite(i)(excitation).float()) for i in range(n)]
            elif average_squeezemaps is None:
                raise ValueError("turnoff_cross_modal_flow needs average_squeezemaps")
            else:
                gates = []
                for i in range(n):
                    parts = [
                        squeezes[j] if j == i
                        else average_squeezemaps[j].float()[None, :].expand(batch, self.dims[j])
                        for j in range(n)
                    ]
                    excitation = torch.relu(self.fc_squeeze(torch.cat(parts, dim=1).to(dtype)))
                    gates.append(torch.sigmoid(self._excite(i)(excitation).float()))

        # --- running-average gate buffers (updated every forward) ---
        with torch.no_grad():
            step = self.step
            sums, count = [(g * mask[:, None]).sum(dim=0) for g in gates], mask.sum()
            world = parallel.active()
            if world is not None:
                # the data group's gate sums and valid rows, in one collective
                *sums, count = parallel.all_reduce_(torch.cat(sums + [count[None]]), world.data_group).split(
                    [s.numel() for s in sums] + [1])
                count = count[0]
            denom = count.clamp(min=1.0)
            gate_means = [s / denom for s in sums]
            new_running = []
            for i, name in enumerate(self.modality_names):
                src = gate_means[0] if (self.bug_compat and n == 2) else gate_means[i]
                new_running.append((src + getattr(self, f"running_avg_{name}") * step) / (step + 1.0))
            new_state = {f"running_avg_{name}": r for name, r in zip(self.modality_names, new_running)}
            new_state["step"] = step + 1.0
            if state_out is None:
                for key, value in new_state.items():
                    getattr(self, key).copy_(value)
            else:
                state_out.update(new_state)

        scales = list(gates) if return_scale else None
        squeezed_mps = list(squeezes) if return_squeezed_mps else None

        # --- curation select: cared modality's gate <- post-update running avg ---
        outs = []
        curating = not _static_false(curation_mode)
        for i, f in enumerate(features):
            gshape = (batch, self.dims[i]) + (1,) * (f.dim() - 2)
            if not curating:
                outs.append(pre_scaled[i] if pre_scaled is not None else f * gates[i].view(gshape).to(dtype))
                continue
            use_avg = torch.as_tensor(curation_mode, device=device).bool() & (
                torch.as_tensor(caring_modality, device=device) == i
            )
            if pre_scaled is not None:
                avg = new_running[i].view((1,) + gshape[1:]).to(dtype)
                outs.append(torch.where(use_avg, f * avg, pre_scaled[i]))
            else:
                gate = torch.where(use_avg, new_running[i][None, :].expand_as(gates[i]), gates[i])
                outs.append(f * gate.view(gshape).to(dtype))
        return outs, scales, squeezed_mps
