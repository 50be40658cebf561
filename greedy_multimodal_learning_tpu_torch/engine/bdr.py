"""In-step BDR statistics: per-group sums of squares of the gradients and
the weights (``greedy_multimodal_learning_tpu/engine/bdr.py:35-110``).

Group membership comes from ``named_parameters()`` by the JAX package's
substring rules (``bdr.py:35-59``), which the port's names satisfy as the
flax paths do (``net_view_i``, ``mmtm``, the modality names):

* a name containing ``mmtm`` is a bypass parameter; within bypass, a name
  containing modality name i belongs to modality i's bypass group, else it
  is shared and counts toward every modality's bypass group,
* otherwise a name containing branch name i belongs to modality i's main
  group.

Tensors with the same membership pattern are flattened together and reduced
in one sum, so a step makes one reduction per pattern (at most six), not one
per parameter.  Under tensor parallelism the sharded weights' sums are
taken apart (:meth:`GroupReducer.split`) and added over the model group, so
each whole tensor counts once.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def group_membership(names: Sequence[str], branchnames: Sequence[str], mmtm_names: Sequence[str]) -> List[tuple]:
    """One 0/1 tuple per name over the columns [main_0..main_{N-1},
    bypass_0..bypass_{N-1}]."""
    n = len(branchnames)
    if len(mmtm_names) != n:
        raise ValueError(f"{n} branch names for {len(mmtm_names)} MMTM names")
    rows = []
    for name in names:
        row = [0] * (2 * n)
        if "mmtm" in name:
            mine = [i for i, modal in enumerate(mmtm_names) if modal in name]
            for i in mine or range(n):
                row[n + i] = 1
        else:
            for i, branch in enumerate(branchnames):
                if branch in name:
                    row[i] = 1
        rows.append(tuple(row))
    return rows


class GroupReducer:
    """``reducer(tensors) -> (2N,) float32`` of per-group sums of squares,
    for tensors in the order of the ``names`` it was built from.
    ``empty_groups`` names the groups that no parameter matched (their BDR
    ratio would be 0/0)."""

    def __init__(self, names: Sequence[str], branchnames: Sequence[str], mmtm_names: Sequence[str]):
        rows = group_membership(names, branchnames, mmtm_names)
        width = 2 * len(branchnames)
        labels = [f"main:{b}" for b in branchnames] + [f"bypass:{m}" for m in mmtm_names]
        self.empty_groups = [labels[c] for c in range(width) if not any(r[c] for r in rows)]
        patterns = {}
        for i, row in enumerate(rows):
            if any(row):
                patterns.setdefault(row, []).append(i)
        self.width = width
        self.patterns = [(torch.tensor(vec, dtype=torch.float32), idx) for vec, idx in patterns.items()]

    def __call__(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.split(tensors, [False] * len(tensors))[0]

    def split(self, tensors: Sequence[torch.Tensor], sharded: Sequence[bool]) -> tuple:
        """(the sums of the tensors ``sharded`` does not mark, the sums of
        the marked ones), each (2N,): under tensor parallelism a rank holds
        its rows of the marked tensors, whose sums the caller adds over the
        model group, while every rank of the group holds the others whole."""
        device = tensors[0].device
        totals = [torch.zeros(self.width, device=device), torch.zeros(self.width, device=device)]
        for vec, idx in self.patterns:
            for part, total in enumerate(totals):
                mine = [tensors[i].reshape(-1) for i in idx if bool(sharded[i]) == bool(part)]
                if mine:
                    flat = torch.cat(mine).float()
                    totals[part] = totals[part] + vec.to(device) * (flat * flat).sum()
        return tuple(totals)
