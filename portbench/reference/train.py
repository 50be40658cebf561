"""Plain guided training steps: the loss, its gradients, the balance
statistics, SGD and the guided controller (arXiv:2202.05306, Algorithm 1).

Each step: the train flips, the normalized input, the forward in training
mode with the previous step's curation decision, the sum over modalities of
each modality's mean cross-entropy, the gradients, then

* the balance statistics: for each modality i, the sums of squares of the
  gradients and of the weights (before the update) over its main branch
  (the parameters under ``net_view_i``) and over its MMTM bypass (the MMTM
  parameters named for i, plus the shared squeeze layer, which counts for
  every modality);
* SGD: ``w <- w - lr * g``;
* the controller: while not curating, each modality's accumulated ratio
  ``sum|g|^2 / sum|w|^2`` grows by this step's, per branch;
  ``BDR_i = log10(M_bypass_i / M_main_i)``; the imbalance is ``BDR_0 -
  BDR_1`` for two modalities, else each modality's BDR less the others'
  mean, the largest taken; once unlocked, an imbalance beyond epsilon starts
  a window of ``window`` steps curating the modality with the largest one.

A decision is a threshold on the imbalance, which float32 rounding, grown
over the steps, moves by up to about half a hundredth.  Where the program's decision,
handed in as ``follow``, differs from the reference's and the reference's
imbalances lie within that band of giving it, the decision is a tie: the
reference counts it as the program's and goes on with it, so the steps
after it are compared on the same work.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import keys, nets

# the widest an imbalance may lie from the reference's for a decision on its
# edge to count as a tie: nearly twice the largest gap sound runs read
# (4.5e-3), and under the threshold itself (epsilon 0.01), so that a
# balanced step never counts as curating
DECISION_BAND = 8e-3


@dataclass
class Controller:
    M_main: torch.Tensor
    M_bypass: torch.Tensor
    curating: bool = False
    caring: int = 0
    count: int = 0


def groups(arch, names):
    """Per parameter name, the 0/1 row over [main_0.., bypass_0..]."""
    n = arch.towers
    rows = []
    for name in names:
        row = [0.0] * (2 * n)
        if name.startswith("mmtm"):
            mine = [i for i, m in enumerate(arch.names) if f".fc_{m}." in name]
            for i in mine or range(n):
                row[n + i] = 1.0
        else:
            row[int(name.split(".")[0].rsplit("_", 1)[1])] = 1.0
        rows.append(row)
    return rows


def group_sums(tensors, rows, device):
    total = torch.zeros(len(rows[0]), dtype=torch.float64, device=device)
    for t, row in zip(tensors, rows):
        total += torch.tensor(row, dtype=torch.float64, device=device) * (t.double() ** 2).sum()
    return total


def deviations(M_main, M_bypass):
    """``d_all``, each modality's imbalance, and the scalar the program logs
    as ``d_BDR``."""
    n = M_main.shape[0]
    bdr = torch.log10(M_bypass / M_main)
    if n == 2:
        d_all = torch.stack([bdr[0] - bdr[1], bdr[1] - bdr[0]])
        return d_all, d_all[0]
    d_all = bdr - (bdr.sum() - bdr) / (n - 1)
    return d_all, d_all.max()


def admissible(d_all, decision, epsilon, band):
    """Whether imbalances within ``band`` of ``d_all`` give ``decision``
    (curating, caring) at a step that decides."""
    d = [float(v) for v in d_all]
    curating, caring = decision
    if not curating:
        return max(d) - band <= epsilon
    return d[caring] + band > epsilon and d[caring] + band >= max(d) - band


def guided(ctrl, gn, wn, epsilon, window, unlock=True, follow=None, band=0.0):
    """The controller's step; with ``follow``, the program's decision at
    this step, a tie (see the module's doc) goes the program's way.
    Returns (controller, d_BDR or None where it does not move, tie, the
    imbalance's distance from epsilon where the step decides, else None)."""
    n = ctrl.M_main.shape[0]
    advance = not ctrl.curating or not unlock
    M_main, M_bypass = ctrl.M_main, ctrl.M_bypass
    if advance:
        M_main = M_main + gn[:n] / wn[:n]
        M_bypass = M_bypass + gn[n:] / wn[n:]
    d_all, d_scalar = deviations(M_main, M_bypass)
    level = abs(float(d_scalar)) if n == 2 else float(d_scalar)
    over = level > epsilon
    d_log = d_scalar if advance else None
    out = Controller(M_main, M_bypass, ctrl.curating, ctrl.caring, ctrl.count)
    if not unlock:
        out.curating, out.caring = False, 0
    elif ctrl.curating:
        out.count = ctrl.count + 1
        out.curating = out.count != window
    elif over:
        out.curating, out.caring, out.count = True, int(torch.argmax(d_all)), 0
    else:
        out.curating, out.caring = False, 0
    deciding = unlock and not ctrl.curating
    mine = (out.curating, out.caring if out.curating else 0)
    tie = (follow is not None and deciding and tuple(follow) != mine
           and admissible(d_all, follow, epsilon, band))
    if tie:
        out.curating, out.caring, out.count = bool(follow[0]), int(follow[1]), 0
    return out, d_log, tie, abs(level - epsilon) if deciding else None


def train_steps(arch, state, batches, *, seed, lr, epsilon, window, flip_shape, ctrl=None, first_step=0,
                follow=None, band=DECISION_BAND):
    """``len(batches)`` guided steps from ``state`` (a dict of every
    parameter and buffer, float32 on the device) and ``ctrl`` (a fresh
    controller when None) over ``batches`` of (uint8 images, labels, mask),
    the first of them the run's step ``first_step`` (0-based); ``follow``,
    the program's decision at each step, settles ties.  Returns {losses,
    decisions (ties counted as the program's), ties, d_BDR (the imbalance
    the program logs, each step; None where it does not move), margins
    (the imbalance's distance from epsilon at each step that decides), grads (the first step's, by name), state
    (after the last step)}."""
    names = nets.trainable_names(arch)
    rows = groups(arch, names)
    device = state[names[0]].device
    if ctrl is None:
        ctrl = Controller(torch.zeros(arch.towers, dtype=torch.float64, device=device),
                          torch.zeros(arch.towers, dtype=torch.float64, device=device))
    state = dict(state)
    out = {"losses": [], "decisions": [], "ties": 0, "d_BDR": [], "margins": [], "grads": None}
    for step, (images, labels, mask) in enumerate(batches, first_step):
        flips = torch.from_numpy(keys.train_flips(seed, step, flip_shape(images.shape))).to(device)
        x = nets.normalize(images, flips)
        params = {n: state[n].detach().requires_grad_() for n in names}
        p = {**state, **params}
        logits, new_buffers = nets.forward(arch, p, x, train=True, mask=mask, curating=ctrl.curating,
                                           caring=ctrl.caring)
        loss = sum(nets.cross_entropy(lg, labels, mask) for lg in logits)
        # a curated modality's gate layer takes no part: its gradient is 0
        grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)]
        with torch.no_grad():
            gn = group_sums(grads, rows, device)
            wn = group_sums([state[n] for n in names], rows, device)
            for n, g in zip(names, grads):
                state[n] = state[n] - lr * g
            state.update(new_buffers)
        k = step - first_step
        ctrl, d, tie, margin = guided(ctrl, gn, wn, epsilon, window, follow=None if follow is None else follow[k],
                              band=band)
        out["ties"] += int(tie)
        out["d_BDR"].append(None if d is None else float(d))
        if margin is not None:
            out["margins"].append(margin)
        if out["grads"] is None:
            out["grads"] = dict(zip(names, (g.detach() for g in grads)))
        out["losses"].append(float(loss.detach()))
        out["decisions"].append((bool(ctrl.curating), int(ctrl.caring) if ctrl.curating else 0))
        del logits, loss, grads, params, p
    out["state"] = state
    return out
