"""Statistics of a north-star summary, and of the port's runs against a
reference's: the port's copy of ``tools/analyze_northstar.py`` and
``tools/analyze_northstar3d.py`` (numpy only), with :func:`compare`, the
counterpart of ``tools/parity/report.py``'s cross-package report.

The tests are those of the tools: an exact two-sided permutation test on
the difference of arm means (every C(n0+n1, n0) assignment while that count
is at most ``_EXACT_LIMIT``, else ``_MC_SAMPLES`` label shuffles drawn from
``rng_seed``, the same shuffles as the tools'), and the Mann-Whitney U with
its AUC.  The shuffles are drawn as one array (``Generator.permuted`` takes
the random stream that one ``Generator.permutation`` call a shuffle takes),
and a suite's comparisons of one size share them.

Usage:  python -m greedy_multimodal_learning_tpu_torch.experiments.analyze SUMMARY [--reference REF_SUMMARY]

Without ``--reference`` it prints the tool's report of the summary's family
(3-D when its runs have ``test_acc_modal_2``); with it, also the table of
:func:`compare` over the arms both summaries hold, with Holm's adjusted p
over the family's comparisons.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
from math import comb

import numpy as np

_EXACT_LIMIT = 4_000_000  # C(24,12) = 2.7M is fine; C(32,16) = 601M is not
_MC_SAMPLES = 400_000
_CHUNK = 50_000  # assignments or shuffles a block
ARMS = ("guided", "random", "weakest", "weakest80", "adaptive")
METRICS = {
    "2d": ("test_acc", "test_acc_modal_0", "test_acc_modal_1", "flowoff_test_acc_modal_1", "epochs_run",
           "steps_to_90_top1"),
    "3d": ("test_acc", "test_acc_modal_0", "test_acc_modal_1", "test_acc_modal_2", "flowoff_test_acc_modal_1",
           "flowoff_test_acc_modal_2", "epochs_run"),
}
# The metric of each family's headline claim (RESULTS.md:60-66, :249-253):
# the sign of guided's mean less random's on it is read from a summary.
HEADLINE = {"2d": "flowoff_test_acc_modal_1", "3d": "flowoff_test_acc_modal_2"}


@functools.lru_cache(maxsize=4)
def _shuffles(size, samples, rng_seed):
    """``samples`` shuffles of ``range(size)``, one a row: row i is the
    order that the i-th ``rng.permutation`` call of the tools gives."""
    rng = np.random.default_rng(rng_seed)
    dtype = np.int8 if size < 128 else np.int32
    rows = [rng.permuted(np.tile(np.arange(size), (min(_CHUNK, samples - start), 1)), axis=1).astype(dtype)
            for start in range(0, samples, _CHUNK)]
    return np.concatenate(rows)


def _exact_assignments(size, n):
    """Blocks of (a's indices, the rest's indices), both ascending, over all
    C(size, n) assignments in ``itertools.combinations`` order."""
    combos = itertools.combinations(range(size), n)
    while True:
        block = np.array(list(itertools.islice(combos, _CHUNK)), dtype=np.int64).reshape(-1, n)
        if not len(block):
            return
        mask = np.zeros((len(block), size), bool)
        mask[np.arange(len(block))[:, None], block] = True
        yield block, np.nonzero(~mask)[1].reshape(len(block), size - n)


def permutation_pvalue(a, b, rng_seed=0):
    """Two-sided permutation test on |mean(a) - mean(b)|.

    Exact (all C(n0+n1, n0) assignments) when that count is feasible;
    otherwise Monte Carlo over label shuffles with the add-one estimator
    (count+1)/(total+1), which is a valid p-value for sampled tests
    (Phipson & Smyth 2010).  Returns (p, exact_flag): the tools' values."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    pooled = np.concatenate([a, b])
    observed = abs(a.mean() - b.mean())
    n = len(a)

    def count(first, rest):
        stat = np.abs(pooled[first].sum(axis=1) / n - pooled[rest].sum(axis=1) / (len(pooled) - n))
        return int((stat >= observed - 1e-12).sum())

    if comb(len(pooled), n) <= _EXACT_LIMIT:
        total = comb(len(pooled), n)
        return sum(count(first, rest) for first, rest in _exact_assignments(len(pooled), n)) / total, True

    order = _shuffles(len(pooled), _MC_SAMPLES, rng_seed)
    hits = sum(count(order[s:s + _CHUNK, :n], order[s:s + _CHUNK, n:]) for s in range(0, len(order), _CHUNK))
    return (hits + 1) / (_MC_SAMPLES + 1), False


def mann_whitney_u(a, b):
    """U statistic for 'a > b' with midranks; returns (U, AUC)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    u = sum(float((x > b).sum()) + 0.5 * float((x == b).sum()) for x in a)
    return u, u / (len(a) * len(b))


def holm(pvalues):
    """Holm's step-down adjusted p-values, in the order given."""
    p = np.asarray(pvalues, float)
    order = np.argsort(p, kind="stable")
    adjusted = np.minimum(1.0, np.maximum.accumulate((len(p) - np.arange(len(p))) * p[order]))
    out = np.empty_like(p)
    out[order] = adjusted
    return out.tolist()


def family(summary):
    """``3d`` when the summary's runs have a third modality, else ``2d``."""
    return "3d" if any("test_acc_modal_2" in v for v in summary.values()) else "2d"


def arm(summary, kind):
    """The arm's runs without an error, by name."""
    return {k: v for k, v in sorted(summary.items()) if k.startswith(kind + "_s") and "error" not in v}


def arm_values(summary, kind, metric):
    """The arm's values of ``metric``, runs without one left out."""
    return [r[metric] for r in arm(summary, kind).values() if r.get(metric) is not None]


def fmt(vals, nd=4):
    return ", ".join(f"{v:.{nd}g}" if isinstance(v, float) else str(v) for v in vals)


def arm_pairs(arms):
    """Ordered pairwise comparisons among the arms present."""
    return [(a, b) for i, a in enumerate(ARMS) for b in ARMS[i + 1:] if a in arms and b in arms]


def print_pairwise(vals, pairs):
    """Shared per-pair stat lines: permutation p + Mann-Whitney U/AUC."""
    for a, b in pairs:
        g, r = vals.get(a), vals.get(b)
        if not g or not r:
            continue
        p, exact = permutation_pvalue(g, r)
        u, auc = mann_whitney_u(g, r)
        kind = "exact" if exact else f"Monte Carlo ({_MC_SAMPLES:,} shuffles)"
        print(
            f"  {a} vs {b}: mean diff {np.mean(g) - np.mean(r):+.4g}; "
            f"{kind} permutation p = {p:.4g}; Mann-Whitney U = {u:.1f} (AUC {auc:.3f})"
        )


def _arms_present(summary):
    arms = {name: arm(summary, name) for name in ARMS}
    return {name: runs for name, runs in arms.items() if runs}


def report_2d(summary):
    """``tools/analyze_northstar.py``'s report."""
    arms = _arms_present(summary)
    print("runs: " + ", ".join(f"{len(r)} {n}" for n, r in arms.items()) + "\n")
    pairs = arm_pairs(arms)
    for label, key, better in (
        ("flow-off weak-modality test acc (conditional utilization)", "flowoff_test_acc_modal_1", "higher"),
        ("steps to 90% top-1", "steps_to_90_top1", "lower"),
        ("epochs to CompletedStopping", "epochs_run", "lower"),
        ("test top-1 @ best val", "test_acc", "higher"),
    ):
        vals = {name: [r[key] for r in runs.values() if r.get(key) is not None] for name, runs in arms.items()}
        if not any(vals.values()):
            continue
        dropped = {name: len(arms[name]) - len(vals[name]) for name in arms}
        if any(dropped.values()):
            # the test below is over survivors only, which biases it
            print(
                f"## {label}: WARNING — excluded runs with no value "
                f"({', '.join(f'{n} {d}' for n, d in dropped.items() if d)}); "
                f"statistics cover survivors only"
            )
        print(f"## {label}  ({better} is better)")
        for name, v in vals.items():
            if v:
                print(f"  {name} ({len(v)}): {fmt(sorted(v))}   mean {np.mean(v):.4g}")
        print_pairwise(vals, pairs)
        print()

    print("## per-run table (markdown)")
    print("| run | epochs | test top-1 @best-val | test weak @best-val (flow on) | final train weak | flow-off weak "
          "| steps→90% |")
    print("|---|---:|---:|---:|---:|---:|---:|")
    for name, r in [(n, r) for runs in arms.values() for n, r in runs.items()]:
        print(f"| {name.replace('_s', ' s')} | {r['epochs_run']} | {r['test_acc']:g} | "
              f"{r['test_acc_modal_1']:g} | {r['final_train_acc_modal_1']:.3g} | "
              f"{r['flowoff_test_acc_modal_1']:g} | {r['steps_to_90_top1']} |")


def _weak_mean(r):
    if "flowoff_test_acc_modal_1" in r and "flowoff_test_acc_modal_2" in r:
        return (r["flowoff_test_acc_modal_1"] + r["flowoff_test_acc_modal_2"]) / 2.0
    return None


def report_3d(summary):
    """``tools/analyze_northstar3d.py``'s report."""
    arms = _arms_present(summary)
    print("runs: " + ", ".join(f"{len(r)} {n}" for n, r in arms.items()) + "\n")
    comparisons = [
        ("flow-off depth (modality 1) test acc", "flowoff_test_acc_modal_1", "higher"),
        ("flow-off flow (modality 2) test acc", "flowoff_test_acc_modal_2", "higher"),
        ("flow-off mean weak-modality acc (1+2)/2", None, "higher"),
        ("epochs to CompletedStopping", "epochs_run", "lower"),
        ("test top-1 @ best val", "test_acc", "higher"),
        ("final train acc, flow (modality 2)", "final_train_acc_modal_2", "higher"),
    ]
    pairs = arm_pairs(arms)
    for label, key, better in comparisons:
        getter = _weak_mean if key is None else (lambda r, k=key: r.get(k))
        vals = {name: [v for v in (getter(r) for r in runs.values()) if v is not None] for name, runs in arms.items()}
        if not any(vals.values()):
            continue
        print(f"## {label}  ({better} is better)")
        for name, v in vals.items():
            if v:
                print(f"  {name} ({len(v)}): {fmt(sorted(v))}   mean {np.mean(v):.4g}")
        print_pairwise(vals, pairs)
        print()

    print("## per-run table (markdown)")
    print("| run | epochs | test top-1 | test m1/m2 @best-val (flow on) | flow-off m0 | flow-off m1 | flow-off m2 |")
    print("|---|---:|---:|---:|---:|---:|---:|")
    for name, r in [(n, r) for runs in arms.values() for n, r in runs.items()]:
        print(
            f"| {name.replace('_s', ' s')} | {r['epochs_run']} | {r['test_acc']:g} | "
            f"{r['test_acc_modal_1']:g} / {r['test_acc_modal_2']:g} | "
            f"{r['flowoff_test_acc_modal_0']:g} | {r['flowoff_test_acc_modal_1']:g} | "
            f"{r['flowoff_test_acc_modal_2']:g} |"
        )


def compare(port_summary, reference_summary, arms, metrics):
    """Each (arm, metric) of the port's runs against the reference's: one
    dict a comparison with both sides' n, mean, min and max, the two-sided
    permutation p of port against reference, the AUC of 'port > reference'
    and Holm's adjusted p over all the comparisons returned."""
    rows = []
    for kind in arms:
        for metric in metrics:
            port, ref = arm_values(port_summary, kind, metric), arm_values(reference_summary, kind, metric)
            p, exact = permutation_pvalue(port, ref)
            rows.append({
                "arm": kind, "metric": metric,
                **{f"{side}_{stat}": fn(vals) for side, vals in (("port", port), ("ref", ref))
                   for stat, fn in (("n", len), ("mean", lambda v: float(np.mean(v))),
                                    ("min", lambda v: float(min(v))), ("max", lambda v: float(max(v))))},
                "p": p, "exact": exact, "auc": mann_whitney_u(port, ref)[1],
            })
    for row, adjusted in zip(rows, holm([r["p"] for r in rows])):
        row["holm_p"] = adjusted
    return rows


def headline(summary, fam):
    """The family's headline contrast on one summary: (guided's mean less
    random's, the permutation p of guided against random)."""
    g, r = arm_values(summary, "guided", HEADLINE[fam]), arm_values(summary, "random", HEADLINE[fam])
    return float(np.mean(g) - np.mean(r)), permutation_pvalue(g, r)[0]


def print_compare(rows):
    print("| arm | metric | port mean (min-max), n | reference mean (min-max), n | p | Holm p | AUC |")
    print("|---|---|---|---|---:|---:|---:|")
    for r in rows:
        print(f"| {r['arm']} | {r['metric']} | {r['port_mean']:.4g} ({r['port_min']:.4g}-{r['port_max']:.4g}), "
              f"{r['port_n']} | {r['ref_mean']:.4g} ({r['ref_min']:.4g}-{r['ref_max']:.4g}), {r['ref_n']} | "
              f"{r['p']:.4g}{'' if r['exact'] else ' (MC)'} | {r['holm_p']:.4g} | {r['auc']:.3f} |")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("summary")
    ap.add_argument("--reference", help="a summary of the same family to compare the arms both hold against")
    args = ap.parse_args(argv)
    with open(args.summary) as f:
        summary = json.load(f)
    fam = family(summary)
    (report_3d if fam == "3d" else report_2d)(summary)
    if args.reference:
        with open(args.reference) as f:
            reference = json.load(f)
        arms = [a for a in ARMS if arm(summary, a) and arm(reference, a)]
        print(f"\n## port against reference ({fam}; Holm over {len(arms) * len(METRICS[fam])} comparisons)")
        print_compare(compare(summary, reference, arms, METRICS[fam]))
        if {"guided", "random"} <= set(arms):
            for name, s in (("port", summary), ("reference", reference)):
                diff, p = headline(s, fam)
                print(f"  headline {HEADLINE[fam]}, guided - random on the {name}: {diff:+.4g} (permutation p {p:.4g})")


if __name__ == "__main__":
    main()
