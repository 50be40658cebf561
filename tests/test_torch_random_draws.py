"""Which curation draws each committed random-arm run made, and what they
decide (CPU, numpy and the port's controller, no device, no training).

The random controller splits its key and draws a mode every train step
(``engine/controller.py::random_update``); the val and test passes that
end an epoch run under the flags of that epoch's last draw
(``tests/test_torch_eval_curation.py``).  For 2-D random, mode 1 curates
modality 1, whose gate then becomes the running average of modality 0's
(``bug_compat``), and the epoch's ``val_acc_modal_1`` falls.  Replaying
the draws from a key therefore names the key a run drew from:

* **Draw provenance.**  From epoch ``FROM_EPOCH`` on, count the epoch ends
  where "modality ``m`` curated at the end" and "``val_acc_modal_m`` under
  ``VAL_CUT``" agree, under ``PRNGKey(seed)`` and under ``PRNGKey(0)``; the
  key with more agreements explains the run (m = 1 in 2-D; in 3-D m = 2,
  flow, the modality whose val accuracy shows its curation).  Six JAX 2-D
  random runs follow ``PRNGKey(0)``: s777 and s1234 (a200fb1), s2024 and
  s31337 (bcc107b), s424242 and s555 (729289c) predate 29d4fa5, which made
  ``reset_controller`` keep the configured key instead of reseeding to key
  0 (``greedy_multimodal_learning_tpu/engine/framework.py:174-187``).
  Every other run, JAX and port, 2-D and 3-D, follows its seed's key.
* **The collapse rule.**  Every val pass of a 2-D run reaches 100% at
  several epoch ends and the drivers take the first (``summarize_history``,
  ``argmax_first``), so a run reports a low ``test_acc_modal_1`` exactly
  when that epoch ended on a draw that curates modality 1.
* **The same-draw comparison.**  The port's four 2-D random draws at the
  12 seeds whose JAX runs drew from the seed key, held against those JAX
  runs by ``experiments/analyze.py::compare``.  The criterion was set
  before the comparison was made: the primary comparison is
  ``test_acc_modal_1``, the four draws pooled (48 runs) against the 12
  JAX runs; at p >= 0.05, with the eval test passing, ROADMAP Queue C 1
  closes.

The replay uses the port's ``prng`` and ``random_update``; it is held
against ``jax.random`` through the JAX package's controller at one seed
over a whole run's steps.  Steps an epoch are the drivers' own split
arithmetic (``experiments/northstar.py::train_steps``) on their corpora."""

import dataclasses
import functools
import os

import numpy as np
import pytest
from scipy.stats import fisher_exact

import jax
import jax.numpy as jnp
import torch

from greedy_multimodal_learning_tpu.engine import controller as jax_controller
from greedy_multimodal_learning_tpu_torch.engine import controller
from greedy_multimodal_learning_tpu_torch.experiments import analyze, imbalanced_modelnet, northstar, northstar3d
from greedy_multimodal_learning_tpu_torch.experiments.common import read_history
from greedy_multimodal_learning_tpu_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# family: (modalities, steps an epoch, the modality whose val accuracy shows its curation, summary file, dirs)
FAMILIES = {
    "2d": (2, northstar.train_steps(imbalanced_modelnet.N_TRAIN), 1, "northstar_summary.json",
           ("northstar", "northstar_torch", "northstar_torch_default_rerun", "northstar_torch_highest",
            "northstar_torch_high")),
    "3d": (3, northstar.train_steps(northstar3d.N_TRAIN), 2, "northstar3d_summary.json",
           ("northstar3d", "northstar3d_torch")),
}
JAX_DIRS = {"northstar", "northstar3d"}
STARTING_EPOCH = 2  # Bias_Mitigation_Random unlocks the controller here
FROM_EPOCH = 9  # the epoch ends counted: the val accuracies have settled
VAL_CUT = 60.0  # a val accuracy under this at an epoch end: the modality was curated
COLLAPSE_CUT = 40.0  # test_acc_modal_1 under this: the run dropped its weak view
# JAX 2-D random runs made before 29d4fa5: they drew from PRNGKey(0)
KEY_0 = {555, 777, 1234, 2024, 31337, 424242}
MAX_EPOCHS = 40  # more than any committed random run holds
# The one 2-D run whose selected epoch ends on a curated modality 1 and
# whose test_acc_modal_1 is not under 40: it is 40.0, on the cut.
ON_THE_CUT = ("northstar_torch_default_rerun", "random_s555")
ALPHA = 0.05
# The same-draw comparison, as PERF.md §6 and ROADMAP Queue C 1 report it
# (permutation p to 4 places; 400,000 shuffles pooled, exact per draw):
PRIMARY = (48, 17, 12, 1, 0.0904)  # port runs, under 40; JAX runs, under 40; p
PRIMARY_FISHER = 0.0862
FLOWOFF_P = 0.3704
PER_DRAW = {"northstar_torch": (7, 0.0215, 0.0272), "northstar_torch_default_rerun": (3, 0.2405, 0.5901),
            "northstar_torch_highest": (4, 0.2849, 0.3168), "northstar_torch_high": (3, 0.4726, 0.5901)}
# the four draws at all 18 seeds: 19 of 72 under 40 against 1 of 18
ALL_SEEDS_FISHER = 0.0643
# the epoch ends 7-15 of the 12 same-draw seeds that curate modality 1 (the
# same 38 in every draw: the same keys) and how many of them reach a
# val_acc of 100, by draw; the four port draws pooled against JAX: Fisher p
VAL_100 = {"northstar": (38, 5), "northstar_torch": (38, 12), "northstar_torch_default_rerun": (38, 6),
           "northstar_torch_highest": (38, 9), "northstar_torch_high": (38, 11)}
VAL_100_FISHER = 0.1344


@functools.lru_cache(maxsize=None)
def epoch_end_draws(key_seed, steps, num_modalities):
    """The (curation_mode, caring_modality) the random controller holds
    after the last train step of each of ``MAX_EPOCHS`` epochs of
    ``steps`` steps from ``PRNGKey(key_seed)``: the key moves over an
    epoch's other steps (``prng.key_chain``), then ``random_update`` makes
    the last step's draw, unlocked from ``STARTING_EPOCH`` on."""
    key = prng.PRNGKey(key_seed)
    state = controller.init_controller_state(num_modalities)
    out = []
    for epoch in range(1, MAX_EPOCHS + 1):
        state = dataclasses.replace(state, rng=controller.key_tensor(prng.key_chain(key, steps - 1)))
        state = controller.random_update(state, None, None, torch.tensor(epoch >= STARTING_EPOCH),
                                         num_modalities=num_modalities)
        key = controller.key_array(state.rng)
        out.append((bool(state.curation_mode), int(state.caring_modality)))
    return tuple(out)


def curated(key_seed, family, modality, epochs):
    """Whether ``modality`` was curated at each of ``epochs`` epoch ends."""
    n, steps = FAMILIES[family][:2]
    return [mode and caring == modality for mode, caring in epoch_end_draws(key_seed, steps, n)[:epochs]]


@functools.lru_cache(maxsize=None)
def runs(family):
    """{(dir, run name): (seed, history, summary entry)} of every committed
    random run of the family."""
    out = {}
    _, _, _, summary_name, dirs = FAMILIES[family]
    for directory in dirs:
        summary = analyze.load_summary(os.path.join(REPO, "results", directory, summary_name))
        for name, entry in analyze.arm(summary, "random").items():
            history = read_history(os.path.join(REPO, "results", directory, f"{name}_history.csv"))
            out[directory, name] = (int(name.split("_s", 1)[1]), history, entry)
    return out


def agreements(key_seed, family, history):
    """Epoch ends from ``FROM_EPOCH`` on where the family's shown modality
    curated and its val accuracy under ``VAL_CUT`` agree, and how many
    epoch ends were counted."""
    m = FAMILIES[family][2]
    low = [v < VAL_CUT for v in history[f"val_acc_modal_{m}"]]
    drawn = curated(key_seed, family, m, len(low))
    counted = range(FROM_EPOCH - 1, len(low))
    return sum(drawn[i] == low[i] for i in counted), len(counted)


def drawn_from(seed, family, history):
    """The key seed that explains the run (the seed or 0), the agreements
    under the seed's key and under key 0, and the epoch ends counted."""
    (own, counted), (other, _) = agreements(seed, family, history), agreements(0, family, history)
    return (seed if own > other else 0), own, other, counted


@pytest.mark.parametrize("num_modalities, steps, epochs, seed", [(2, 120, 30, 777), (3, 40, 36, 7)])
def test_the_replay_is_the_jax_controllers(num_modalities, steps, epochs, seed):
    """The port's draws at every step of a whole run (the longest of the
    family's) are those of the JAX package's ``random_update`` from
    ``jax.random.PRNGKey(seed)``, and the epoch-end replay picks their
    epochs' last draws."""
    total = steps * epochs
    unlock = jnp.arange(total) // steps + 1 >= STARTING_EPOCH

    def body(state, unlocked):
        state = jax_controller.random_update(state, None, None, unlocked, num_modalities=num_modalities)
        return state, (state.curation_mode, state.caring_modality)

    _, (mode, caring) = jax.jit(lambda s: jax.lax.scan(body, s, unlock))(
        jax_controller.init_controller_state(num_modalities, seed))
    want = list(zip(np.asarray(mode).tolist(), np.asarray(caring).tolist()))

    state, got = controller.init_controller_state(num_modalities, seed=seed), []
    for step in range(total):
        state = controller.random_update(state, None, None, torch.tensor(bool(unlock[step])),
                                         num_modalities=num_modalities)
        got.append((bool(state.curation_mode), int(state.caring_modality)))
    assert got == want
    assert list(epoch_end_draws(seed, steps, num_modalities)[:epochs]) == want[steps - 1::steps]
    assert sum(m for m, _ in want) > total // 2  # the draws curate about 2 steps of 3


def test_the_split_arithmetic_gives_the_drivers_steps():
    """120 steps an epoch in 2-D (1,200 train models, 240 to val, batch
    8) and 40 in 3-D (400 clips, 80 to val)."""
    assert (FAMILIES["2d"][1], FAMILIES["3d"][1]) == (120, 40)
    assert northstar.train_steps(10) == 1 and northstar.train_steps(11) == 2


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_each_run_follows_its_key(family):
    """Every committed random run is explained by one key: ``PRNGKey(0)``
    for the six JAX 2-D runs made before 29d4fa5, ``PRNGKey(seed)`` for
    every other, JAX and port; the key explains most of the run's epoch
    ends, and more of them than the other key does."""
    found, worst = {}, 1.0
    for (directory, name), (seed, history, _) in runs(family).items():
        key, own, other, counted = drawn_from(seed, family, history)
        found[directory, name] = key
        best = max(own, other)
        worst = min(worst, best / counted)
        print(f"{directory} {name}: key {key}, agree {own} (seed) / {other} (key 0) of {counted}")
    assert len(found) == 18 * len(FAMILIES[family][4])
    expected = {run: 0 if run[0] == "northstar" and int(run[1].split("_s")[1]) in KEY_0
                else int(run[1].split("_s")[1]) for run in found}
    assert found == expected
    assert worst >= 0.8, worst


def test_flow_shows_the_3d_curation():
    """In 3-D (mode m curates modality m - 1, no ``bug_compat``), only
    flow's val accuracy shows its curation: at the epoch ends from
    ``FROM_EPOCH`` on that curate flow its mean val accuracy is more than
    50 points under its mean elsewhere; RGB's and depth's drop under 15
    points at their own."""
    drops = {}
    for m in range(3):
        at, elsewhere = [], []
        for (_, _), (seed, history, _) in runs("3d").items():
            vals = history[f"val_acc_modal_{m}"]
            for i, c in enumerate(curated(seed, "3d", m, len(vals))):
                if i >= FROM_EPOCH - 1:
                    (at if c else elsewhere).append(vals[i])
        drops[m] = float(np.mean(elsewhere) - np.mean(at))
    print("3-D val accuracy drop at the epoch ends curating each modality:", drops)
    assert drops[2] > 50.0 and drops[0] < 15.0 and drops[1] < 15.0, drops


def test_a_2d_run_collapses_when_its_selected_epoch_curates_modality_1():
    """For every committed 2-D random run: the summary's selection is the
    history's first epoch of the largest ``val_acc``
    (``northstar.summarize_history``), and ``test_acc_modal_1`` there is
    under ``COLLAPSE_CUT`` exactly when that epoch ended curating modality
    1 under the run's key.  One run breaks the rule, ``ON_THE_CUT``: it
    ended so and its ``test_acc_modal_1`` is 40.0, on the cut."""
    exceptions, collapsed = [], 0
    for (directory, name), (seed, history, entry) in runs("2d").items():
        mine = northstar.summarize_history(history, FAMILIES["2d"][1])
        for key in ("best_val_epoch", "best_val_acc", "test_acc_modal_1"):
            assert mine[key] == entry[key], (directory, name, key)
        assert mine["best_val_acc"] == 100.0
        key = drawn_from(seed, "2d", history)[0]
        i = mine["best_val_epoch"] - 1
        low = mine["test_acc_modal_1"] < COLLAPSE_CUT
        collapsed += low
        if curated(key, "2d", 1, len(history["epoch"]))[i] != low:
            exceptions.append((directory, name))
    assert exceptions == [ON_THE_CUT]
    assert runs("2d")[ON_THE_CUT][2]["test_acc_modal_1"] == COLLAPSE_CUT
    assert collapsed == 1 + 19  # JAX s42; the port's 19 of 72


def _same_draw(entries):
    """The random runs of ``entries`` at the seeds whose JAX runs drew from
    the seed key."""
    return {name: v for name, v in analyze.arm(entries, "random").items() if int(name.split("_s", 1)[1]) not in KEY_0}


def _under(entries):
    return sum(v < COLLAPSE_CUT for v in analyze.arm_values(entries, "random", "test_acc_modal_1"))


def test_the_same_draw_comparison():
    """Queue C 1's criterion: the four port draws at the 12 seeds of the
    JAX runs that drew from the seed key, pooled, against those runs,
    ``test_acc_modal_1`` (primary), then ``flowoff_test_acc_modal_1``; each
    draw alone; collapse counts with Fisher's exact p (two-sided).  The
    primary p is at least 0.05 and ``tests/test_torch_eval_curation.py``
    finds the port's eval under curation to be the JAX package's: Queue C
    1 closes."""
    _, _, _, summary_name, dirs = FAMILIES["2d"]
    summaries = {d: analyze.load_summary(os.path.join(REPO, "results", d, summary_name)) for d in dirs}
    jax_runs = _same_draw(summaries["northstar"])
    draws = {d: _same_draw(summaries[d]) for d in dirs if d not in JAX_DIRS}
    pooled = {f"{name}_{d}": v for d, entries in draws.items() for name, v in entries.items()}
    rows = analyze.compare(pooled, jax_runs, ["random"], ["test_acc_modal_1", "flowoff_test_acc_modal_1"])
    analyze.print_compare(rows)
    primary, flowoff = rows
    n_port, n_jax = len(pooled), len(jax_runs)
    under_port, under_jax = _under(pooled), _under(jax_runs)
    fisher = fisher_exact([[under_port, n_port - under_port], [under_jax, n_jax - under_jax]])[1]
    print(f"pooled: {under_port} of {n_port} under 40 against {under_jax} of {n_jax}, Fisher p {fisher:.4f}")
    assert (n_port, under_port, n_jax, under_jax, round(primary["p"], 4)) == PRIMARY
    assert (primary["port_n"], primary["ref_n"]) == (n_port, n_jax)
    assert round(fisher, 4) == PRIMARY_FISHER
    assert round(flowoff["p"], 4) == FLOWOFF_P
    for d, entries in draws.items():
        row = analyze.compare(entries, jax_runs, ["random"], ["test_acc_modal_1"])[0]
        assert row["exact"] and row["port_n"] == 12
        u = _under(entries)
        p = fisher_exact([[u, 12 - u], [under_jax, n_jax - under_jax]])[1]
        print(f"{d}: mean {row['port_mean']:.4g}, p {row['p']:.4f}; {u} of 12 under 40, Fisher p {p:.4f}")
        assert (u, round(row["p"], 4), round(p, 4)) == PER_DRAW[d]
    all_port = [v for d in draws for v in analyze.arm_values(summaries[d], "random", "test_acc_modal_1")]
    every_seed = sum(v < COLLAPSE_CUT for v in all_port)
    all_jax = _under(summaries["northstar"])
    assert (every_seed, len(all_port), all_jax) == (19, 72, 1)
    assert round(fisher_exact([[every_seed, 72 - every_seed], [all_jax, 18 - all_jax]])[1], 4) == ALL_SEEDS_FISHER
    assert primary["p"] >= ALPHA  # the criterion: Queue C 1 closes


def test_how_often_a_val_pass_under_curation_reaches_100():
    """At the epoch ends 7-15 that curate modality 1, how often the val
    pass still reaches 100% (the rate that decides how often the first
    best epoch is such an end), by draw at the 12 same-draw seeds."""
    found = {}
    for (directory, name), (seed, history, _) in runs("2d").items():
        if seed in KEY_0:
            continue
        ends = [i for i, c in enumerate(curated(seed, "2d", 1, len(history["epoch"]))) if c and 6 <= i <= 14]
        of, reached = found.get(directory, (0, 0))
        found[directory] = (of + len(ends), reached + sum(history["val_acc"][i] == 100.0 for i in ends))
    print({d: (of, reached, round(reached / of, 3)) for d, (of, reached) in found.items()})
    assert found == VAL_100
    of, reached = (sum(v[i] for d, v in found.items() if d not in JAX_DIRS) for i in (0, 1))
    jax_of, jax_reached = found["northstar"]
    p = fisher_exact([[reached, of - reached], [jax_reached, jax_of - jax_reached]])[1]
    print(f"pooled: {reached} of {of} against {jax_reached} of {jax_of}, Fisher p {p:.4f}")
    assert round(p, 4) == VAL_100_FISHER


def test_combinations_are_itertools_order():
    """``analyze``'s exact test enumerates the assignments as
    ``itertools.combinations`` does."""
    import itertools

    for size, n in ((5, 2), (7, 3), (9, 9), (6, 1), (12, 6)):
        want = np.array(list(itertools.combinations(range(size), n))).reshape(-1, n)
        np.testing.assert_array_equal(analyze._combinations(size, n), want)
