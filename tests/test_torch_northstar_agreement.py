"""The port's run-level experiment against the JAX package's (CPU, numpy
only, no device): the committed port summaries (``results/northstar_torch/``,
``results/northstar3d_torch/``: the suites on the card) hold the guided and
random arms at the JAX summaries' own seeds; ``experiments/analyze.py``'s
statistics are those of ``tools/analyze_northstar*.py``; no metric of
either arm differs from the JAX runs (Holm over the family's comparisons);
and the headline contrast keeps the JAX runs' sign on the port."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

from greedy_multimodal_learning_tpu_torch.experiments import analyze, shard_check, shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
# family: (JAX results dir, port results dir, summary file, the tool that reports it)
FAMILIES = {
    "2d": ("northstar", "northstar_torch", "northstar_summary.json", "analyze_northstar.py"),
    "3d": ("northstar3d", "northstar3d_torch", "northstar3d_summary.json", "analyze_northstar3d.py"),
}
ARMS = ("guided", "random")
ALPHA = 0.05
# The metrics whose pairwise p and AUC the family's report prints (held
# against the tool's text by test_report_is_the_tools).
REPORTED = {"2d": {"flowoff_test_acc_modal_1", "steps_to_90_top1", "epochs_run", "test_acc"},
            "3d": {"flowoff_test_acc_modal_1", "flowoff_test_acc_modal_2", "epochs_run", "test_acc",
                   "final_train_acc_modal_2"}}


def summary(family, side):
    jax_dir, port_dir, name, _ = FAMILIES[family]
    with open(os.path.join(REPO, "results", jax_dir if side == "jax" else port_dir, name)) as f:
        return json.load(f)


def seeds(entries, kind):
    return {int(name.split("_s", 1)[1]) for name in entries if name.startswith(kind + "_s")}


@contextlib.contextmanager
def tool(filename, mc_samples):
    """``tools/<filename>`` loaded as a module, its (and ``analyze_northstar``'s)
    Monte Carlo shuffle count set to ``mc_samples``; ``sys.path`` and
    ``sys.modules`` as they were afterwards."""
    saved_path, saved_mod = list(sys.path), sys.modules.get("analyze_northstar")
    try:
        sys.path.insert(0, TOOLS)
        modules = {}
        for name in ("analyze_northstar", filename[:-3]):
            if name not in modules:
                spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, name + ".py"))
                modules[name] = importlib.util.module_from_spec(spec)
                sys.modules[name] = modules[name]
                spec.loader.exec_module(modules[name])
        modules["analyze_northstar"]._MC_SAMPLES = mc_samples
        yield modules
    finally:
        sys.path[:] = saved_path
        sys.modules.pop(filename[:-3], None)
        if saved_mod is None:
            sys.modules.pop("analyze_northstar", None)
        else:
            sys.modules["analyze_northstar"] = saved_mod


@pytest.fixture
def small_chunks(monkeypatch):
    """analyze's shuffles and exact assignments in blocks of 64, so that a
    few hundred of them cross several block boundaries of the stream."""
    monkeypatch.setattr(analyze, "_CHUNK", 64)
    analyze._shuffles.cache_clear()
    yield
    analyze._shuffles.cache_clear()


@pytest.fixture(scope="module")
def comparisons():
    """``analyze.compare`` of each family's port summary against its JAX
    summary, guided and random, Holm over the family's comparisons."""
    return {fam: analyze.compare(summary(fam, "port"), summary(fam, "jax"), ARMS, analyze.METRICS[fam])
            for fam in FAMILIES}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_summary_holds_the_jax_seeds(family):
    """Every guided and random seed of the JAX summary, nothing else, no
    error, and each run's histories committed beside the summary."""
    jax, port = summary(family, "jax"), summary(family, "port")
    for kind in ARMS:
        assert seeds(port, kind) == seeds(jax, kind), kind
    assert set(port) == {name for name in jax if name.split("_s", 1)[0] in ARMS}
    assert not {name: e for name, e in port.items() if "error" in e}
    out = os.path.join(REPO, "results", FAMILIES[family][1])
    for name in port:
        for suffix in ("_history.csv", "_flowoff_history.csv"):
            assert os.path.exists(os.path.join(out, name + suffix)), name + suffix
    with open(os.path.join(out, "device.txt")) as f:
        assert "H100" in f.read()


def _pairs():
    out = []
    for fam in sorted(FAMILIES):
        jax = summary(fam, "jax")
        out += [(fam, a, b) for a, b in analyze.arm_pairs([k for k in analyze.ARMS if analyze.arm(jax, k)])]
    return out


@pytest.mark.parametrize("family,first,second", _pairs())
def test_statistics_are_the_tools(family, first, second, small_chunks, monkeypatch):
    """On the JAX summary, each pair of arms and metric: the permutation p
    over their first 5 and 6 runs (exact, 462 assignments in blocks of 64)
    and the U and AUC equal the tools'; so does the p over the whole arms
    (Monte Carlo, 200 shuffles in blocks of 64 in analyze) for the metrics
    whose pairwise lines the report test does not already hold."""
    jax = summary(family, "jax")
    monkeypatch.setattr(analyze, "_MC_SAMPLES", 200)
    with tool(FAMILIES[family][3], 200) as modules:
        ref = modules["analyze_northstar"]
        for metric in analyze.METRICS[family] + ("final_train_acc_modal_1",):
            a, b = analyze.arm_values(jax, first, metric), analyze.arm_values(jax, second, metric)
            for x, y in ((a, b), (a[:5], b[:6])):
                assert analyze.mann_whitney_u(x, y) == ref.mann_whitney_u(x, y), metric
            assert analyze.permutation_pvalue(a[:5], b[:6]) == ref.permutation_pvalue(a[:5], b[:6]), metric
            assert analyze.permutation_pvalue(a[:5], b[:6])[1]
            if metric not in REPORTED[family]:
                p = analyze.permutation_pvalue(a, b)
                assert p == ref.permutation_pvalue(a, b) and not p[1], metric


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_report_is_the_tools(family, small_chunks, monkeypatch):
    """The family's report of the JAX summary prints the tool's text, line
    for line (500 shuffles in both, in blocks of 64 in analyze)."""
    _, _, name, filename = FAMILIES[family]
    path = os.path.join(REPO, "results", FAMILIES[family][0], name)
    monkeypatch.setattr(analyze, "_MC_SAMPLES", 500)
    monkeypatch.setattr(sys, "argv", [filename, path])
    with tool(filename, 500) as modules:
        want = io.StringIO()
        with contextlib.redirect_stdout(want):
            modules[filename[:-3]].main()
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        analyze.main([path])
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("family,kind", [(f, k) for f in sorted(FAMILIES) for k in ARMS])
def test_port_agrees_with_the_jax_runs(family, kind, comparisons):
    """Every metric of the arm: the port's runs against the JAX runs of the
    same seeds, Holm-adjusted p at least 0.05."""
    rows = [r for r in comparisons[family] if r["arm"] == kind]
    assert [r["metric"] for r in rows] == list(analyze.METRICS[family])
    assert len(comparisons[family]) == len(ARMS) * len(analyze.METRICS[family])
    for r in rows:
        assert r["port_n"] > 0 and r["holm_p"] >= ALPHA, r


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_headline_contrast_keeps_the_jax_sign(family):
    """Guided's mean less random's on the family's headline metric has the
    sign that the JAX runs show (read from the JAX summary)."""
    jax_diff, _ = analyze.headline(summary(family, "jax"), family)
    port_diff, _ = analyze.headline(summary(family, "port"), family)
    assert jax_diff != 0
    assert np.sign(port_diff) == np.sign(jax_diff), (port_diff, jax_diff)


def test_holm_adjusts_step_down():
    """Sorted p times (m, m-1, ...), made monotone, capped at 1, in the
    order given."""
    assert analyze.holm([0.04, 0.01, 0.03, 0.5]) == pytest.approx([0.09, 0.04, 0.09, 0.5])
    assert analyze.holm([0.2, 0.2]) == [0.4, 0.4]
    assert analyze.holm([0.9, 0.6]) == [1.0, 1.0]


def test_compare_rows_and_cli(tmp_path, capsys):
    """``compare`` gives each side's n, mean, min and max, the p, AUC and
    Holm p; the CLI with ``--reference`` prints its table and the headline
    of both summaries."""
    rng = np.random.default_rng(0)
    port, ref = {}, {}
    for side, shift in ((port, 0.0), (ref, 5.0)):
        for kind in ARMS:
            for seed in range(5):
                side[f"{kind}_s{seed}"] = {m: float(rng.normal(50 + shift)) for m in analyze.METRICS["2d"]}
                side[f"{kind}_s{seed}"].update(final_train_acc_modal_1=1.0, flowoff_test_acc_modal_0=1.0)
    rows = analyze.compare(port, ref, ARMS, ("test_acc", "epochs_run"))
    assert [(r["arm"], r["metric"]) for r in rows] == [(k, m) for k in ARMS for m in ("test_acc", "epochs_run")]
    for r in rows:
        vals = analyze.arm_values(port, r["arm"], r["metric"])
        assert (r["port_n"], r["port_mean"], r["port_min"], r["port_max"]) == (5, np.mean(vals), min(vals), max(vals))
        assert r["exact"] and r["p"] == pytest.approx(2 / 252)  # every port value under every reference value
        assert r["auc"] == 0.0 and r["holm_p"] == pytest.approx(4 * 2 / 252)
    paths = []
    for name, s in (("port", port), ("ref", ref)):
        paths.append(tmp_path / f"{name}.json")
        paths[-1].write_text(json.dumps(s))
    analyze.main([str(paths[0]), "--reference", str(paths[1])])
    out = capsys.readouterr().out
    assert "## port against reference (2d; Holm over 12 comparisons)" in out
    assert out.count("| guided | ") == 6 and out.count("| random | ") == 6
    assert out.count("headline flowoff_test_acc_modal_1") == 2


def _fake_shard(root, entries, family="2d"):
    os.makedirs(root)
    with open(os.path.join(root, shards.FAMILIES[family].SUMMARY), "w") as f:
        json.dump(entries, f)
    with open(os.path.join(root, "driver.log"), "w") as f:
        f.write(f"log of {os.path.basename(root)}\n")
    for name in entries:
        os.makedirs(os.path.join(root, name, "mmtm_off_eval", "eval_history_batch"))
        for rel in ("history.csv", os.path.join("mmtm_off_eval", "eval_history_batch", "history.csv")):
            with open(os.path.join(root, name, rel), "w") as f:
                f.write(f"{name} {rel}\n")


def test_merge_shards_unions_the_summaries(tmp_path):
    """``shards.merge_shards`` keeps what the output held, adds each shard's
    runs with their histories and each shard's driver log, and refuses a run
    that two sources hold differently."""
    out = tmp_path / "out"
    out.mkdir()
    (out / "northstar_summary.json").write_text(json.dumps({"guided_s1": {"test_acc": 1.0}}))
    (out / "device.txt").write_text("card\n")
    _fake_shard(str(tmp_path / "root" / "shard0"), {"guided_s2": {"test_acc": 2.0}})
    (tmp_path / "root" / "device.txt").write_text("card\nswitches\n")
    (tmp_path / "root" / "shards.log").write_text("0.0s start\n")
    _fake_shard(str(tmp_path / "root" / "shard1"), {"random_s1": {"test_acc": 3.0}, "guided_s1": {"test_acc": 1.0}})
    merged = shards.merge_shards("2d", str(out), [str(tmp_path / "root" / f"shard{k}") for k in range(2)])
    assert list(merged) == ["guided_s1", "guided_s2", "random_s1"]
    assert json.loads((out / "northstar_summary.json").read_text()) == merged
    assert (out / "random_s1_flowoff_history.csv").read_text() == (
        "random_s1 " + os.path.join("mmtm_off_eval", "eval_history_batch", "history.csv") + "\n")
    assert (out / "guided_s2_history.csv").read_text() == "guided_s2 history.csv\n"
    assert (out / "driver_root_shard1.log").read_text() == "log of shard1\n"
    assert (out / "device.txt").read_text() == "card\nswitches\n"
    assert (out / "shards_root.log").read_text() == "0.0s start\n"
    _fake_shard(str(tmp_path / "root" / "shard2"), {"guided_s2": {"test_acc": 9.0}})
    with pytest.raises(ValueError, match="guided_s2"):
        shards.merge_shards("2d", str(out), [str(tmp_path / "root" / "shard2")])


def test_plan_runs_takes_the_reference_seeds(tmp_path):
    """``--seeds-of`` gives each arm the seeds a summary holds it at,
    ascending, arm by arm; ``--skip`` leaves out the runs another summary
    holds without an error."""
    ref, done = tmp_path / "ref.json", tmp_path / "done.json"
    ref.write_text(json.dumps({"guided_s9": {}, "guided_s3": {}, "random_s3": {}, "random_s12": {},
                               "weakest_s3": {}}))
    done.write_text(json.dumps({"random_s3": {}, "guided_s9": {"error": "train rc=1"}}))
    assert shards.plan_runs(["random", "guided"], seeds_of=str(ref), skip=str(done)) == [
        ("random", 12), ("guided", 3), ("guided", 9)]
    assert shards.plan_runs(["guided"], seeds=[5, 1]) == [("guided", 1), ("guided", 5)]


def test_compare_histories_leaves_out_timing():
    """``shard_check.compare_histories``: equal but for the timing columns
    is identical; a changed value gives its column's largest difference;
    NaN against NaN is equal; another epoch count is not identical."""
    a = {"epoch": [1.0, 2.0], "time": [3.0, 4.0], "loss": [0.5, float("nan")], "acc": [10.0, 20.0]}
    b = dict(a, time=[9.0, 9.0], epoch_begin_time=[1.0, 2.0])
    b.pop("epoch_begin_time")
    same = shard_check.compare_histories(a, b)
    assert same["identical"] and same["max_abs_diff"] == {"epoch": 0.0, "loss": 0.0, "acc": 0.0}
    other = shard_check.compare_histories(a, dict(a, acc=[10.0, 20.25]))
    assert not other["identical"] and other["max_abs_diff"]["acc"] == 0.25
    short = shard_check.compare_histories(a, {k: v[:1] for k, v in a.items()})
    assert not short["identical"] and short["epochs"] == [2, 1]


def test_committed_shard_check_is_identical():
    """``results/northstar_torch/shard_check.json`` (the card's run of
    ``shard_check``): every train process ended with rc 0, its history equal
    to the first alone run's in every column but the timings, alone under
    the host's threads and side by side at one thread each, under the TF32
    switches that the suites' ``device.txt`` records."""
    with open(os.path.join(REPO, "results", "northstar_torch", "shard_check.json")) as f:
        report = json.load(f)
    assert (report["arm"], report["seed"]) == (shard_check.ARM, shard_check.SEED)
    runs = report["runs"]
    assert set(runs) == {"alone0", "alone1"} | {f"side{k}" for k in range(shard_check.SIDE_BY_SIDE)}
    with open(os.path.join(REPO, "results", "northstar_torch", "device.txt")) as f:
        device = f.read()
    for name, r in runs.items():
        assert r["rc"] == 0 and r["against_alone0"]["identical"], name
        switches = r["switches"]
        assert switches["cudnn.deterministic"], name
        assert (switches["OMP_NUM_THREADS"] == "1") == name.startswith("side"), name
        assert (f"torch.backends.cudnn.allow_tf32={switches['cudnn.allow_tf32']}, "
                f"torch.backends.cuda.matmul.allow_tf32={switches['cuda.matmul.allow_tf32']}") in device, name
