"""BENCHMARK.json against the benchmark's contract, and the harness finding
each cell's files by name; a configuration, a traffic mix and a metric
added as new files and entries are found without editing a file."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import bench

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        assert len({e["name"] for e in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for w in m["workloads"]:
            assert _applies(e2e[m["moves"]], w)
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in SPEC["end_to_end"] if _applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(_applies(m, w["name"]) for m in SPEC["per_layer"])


def _applies(entry, workload):
    return "workloads" not in entry or workload in entry["workloads"]


def test_configs_hold_what_they_state():
    for c in SPEC["configs"]:
        config = json.loads((REPO / c["file"]).read_text())
        assert config["name"] == c["name"] and config["reduced"] == c["reduced"]
        assert c["file"].startswith("portbench/") and not config["tf32"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size")) and "width" not in key


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files(name):
    cell = bench.find_cell(name)
    assert cell.family.arch(cell.config).towers >= 2
    assert hasattr(cell.driver, "Session")
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert set(cell.limits) == set(_numbers(cell.traffic["kind"]))


def _numbers(kind):
    if kind == "train":
        start = {"loss_gap", "grad_gap", "change_gap", "buffer_gap", "decisions_differ"}
        return start | {f"window_{n}" for n in ("loss_gap", "grad_gap", "buffer_gap", "decisions_differ")}
    return {"rows_missing", "logit_gap", "prob_gap"}


def test_new_config_traffic_and_metric_are_found_from_new_files(tmp_path):
    """A later change adds files and entries only: the copy's harness finds
    them by name."""
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    config = json.loads((REPO / spec["configs"][0]["file"]).read_text())
    config.update(name="mmtm_mvcnn.modelnet40.dummy", image_size=112)
    (root / "configs" / "mmtm_mvcnn.modelnet40.dummy.json").write_text(json.dumps(config))
    traffic = json.loads((root / "traffic" / "train.guided_b128.json").read_text())
    (root / "traffic" / "train.dummy_b64.json").write_text(json.dumps(dict(traffic, batch=64)))
    (root / "metrics" / "dummy_ms.train.py").write_text("def read(run):\n    return 1.5 * run.units\n")
    spec["configs"].append({"name": "mmtm_mvcnn.modelnet40.dummy", "source": "https://arxiv.org/abs/2202.05306",
                            "file": "portbench/configs/mmtm_mvcnn.modelnet40.dummy.json", "reduced": [],
                            "why": "a dummy"})
    spec["workloads"].append({"name": "mvcnn.train.dummy", "config": "mmtm_mvcnn.modelnet40.dummy",
                              "traffic": "train.dummy_b64", "chips": 1, "why": "a dummy"})
    spec["per_layer"].append({"name": "dummy_ms.train", "unit": "ms", "better": "lower", "source": "program_span",
                              "layer": "engine", "moves": "train_samples_per_s", "workloads": ["mvcnn.train.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = bench.find_cell("mvcnn.train.dummy", spec_path=tmp_path / "BENCHMARK.json", root=root)
    assert cell.config["image_size"] == 112 and cell.traffic["batch"] == 64
    assert [m["name"] for m in cell.per_layer] == ["dummy_ms.train"]
    record = bench.RunRecord(cell, trace=None, units=4)
    assert cell.reader("dummy_ms.train").read(record) == 6.0
    assert cell.driver.__file__.startswith(str(root))
    with pytest.raises(KeyError):
        bench.find_cell("no.such.cell", spec_path=tmp_path / "BENCHMARK.json", root=root)
