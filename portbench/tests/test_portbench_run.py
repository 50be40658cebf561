"""``run.py`` without a card, and in a directory that holds only the
benchmark: it fails and prints no result; it does not fall back to the
CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "mvcnn.train.guided_b128", "--seed", "2147483777", "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def _result_printed(stdout):
    lines = [l for l in stdout.splitlines() if l.strip()]
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_no_card_exits_non_zero_without_a_result():
    proc = _run(REPO)
    assert proc.returncode == 2, proc.stderr
    assert not _result_printed(proc.stdout)
    assert "needs 1 CUDA device" in proc.stderr


def test_only_the_benchmark_is_not_enough(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and not _result_printed(proc.stdout)


def test_the_cell_must_exist():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "no.such.cell", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not _result_printed(proc.stdout)
