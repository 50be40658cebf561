"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the program either; top-level module names
are compared whole, as the program's name begins with the JAX package's."""

import ast
from pathlib import Path

from portbench import bench

ROOT = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "greedy_multimodal_learning_tpu"}
PROGRAM = "greedy_multimodal_learning_tpu_torch"


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = list(ROOT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        if path.parent.name == "tests":
            continue  # the tests read chip_smoke's arithmetic and compare module names
        assert not imported(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        assert imported(path) <= {"__future__", "dataclasses", "math", "numpy", "torch"}, path


def test_whole_names_are_compared():
    assert bench.forbidden_modules([PROGRAM, f"{PROGRAM}.engine", "numpy"]) == []
    assert bench.forbidden_modules(["jax._src.core", "flax", PROGRAM]) == ["flax", "jax"]
    assert bench.forbidden_modules(["greedy_multimodal_learning_tpu.engine"]) == ["greedy_multimodal_learning_tpu"]
