"""The port stands alone: importing every module of
``greedy_multimodal_learning_tpu_torch`` (``parallel/tensor.py`` included)
and ``chip_smoke`` loads no jax,
flax, optax nor anything of the JAX package, and no source of the port or
of its tools at the repository's root (``chip_smoke.py``, ``kernel_ab.py``,
``kernel_phases.py``) has an import of them."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "greedy_multimodal_learning_tpu_torch"
TOOLS = ("chip_smoke.py", "kernel_ab.py", "kernel_phases.py")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "greedy_multimodal_learning_tpu")

_PROBE = """
import importlib, pkgutil, sys
import greedy_multimodal_learning_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
forbidden = {forbidden!r}
bad = sorted(m for m in sys.modules if m.split(".")[0] in forbidden)
print(len(names), bad, names)
sys.exit(1 if bad else 0)
"""

_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|flax|optax)\b|from\s+(?:jax|jaxlib|flax|optax)\b"
    r"|import\s+greedy_multimodal_learning_tpu\b(?!_)|from\s+greedy_multimodal_learning_tpu(?:\.|\s))",
    re.M,
)


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=FORBIDDEN)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    # the serving and training slices' modules, the analysis package, the eval
    # entry, the host library's loader (utils.native), the 3D family's models
    # and clip data, the side entries (BatchNorm folding, the sweep and its
    # entry, run_api), data parallelism and tensor parallelism
    assert n_modules >= 51, r.stdout
    for name in ("engine.fold_bn", "engine.sweep", "eval_sweep", "run_api", "parallel", "parallel.mesh",
                 "parallel.multihost", "parallel.launch", "parallel.tensor"):
        assert f"greedy_multimodal_learning_tpu_torch.{name}" in r.stdout, name


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in [*PORT.rglob("*.py"), *(REPO / t for t in TOOLS)]),
)
def test_source_has_no_jax_import(path):
    text = (REPO / path).read_text()
    hits = [m.group(0).strip() for m in _IMPORT.finditer(text)]
    assert not hits, f"{path}: {hits}"
