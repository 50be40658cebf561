"""The benchmark's own tests: ``python -m pytest portbench/tests``.

Tests marked ``card`` need a CUDA device; each looks for one inside the
test and skips without it."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")
