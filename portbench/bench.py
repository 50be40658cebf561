"""The harness: one cell, one run.

Everything particular to a cell is found by name, from the cell's entry in
``BENCHMARK.json``:

* its configuration: the file the ``configs`` entry names, whose
  ``family`` names ``families/<family>.py``;
* its traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  general driver ``drivers/<kind>.py``;
* its limits: ``limits/<workload>.json``, one per number compared;
* each per-layer metric: ``metrics/<metric>.py``, whose ``read(run)``
  returns the value or None when it finds nothing to read.

A run: set-up (``setup_s``, from the process's start), then either the
measured window (``--trace 0``: the cell's end-to-end metrics) or the
traced window (``--trace 1``: its per-layer metrics), then the check of
what the timed path produced against the plain reference, after
``memory_peak_bytes`` is read and the program's state is freed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path

from portbench import peaks

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "greedy_multimodal_learning_tpu")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict
    root: Path = ROOT

    @property
    def family(self):
        return load_module(self.root / "families" / f"{self.config['family']}.py")

    @property
    def driver(self):
        return load_module(self.root / "drivers" / f"{self.traffic['kind']}.py")

    def reader(self, metric):
        return load_module(self.root / "metrics" / f"{metric}.py")


_MODULES = {}


def load_module(path):
    """The module of the file at ``path``, loaded once."""
    path = Path(path).resolve()
    if path not in _MODULES:
        if not path.exists():
            raise FileNotFoundError(f"no such harness file: {path}")
        name = "portbench_dyn_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def _applies(entry, workload):
    return "workloads" not in entry or workload in entry["workloads"]


def find_cell(name, spec_path=None, root=None) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` at ``spec_path`` (the
    repository's by default), its files under ``root``."""
    root = Path(root) if root is not None else ROOT
    spec_path = Path(spec_path) if spec_path is not None else root.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path}; there are {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((spec_path.parent / configs[work["config"]]["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{work['traffic']}.json").read_text())
    limits_path = root / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(work["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        limits=limits, root=root,
    )


def forbidden_modules(modules=None):
    """Loaded modules of JAX or of the JAX package, by their whole
    top-level name."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names if m.split(".", 1)[0] in FORBIDDEN})


def set_precision(config, control=False):
    """The configuration's TF32 switches; the control turns TF32 on."""
    import torch

    allow = bool(config.get("tf32", False)) or control
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit; a number without a limit, or that is not finite, fails."""
    checks, correct = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        ok = limit is not None and value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return correct and bool(numbers), checks


@dataclass
class RunRecord:
    """What the per-layer readers read: the traced window's trace, the
    benchmark's spans in it (seconds by name), its counts, and the seconds
    the same work took just before with the profiler off."""

    cell: Cell
    trace: object
    spans: dict = field(default_factory=dict)
    units: int = 0  # steps (training) or requests (serving) in the traced window
    samples: int = 0  # real samples in the traced window
    untraced_s: float = 0.0  # the same work again with the profiler off, by the host clock

    @property
    def arch(self):
        return self.cell.family.arch(self.cell.config)

    @property
    def spatial(self):
        return self.cell.family.spatial(self.cell.config)

    @property
    def batch(self):
        return int(self.cell.traffic["batch"])


def power_limit_w(device):
    """The card's power limit in watts as ``nvidia-smi`` reads it, or None
    where it cannot be read.  The card is found by its UUID; where that
    fails and ``nvidia-smi`` lists one card, that one."""
    import subprocess

    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    rows = [[f.strip() for f in line.split(",")] for line in out.splitlines() if line.count(",") == 1]
    try:
        uuid = str(torch.cuda.get_device_properties(device).uuid)
    except (AttributeError, RuntimeError):
        uuid = ""
    mine = [w for u, w in rows if uuid and u.endswith(uuid)] or ([rows[0][1]] if len(rows) == 1 else [])
    try:
        return float(mine[0])
    except (IndexError, ValueError):
        return None


def device_info(device):
    """The result's ``device``: the driver's keys, and the card's power
    limit, which the shares of the published peaks assume at 700 W."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, "power_limit_w": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": power_limit_w(device)}


def run_cell(cell: Cell, *, seed, seconds, trace, device, t_start, control=False):
    """One run of ``cell``; returns the result object the run prints.
    ``control``: the program runs with TF32 on (set-up and window), the
    check as the configuration states."""
    import time

    import torch

    device = torch.device(device)
    set_precision(cell.config, control=control)
    session = cell.driver.Session(cell, seed, device)
    t_session = time.time()
    session.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    print(f"setup_s {setup_s}: {t_session - t_start} to the session, {time.time() - t_session} in its set-up",
          file=sys.stderr)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        record = session.traced_window()
        tr = record.trace
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = session.window(seconds)
        names = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name, value in measured.items():
            if name in names:
                result["metrics"][name] = {"value": value, "unit": names[name]}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": names.get("setup_s", "s")}
    result["attempted"], result["failed"] = session.attempted, session.failed
    result["device"] = device_info(device)
    if trace:
        print(f"traced window {tr.window_s} s, device busy {tr.busy_s} s; the same work with the profiler off "
              f"{record.untraced_s} s", file=sys.stderr)
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    print(f"card {result['device']['kind']}, power limit {result['device']['power_limit_w']} W "
          f"(the published peaks assume {peaks.POWER_LIMIT_W} W)", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    set_precision(cell.config)
    t_check = time.time()
    numbers = session.check()
    print(f"check took {time.time() - t_check} s", file=sys.stderr)
    correct, checks = verdict(numbers, cell.limits)
    result["correct"] = correct and result["failed"] == 0
    notes = getattr(session, "notes", None)
    if notes:  # what the check read beside its numbers, not compared
        print(f"notes {json.dumps(notes)}", file=sys.stderr)
        result["notes"] = notes
    result["checks"] = checks
    return result


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__(f"loaded in the run's process: {', '.join(found)}")
        self.found = found
