"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ``ctypes``.  Libraries go to ``_build/`` inside the package, named by a
hash of the source, every shared header ``csrc/*.cuh`` and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.  Nothing is built when a module is imported:
the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# Hopper only: keep the "a" so wgmma/setmaxnreg stay available to later kernels.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH, then the toolkit's
    default install path.  Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH")


def library_path(name: str) -> Path:
    """``_build/lib<name>-<digest>.so``: the digest covers ``<name>.cu``,
    every ``csrc/*.cuh`` (sorted by name; any source may include them) and
    the flags."""
    h = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns the library
    paths; raises with the compiler's output if a build fails.  The
    ``-Xptxas -v`` report (registers, shared memory, spills) of each build
    is kept beside its library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LOADED[name] = lib
        return lib
