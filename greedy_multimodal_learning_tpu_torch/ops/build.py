"""Build and load the port's native libraries: the CUDA kernels and the
host-side data helpers.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ``ctypes``; each ``csrc/<name>.cc`` (host C++) likewise by ``g++``.
Libraries go to ``_build/`` inside the package, named by a hash of the
source, for a ``.cu`` every shared header ``csrc/*.cuh``, and the flags, so
an edited source or header is rebuilt and a stale library is never loaded.
Nothing is built when a module is imported: the first call that needs a
library builds it.
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

GXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

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


def find_gxx() -> str:
    """``g++`` on PATH; raises when there is none."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host library csrc/fastio.cc needs a C++ compiler on PATH")
    return gxx


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` (a CUDA kernel), else ``csrc/<name>.cc`` (host C++)."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cc"


def library_path(name: str) -> Path:
    """``_build/lib<name>-<digest>.so``: the digest covers the source, for a
    ``.cu`` every ``csrc/*.cuh`` (sorted by name; any kernel may include
    them), and the flags."""
    src = _source(name)
    cuda = src.suffix == ".cu"
    h = hashlib.sha256()
    for path in [src, *(sorted(CSRC_DIR.glob("*.cuh")) if cuda else [])]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS if cuda else GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile_command(name: str, out: Path) -> list:
    src = _source(name)
    if src.suffix == ".cu":
        return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [find_gxx(), *GXX_FLAGS, "-o", str(out), str(src)]


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, one
    compiler process per source, all started together.  Returns the library
    paths; raises with the compiler's output if a build fails.  The
    compiler's report (for a kernel, ``-Xptxas -v``: registers, shared
    memory, spills) of each build is kept beside its library as
    ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = _compile_command(n, tmp)
        procs[n] = (tmp, cmd[0], subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for n, (tmp, compiler, proc) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{Path(compiler).name} failed for {_source(n).name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cc``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LOADED[name] = lib
        return lib
