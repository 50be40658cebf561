"""Where a tile's time goes inside the gating kernels, from SM clock stamps.

    python3 kernel_phases.py

Builds stamped copies of ``csrc/mmtm_gating.cu`` and ``csrc/mmtm_gating_bwd.cu``
into ``smoke_out/phases/`` (git-ignored): each ``// @phase N`` mark in a
kernel's tile loop becomes a ``clock64()`` stamp by thread 0 of the CTAs of
the first cluster.  The shipped kernels carry no stamps.  It runs each
kernel once (after three warm-up calls, L2 flushed) at the three 224²
fusion sites, B=128, float32 and bfloat16, with the plan the wrapper takes,
and prints one JSON line per (direction, dtype, site): the mean SM cycles of
each phase over the first cluster's CTAs and tiles (the last phase is
measured to the next tile's first mark, so the cluster's last tile has
none).  Writes all of it to ``chiprun_out/kernel_phases.json``.  Needs a
CUDA device.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from greedy_multimodal_learning_tpu_torch.ops import build

mg = importlib.import_module("greedy_multimodal_learning_tpu_torch.ops.mmtm_gating")

OUT = os.path.join(cs.WORK, "phases")
CTAS, ITERS, MARKS = 8, 32, 16  # stamps kept: the first cluster's CTAs, tiles, marks
STAMP = "if (threadIdx.x == 0 && blockIdx.x < {c} && it < {i}) g_stamps[(blockIdx.x * {i} + it) * {m} + {p}] = clock64();"
HEAD = f"""
__device__ long long g_stamps[{CTAS * ITERS * MARKS}];
extern "C" int read_stamps(void* dst) {{ return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)); }}
extern "C" int reset_stamps() {{
  void* p;
  cudaError_t err = cudaGetSymbolAddress(&p, g_stamps);
  return (int)(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_stamps)));
}}
"""
# what runs between mark p and mark p + 1 (the last: up to the next tile's mark 0)
PHASES = {
    "fwd": ["wait for the bulk copies", "reduce + sync", "partial sums, sq", "e product", "push e + sync",
            "gate product", "push g + sync", "scale + store", "issue the next copies"],
    "bwd": ["g, joint rows + pre product", "wait for the bulk copies", "reduce do.f", "sync", "partial sums, dz",
            "de product", "push de + sync", "dsq product", "push dsq + sync", "df + store", "issue the next copies"],
}
SOURCES = {"fwd": "mmtm_gating", "bwd": "mmtm_gating_bwd"}


def build_stamped():
    """The stamped libraries, built in parallel with the package's flags."""
    os.makedirs(OUT, exist_ok=True)
    for f in build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(f, OUT)
    procs = {}
    for name in SOURCES.values():
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        text = text.replace('#include "mmtm_cluster.cuh"', '#include "mmtm_cluster.cuh"\n' + HEAD, 1)
        text = re.sub(r"// @phase (\d+)[^\n]*", lambda m: STAMP.format(c=CTAS, i=ITERS, m=MARKS, p=m.group(1)), text)
        src, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (lib, subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the stamped {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(os.path.abspath(lib))
    return libs


def phase_cycles(t, direction, ntiles):
    """Mean cycles of each phase over CTAs 0..CTAS-1 and the cluster's tiles."""
    names, out = PHASES[direction], {}
    for p, name in enumerate(names):
        last = p == len(names) - 1
        spans = [(t[c, i + 1, 0] if last else t[c, i, p + 1]) - t[c, i, p]
                 for c in range(CTAS) for i in range(min(ntiles, ITERS) - last)]
        out[name] = float(np.mean(spans)) if spans else None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phases needs a CUDA device", file=sys.stderr)
        return 1
    libs = build_stamped()
    mg.load = lambda name: libs[name]  # the wrappers launch the stamped kernels
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    result = {"smi": cs.smi_line(), "cases": []}
    print(result["smi"], flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for site, (S, C) in cs.SITES.items():
            for direction in ("fwd", "bwd"):
                if direction == "fwd":
                    fn, args = mg.mmtm_gating, cs.gating_inputs(cs.BATCH, S, C, dtype, 0)
                else:
                    fn, args = mg.mmtm_gating_bwd, cs.bwd_inputs(cs.BATCH, S, C, dtype, 0)[0]
                lib = libs[SOURCES[direction]]
                for _ in range(3):
                    fn(*args)
                torch.cuda.synchronize()
                if lib.reset_stamps() != 0:
                    raise RuntimeError("reset_stamps failed")
                flush.zero_()
                fn(*args)
                torch.cuda.synchronize()
                t = np.zeros((CTAS, ITERS, MARKS), dtype=np.int64)
                if lib.read_stamps(ctypes.c_void_p(t.ctypes.data)) != 0:
                    raise RuntimeError("read_stamps failed")
                plan = mg.kernel_plan(direction, cs.BATCH, S, C, C, dtype)
                ntiles = len(range(0, plan.tiles, plan.grid))  # the first cluster's
                cycles = phase_cycles(t, direction, ntiles)
                case = {"direction": direction, "dtype": str(dtype)[6:], "site": site, "n": plan.n,
                        "tiles": plan.tiles, "tiles_of_cluster": ntiles,
                        "tile_cycles": float(np.mean([t[c, i, len(PHASES[direction]) - 1] - t[c, i, 0]
                                                      for c in range(CTAS) for i in range(min(ntiles, ITERS))])),
                        "phase_cycles": cycles}
                print(json.dumps(case), flush=True)
                result["cases"].append(case)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "kernel_phases.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
