"""Where the serving forward's time goes on the GPU.

    python -m greedy_multimodal_learning_tpu_torch.profile_serving [--batch 128] [--steps 10]

For each of f32 and bf16, with the fused gating kernel on and off, it runs
``Trainer._predict_step`` on a seeded uint8 batch (224², 2 views, 40
classes, random seeded weights) and prints one JSON line with:

* ``step_ms``: host clock around one step ending in a synchronize
  (H2D of the uint8 batch, preprocess, forward), median of ``--steps``;
* ``h2d_ms`` and ``forward_ms``: CUDA events around the copy and around
  preprocess + forward;
* ``device_busy_share``: summed kernel time over the profiled wall time;
* ``gating_kernel_ms_per_step``: device time of the fused gating kernel
  (``csrc/mmtm_gating.cu``);
* ``kernels``: device time per step of the top kernels by name, from
  ``torch.profiler``.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from .bootstrap import init_model
from .data.transforms import preprocess
from .engine.framework import Trainer
from .models import MMTMMVCNN

# the kernel of csrc/mmtm_gating.cu
GATING_KERNELS = r"\bgating_fwd_kernel\b"


def _events_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def device_rows(prof, steps):
    """(ms per step, kernel name) of the profiled device-side events
    (kernels, memcpy, memset), largest first.  The CPU-side aten ops carry
    their kernels' time too and would count it twice, and so would the
    device-side shadows of ``record_function`` ranges (the port's spans)."""
    rows = [
        (e.self_device_time_total / 1e3 / steps, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    return sorted(rows, reverse=True)


def smi_line():
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def profile_config(dtype, use_pallas, batch, steps):
    model = init_model(MMTMMVCNN(nclasses=40, use_pallas=use_pallas, dtype=dtype), 0, "cuda")
    trainer = Trainer(model, nummodalities=2, device="cuda")
    rng = np.random.default_rng(0)
    host = {
        "images": rng.integers(0, 255, (batch, 2, 224, 224, 3), dtype=np.uint8),
        "mask": np.ones((batch,), np.float32),
    }
    for _ in range(3):
        trainer._predict_step(host)
    torch.cuda.synchronize()

    step_ms, h2d_ms, fwd_ms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        trainer._predict_step(host)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        ms, images = _events_ms(lambda: torch.from_numpy(host["images"]).to("cuda"))
        h2d_ms.append(ms)
        mask = torch.from_numpy(host["mask"]).to("cuda")
        with torch.no_grad():
            ms, _ = _events_ms(lambda: trainer.model(
                preprocess(images, train=False, dtype=dtype), valid_mask=mask, mmtm_state={}))
        fwd_ms.append(ms)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer._predict_step(host)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof, steps)
    busy_ms = sum(ms for ms, _ in rows)
    gating_ms = sum(ms for ms, name in rows if re.search(GATING_KERNELS, name))
    return {
        "dtype": str(dtype)[6:],
        "use_pallas": use_pallas,
        "batch": batch,
        "step_ms": float(np.median(step_ms)),
        "samples_per_s": batch / (float(np.median(step_ms)) / 1e3),
        "h2d_ms": float(np.median(h2d_ms)),
        "forward_ms": float(np.median(fwd_ms)),
        "device_ms_per_step": busy_ms,
        "device_busy_share": busy_ms * steps / wall_ms,
        "gating_kernel_ms_per_step": gating_ms,
        "kernels": [{"name": name[:120], "ms_per_step": ms} for ms, name in rows[:15]],
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# {smi_line()} | torch {torch.__version__}", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for use_pallas in (True, False):
            print(json.dumps(profile_config(dtype, use_pallas, args.batch, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
