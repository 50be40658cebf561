"""Where the guided train step's time goes on the GPU.

    python -m greedy_multimodal_learning_tpu_torch.profile_training [--batch 128] [--steps 10]

For each of f32 and bf16, with the fused gating kernels on and off, it runs
``Trainer.train_batch`` (the guided controller, SGD at lr 0.1) on a seeded
uint8 batch already on the device (224², 2 views, 40 classes, random seeded
weights) and prints one JSON line with:

* ``step_ms``: host clock around one step ending in a synchronize, median
  of ``--steps``, and ``samples_per_s`` from it;
* ``device_busy_share``: summed kernel time over the profiled wall time;
* ``gating_forward_ms_per_step`` and ``gating_backward_ms_per_step``:
  device time of the kernels of ``csrc/mmtm_gating.cu`` and
  ``csrc/mmtm_gating_bwd.cu``;
* ``elementwise_reduce_ms_per_step``: device time of PyTorch's generic
  elementwise and reduction kernels (mostly the masked train BatchNorm,
  which is plain torch ops);
* ``kernels``: device time per step of the top kernels by name, from
  ``torch.profiler``.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np
import torch

from .bootstrap import init_model
from .engine import Trainer, make_optimizer
from .models import MMTMMVCNN
from .profile_serving import device_rows, smi_line

GATING_FORWARD = r"\bgating_fwd_kernel\b"
GATING_BACKWARD = r"\b(gating_bwd_map_kernel|weight_grad_kernel)\b"
ELEMENTWISE_REDUCE = r"elementwise_kernel|reduce_kernel"


def profile_config(dtype, use_pallas, batch, steps):
    model = init_model(MMTMMVCNN(nclasses=40, use_pallas=use_pallas, dtype=dtype), 0, "cuda")
    trainer = Trainer(
        model,
        make_optimizer(model.parameters(), lr=0.1),
        controller_kind="guided",
        controller_config={"epsilon": 0.01, "curation_windowsize": 5},
        device="cuda",
    )
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {
        "images": torch.randint(0, 256, (batch, 2, 224, 224, 3), generator=g, device="cuda", dtype=torch.uint8),
        "labels": torch.randint(0, 40, (batch,), generator=g, device="cuda", dtype=torch.int32),
        "mask": torch.ones(batch, device="cuda"),
    }
    unlock = torch.tensor(True, device="cuda")

    def step():
        trainer.train_batch(data, trainer.train_flips(batch, 2), unlock)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = device_rows(prof, steps)
    busy_ms = sum(ms for ms, _ in rows)
    matching = lambda pattern: sum(ms for ms, name in rows if re.search(pattern, name))
    median = float(np.median(step_ms))
    return {
        "dtype": str(dtype)[6:],
        "use_pallas": use_pallas,
        "batch": batch,
        "step_ms": median,
        "samples_per_s": batch / (median / 1e3),
        "device_ms_per_step": busy_ms,
        "device_busy_share": busy_ms * steps / wall_ms,
        "gating_forward_ms_per_step": matching(GATING_FORWARD),
        "gating_backward_ms_per_step": matching(GATING_BACKWARD),
        "elementwise_reduce_ms_per_step": matching(ELEMENTWISE_REDUCE),
        "kernels": [{"name": name[:120], "ms_per_step": ms} for ms, name in rows[:15]],
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_training needs a CUDA device", file=sys.stderr)
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
