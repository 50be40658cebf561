"""Where the guided train step's time goes on the GPU.

    python -m greedy_multimodal_learning_tpu_torch.profile_training [--batch 128] [--steps 10]
    python -m greedy_multimodal_learning_tpu_torch.profile_training --family 3dcnn [--batch 8] [--steps 10]
    python -m greedy_multimodal_learning_tpu_torch.profile_training --data-parallel [--batch 256] [--steps 10]

For each of f32 and bf16, with the fused gating kernels on and off, it runs
``Trainer.train_batch`` (the guided controller, SGD at lr 0.1) on a seeded
uint8 batch already on the device (224², 2 views, 40 classes, random seeded
weights) and prints one JSON line with the fields below.  ``--family
3dcnn`` does the same for the 3D family at full width (three r3d-18
towers, RGB + depth + flow clips of 16 frames of 112², 25 classes, default
batch 8), whose gating is always eager.  ``--data-parallel`` runs the
kernel path of the 2-D family in each dtype without and with a one-rank
NCCL group (``training_loop.data_parallel`` at world 1), in turns plain,
world 1, world 1, plain.  Each line has:

* ``step_ms``: host clock around one step ending in a synchronize, median
  of ``--steps``, and ``samples_per_s`` from it;
* ``device_busy_share``: summed kernel time over the profiled wall time;
* ``gating_forward_ms_per_step`` and ``gating_backward_ms_per_step``:
  device time of the kernels of ``csrc/mmtm_gating.cu`` and
  ``csrc/mmtm_gating_bwd.cu``;
* ``elementwise_reduce_ms_per_step``: device time of PyTorch's generic
  elementwise and reduction kernels (the residual adds and the ReLUs
  after them, SGD, the controller);
* ``batch_norm_ms_per_step``: device time of the masked train-mode
  BatchNorm's kernels (``csrc/masked_batch_norm.cu``);
* ``convolution_ms_per_step``: device time of the kernels whose names mark
  them as cuDNN's convolutions (forward, data and weight gradients);
* ``kernels``: device time per step of the top kernels by name, from
  ``torch.profiler``;
* ``world``: 1 under the one-rank group, else null, with
  ``collectives_per_step`` and ``nccl_ms_per_step`` (device time of the
  NCCL kernels).

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
from .data.transforms import flip_shape
from .engine import Trainer, make_optimizer
from .models import MMTM3DCNN, MMTMMVCNN
from .parallel import collective_count, join_world, leave_world
from .profile_serving import device_rows, smi_line

GATING_FORWARD = r"\bgating_fwd_kernel\b"
GATING_BACKWARD = r"\b(gating_bwd_map_kernel|weight_grad_kernel)\b"
ELEMENTWISE_REDUCE = r"elementwise_kernel|reduce_kernel"
BATCH_NORM = r"\bmbn_(forward|backward)_kernel\b"
NCCL = r"nccl"
CONVOLUTION = r"conv|xmma|implicit_gemm|cudnn|fprop|dgrad|wgrad"


# family: (model for (dtype, use_pallas), uint8 sample shape, classes, BDR groups)
FAMILIES = {
    "mvcnn": (lambda dtype, use_pallas: MMTMMVCNN(nclasses=40, use_pallas=use_pallas, dtype=dtype),
              (2, 224, 224, 3), 40, {}),
    "3dcnn": (lambda dtype, use_pallas: MMTM3DCNN(nclasses=25, dtype=dtype), (3, 16, 112, 112, 3), 25,
              {"branchnames": ["net_view_0", "net_view_1", "net_view_2"], "mmtm_names": ["rgb", "depth", "flow"]}),
}


def profile_config(dtype, use_pallas, batch, steps, family="mvcnn", world1=False):
    world, made = join_world("cuda") if world1 else (None, False)
    try:
        return _profile(dtype, use_pallas, batch, steps, family, world)
    finally:
        leave_world(made)


def _profile(dtype, use_pallas, batch, steps, family, world):
    build, sample, nclasses, groups = FAMILIES[family]
    model = init_model(build(dtype, use_pallas), 0, "cuda")
    trainer = Trainer(
        model,
        make_optimizer(model.parameters(), lr=0.1),
        controller_kind="guided",
        controller_config={"epsilon": 0.01, "curation_windowsize": 5, **groups},
        nummodalities=model.num_towers,
        device="cuda",
        world=world,
    )
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {
        "images": torch.randint(0, 256, (batch, *sample), generator=g, device="cuda", dtype=torch.uint8),
        "labels": torch.randint(0, nclasses, (batch,), generator=g, device="cuda", dtype=torch.int32),
        "mask": torch.ones(batch, device="cuda"),
    }
    unlock = torch.tensor(True, device="cuda")
    flips = flip_shape(data["images"].shape)

    def step():
        trainer.train_batch(data, trainer.train_flips(*flips), unlock)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    collectives = collective_count()
    step()
    collectives = collective_count() - collectives
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
        "family": family,
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
        "batch_norm_ms_per_step": matching(BATCH_NORM),
        "convolution_ms_per_step": matching(CONVOLUTION),
        "world": world.size if world is not None else None,
        "collectives_per_step": collectives,
        "nccl_ms_per_step": matching(NCCL),
        "kernels": [{"name": name[:120], "ms_per_step": ms} for ms, name in rows[:15]],
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--family", choices=sorted(FAMILIES), default="mvcnn")
    parser.add_argument("--batch", type=int, default=None, help="default: 128 (mvcnn), 8 (3dcnn)")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--data-parallel", action="store_true",
                        help="the 2-D kernel path without and with a one-rank NCCL group")
    args = parser.parse_args()
    batch = args.batch or (128 if args.family == "mvcnn" else 8)
    if not torch.cuda.is_available():
        print("profile_training needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# {smi_line()} | torch {torch.__version__}", flush=True)
    if args.data_parallel:
        for dtype in (torch.float32, torch.bfloat16):
            for world1 in (False, True, True, False):
                print(json.dumps(profile_config(dtype, True, batch, args.steps, world1=world1)), flush=True)
        return 0
    for dtype in (torch.float32, torch.bfloat16):
        for use_pallas in ((True, False) if args.family == "mvcnn" else (False,)):
            print(json.dumps(profile_config(dtype, use_pallas, batch, args.steps, args.family)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
