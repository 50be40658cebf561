"""The readings each cell's limits are set from, on the card, in one
process:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--control-seeds 4,5,6]
        [--half-seeds 7,8,9] [--mask-seeds 10,11,12] [--decision-seeds 13,14,15] [--seconds 3] [--out FILE]

For each seed, a whole run of the cell as ``run.py`` makes it
(``bench.run_cell``: set-up, a window of ``--seconds``, which for training
is at least one epoch, and the check against the reference), with

* ``sound``: the program in the configuration's precision;
* ``control``: the program with TF32 on for cuDNN and matmuls, the nearest
  precision below the configuration's float32;
* ``half``: training only, the program with half of every batch left out
  (its mask zeroed, the means taken over the rest);
* ``mask``: training only, the program with the mask ignored (every row of
  every batch counted, the padding of a partial batch too);
* ``decision``: training only, the program's curation decision inverted
  where its controller makes it.

Prints one JSON line a reading and writes them all to ``--out``.  Needs a
CUDA device.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _ints(text):
    return [int(s) for s in text.split(",") if s]


def _patch_mask(change):
    """Pass every batch's mask through ``change`` on its way to the device;
    returns the undo."""
    from greedy_multimodal_learning_tpu_torch.engine.framework import Trainer

    plain = Trainer._to_device

    def faulted(self, batch):
        data = plain(self, batch)
        return dict(data, mask=change(data["mask"]))

    Trainer._to_device = faulted
    return lambda: setattr(Trainer, "_to_device", plain)


def _half(mask):
    mask = mask.clone()
    mask[mask.shape[0] // 2:] = 0
    return mask


def _patch_decision():
    """Invert the controller's curation flag at every step; returns the
    undo."""
    import dataclasses

    from greedy_multimodal_learning_tpu_torch.engine import steps

    plain = steps.guided_update

    def faulted(*args, **kwargs):
        out = plain(*args, **kwargs)
        return dataclasses.replace(out, curation_mode=~out.curation_mode)

    steps.guided_update = faulted
    return lambda: setattr(steps, "guided_update", plain)


FAULTS = {
    "half": lambda: _patch_mask(_half),
    "mask": lambda: _patch_mask(lambda mask: mask.new_ones(mask.shape)),
    "decision": _patch_decision,
}


def reading(cell, seed, kind, seconds):
    import torch

    from portbench import bench

    undo = FAULTS[kind]() if kind in FAULTS else (lambda: None)
    t0 = time.time()
    try:
        result = bench.run_cell(cell, seed=seed, seconds=seconds, trace=0, device="cuda", t_start=t0,
                                control=(kind == "control"))
    finally:
        undo()
    gc.collect()
    torch.cuda.empty_cache()
    return {"workload": cell.name, "kind": kind, "seed": seed, "correct": result["correct"],
            "numbers": {k: c["value"] for k, c in result["checks"].items()}, "notes": result.get("notes"),
            "run_s": time.time() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--half-seeds", type=_ints, default=[])
    p.add_argument("--mask-seeds", type=_ints, default=[])
    p.add_argument("--decision-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = bench.find_cell(args.workload)
    rows = []
    for kind, seeds in (("sound", args.seeds), ("control", args.control_seeds), ("half", args.half_seeds),
                        ("mask", args.mask_seeds), ("decision", args.decision_seeds)):
        for seed in seeds:
            rows.append(reading(cell, seed, kind, args.seconds))
            print(json.dumps(rows[-1]), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
