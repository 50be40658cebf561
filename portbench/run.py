"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers the check compared, each beside its limit, as its last
lines on standard error, and one JSON object as its last line on standard
output (see ``bench.run_cell``).  Needs as many CUDA devices as the cell
asks for: without them it exits with status 2 and prints no result.  A run
that finds JAX or the JAX package loaded once its window has closed exits
with status 3 and prints no result.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, str(REPO))
    from portbench import bench

    cell = bench.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    try:
        result = bench.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=args.trace, device="cuda",
                                t_start=T_START)
    except bench.ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
