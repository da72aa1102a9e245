"""The readings a cell's limits are set from, in one process on the card:

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds 1]

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a short
window, and prints the numbers the run compares (the lower readings: the
program's sound runs).  For each of ``--control-seeds`` it prints the
control's and the planted faults' readings (``core.control``; the upper
readings).  Each line on standard output is a JSON object.  The limits
themselves go into the cell's workload file by hand, between the two.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from run import prepare_env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    prepare_env()
    import torch

    from bench.core import cells, control
    from bench.core.runner import free
    from run import run_cell
    cell = cells.load(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        line = run_cell(cell, seed, args.seconds, False, device, time.time())
        print(json.dumps({"cell": cell.name, "seed": seed, "reading":
                          "program", "correct": line["correct"],
                          **{k: c["value"] for k, c in
                             line["checks"].items()}}), flush=True)
        free(device)
    for seed in args.control_seeds:
        for name, values in control.readings(cell, seed, device).items():
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "reading": name, **values}), flush=True)
        free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
