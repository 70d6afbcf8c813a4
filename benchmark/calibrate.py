"""The readings that a cell's limits are set from, one JSON line a seed.

    python3 benchmark/calibrate.py --workload <name> --seeds <n> [<n> ...]

Set-up once, then for each seed the numbers the cell compares, of the
program (its checked first steps or frames, as a run takes them), of the
control (the plain reference computed in fp8, the precision below the
configuration's bf16) and, for a training cell, of the half-batch fault
(the reference on the first half of each batch), each against the float32
reference.  Runs on the card; no measured window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import program
    from common import ROOT

    program.cache_dirs(ROOT)
    import torch

    from run import cell_run

    with cell_run(args.workload, args.seeds[0]) as (cell, overrides, driver):
        for line in driver.calibrate(cell, torch.device(args.device), args.seeds, overrides):
            print(json.dumps(dict(line, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
