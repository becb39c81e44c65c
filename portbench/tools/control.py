#!/usr/bin/env python3
"""Run a cell with the control or a planted fault in the program's place
(``tools/plants.py``), or with nothing planted (``--plant none``: the
sound program's readings), at the cell's own size on the card, and print
the numbers compared with their limits, one JSON line a seed.

    python3 portbench/tools/control.py --workload reconet-serve \\
        --plant control --seeds 1,2,3 --seconds 4
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run as run_m  # noqa: E402
from portbench.core import load  # noqa: E402
from portbench.tools.plants import hook  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--plant", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4)
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = load.cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        try:
            run = run_m.run_cell(cell, seed, args.seconds, False,
                                 hook=None if args.plant == "none"
                                 else hook(args.plant))
            rec = {"correct": run.correct, "checks": run.checks,
                   "notes": run.notes}
        except Exception as e:  # a control that crashes has failed
            rec = {"correct": False, "error": repr(e)[:500]}
        rec.update(workload=args.workload, plant=args.plant, seed=seed,
                   wall_s=time.perf_counter() - t)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
