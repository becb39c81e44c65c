#!/usr/bin/env python3
"""List every device operation of a cell's traced span on the card, with
its count and seconds, to find the kernel-name patterns a roofline metric
reads.

    python3 portbench/tools/names.py --workload reconet-serve --seed 1
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run as run_m  # noqa: E402
from portbench.core import load  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=6)
    args = p.parse_args(argv)
    run = run_m.run_cell(load.cell(args.workload), args.seed, args.seconds,
                         True)
    names = {}
    for name, a, b in run.trace.device:
        n, s = names.get(name, (0, 0.0))
        names[name] = (n + 1, s + b - a)
    for name, (n, s) in sorted(names.items(), key=lambda kv: -kv[1][1]):
        print(f"{s:.6f} s  {n:6d}  {name[:200]}")


if __name__ == "__main__":
    main()
