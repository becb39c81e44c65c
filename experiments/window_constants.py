#!/usr/bin/env python3
"""Count the ops' device constants made inside a benchmark cell's window.

    python3 experiments/window_constants.py --workload reconet-serve \\
        --seed 7 --seconds 20

Runs the cell once, traced as ``portbench/run.py --trace 1`` traces it,
in this process (``portbench/run.py::run_cell``), and prints one JSON
line: the builds of ``vst_tpu_torch/ops/constants.py::device_constant``
before the window (set-up and warm-up) and inside it, read where the
harness resets and reads its launch counters, and the
"vst::ops.const_build" spans in the traced part of the window.  Warm-up
makes every constant a cell uses, so both counts inside the window should
be 0."""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run as bench  # noqa: E402
from portbench.core import launches, load  # noqa: E402
from vst_tpu_torch.ops.constants import device_constant  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    bench.fixed_caches()
    marks = {}
    reset, read = launches.reset, launches.read

    def at_start():
        marks["start"] = device_constant.builds
        reset()

    def at_end():
        marks["end"] = device_constant.builds
        return read()

    launches.reset, launches.read = at_start, at_end
    try:
        run = bench.run_cell(load.cell(args.workload), args.seed,
                             args.seconds, True)
    finally:
        launches.reset, launches.read = reset, read
    tr = run.trace
    spans = [(a, b) for n, a, b in tr.host
             if n == "vst::ops.const_build" and b > tr.lo and a < tr.hi]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "builds_before_window": marks["start"],
        "builds_in_window": marks["end"] - marks["start"],
        "const_build_spans_traced": len(spans),
        "traced_s": tr.window_s, "correct": run.correct}))


if __name__ == "__main__":
    main()
