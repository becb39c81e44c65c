#!/usr/bin/env python3
"""Summarize series of runs (``tools/series.py`` output): for each cell,
set and metric, the values, the median, and the spread (the distance
between the first and third quartile over the median, as
``statistics.quantiles(values, n=4)`` gives them); then the widest spread
of each metric over the sets and the bound five times it would give.

    python3 portbench/tools/spread.py chiprun_out/set1.jsonl \\
        chiprun_out/set2.jsonl
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench.core.stats import quartile_spread  # noqa: E402


def main(paths):
    sets = {}
    for path in paths:
        for line in open(path):
            rec = json.loads(line)
            res = rec["result"]
            key = (rec["workload"], path)
            if res is None:
                print(f"{path}: {rec['workload']} seed {rec['seed']} rc "
                      f"{rec['rc']}: no result")
                continue
            if not res["correct"]:
                print(f"{path}: {rec['workload']} seed {rec['seed']}: "
                      f"correct false {res['checks']}")
            for name, m in res["metrics"].items():
                sets.setdefault(key, {}).setdefault(name, []).append(
                    m["value"])
    widest = {}
    for (cell, path), metrics in sorted(sets.items()):
        for name, vals in sorted(metrics.items()):
            q2 = statistics.median(vals)
            spread = quartile_spread(vals) if len(vals) >= 2 else float("nan")
            print(f"{cell} {path} {name}: n {len(vals)} median {q2:.6g} "
                  f"spread {spread:.4%} values "
                  f"{[round(v, 5) for v in vals]}")
            k = (cell, name)
            widest[k] = max(widest.get(k, 0.0), spread)
    for (cell, name), s in sorted(widest.items()):
        print(f"widest {cell} {name}: {s:.4%} -> 5x {5 * s:.4%}")


if __name__ == "__main__":
    main(sys.argv[1:])
