#!/usr/bin/env python3
"""Run one cell several times in a row, one process a run, and keep each
run's result line and the end of its standard error in a JSON-lines file.

    python3 portbench/tools/series.py --workload reconet-serve \\
        --seeds 11,12,13 --seconds 20 --trace 0 --out chiprun_out/a.jsonl
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--timeout", type=float, default=900)
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in [int(s) for s in args.seeds.split(",")]:
        cmd = [sys.executable, "portbench/run.py", "--workload",
               args.workload, "--seed", str(seed), "--seconds",
               str(args.seconds), "--trace", str(args.trace)]
        t = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=args.timeout)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        wall = time.perf_counter() - t
        lines = out.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if rc == 0 and lines else None
        except json.JSONDecodeError:
            res = None
        rec = {"workload": args.workload, "seed": seed, "trace": args.trace,
               "seconds": args.seconds, "rc": rc, "wall_s": wall,
               "result": res, "stderr_tail": err[-3000:]}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = ({k: round(v["value"], 4) for k, v in res["metrics"].items()}
                 if res else None)
        checks = ({k: (round(v["value"], 6), v["limit"])
                   for k, v in res["checks"].items()} if res else None)
        print(f"{args.workload} seed {seed} trace {args.trace} rc {rc} wall "
              f"{wall:.1f}s correct {res and res['correct']} {short} "
              f"{checks}", flush=True)
        if res is None:
            print(err[-2500:], flush=True)


if __name__ == "__main__":
    main()
