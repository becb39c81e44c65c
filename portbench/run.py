#!/usr/bin/env python3
"""Run one cell of the benchmark of vst_tpu_torch once, on the card.

    python3 portbench/run.py --workload reconet-serve --seed 7 \\
        --seconds 20 --trace 0

The cell is ``portbench/workloads/<workload>.json``: its configuration
(``configs/``), its driver (``drivers/``) and its traffic.  Set-up makes
the weights and inputs from ``--seed`` on the card, builds the port through
its public builders and warms up the cell's shapes; the window then runs
for ``--seconds``; afterwards the plain reference (``reference/``) checks
what the window produced.  With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics
(``metrics/<name>.py``), the device's busy and window seconds and the
breakdown.  The last line of standard output is the result as JSON; the
numbers compared, each with its limit, end standard error.  Without a
card, or with JAX loaded, it exits non-zero and prints no result."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import guard, launches, load  # noqa: E402
from portbench.core.record import Run  # noqa: E402


def fixed_caches():
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a cell's first run there builds (the port's own kernels
    build into build/vst_tpu_torch/)."""
    for var, name in (("TRITON_CACHE_DIR", "triton"),
                      ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench", name)


def power_limit():
    """The card's power limit as nvidia-smi gives it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(cell, seed, seconds, trace, device="cuda", t0=None, hook=None,
             overrides=None, train_overrides=None):
    """Drive one cell once and return its ``Run`` (metrics not yet read).
    ``hook(what, obj, ctx)`` replaces the program's batch function or step
    (the control and the planted faults of ``tests/``); ``overrides``
    updates the cell's traffic and check, ``train_overrides`` the
    configuration's training settings (tests at small sizes)."""
    cfg = load.config(cell["config"])
    cfg["train"].update(train_overrides or {})
    traffic = {**cell["traffic"], **cell["check"], **(overrides or {})}
    run = Run(cell=cell, config=cfg, seed=seed, seconds=seconds,
              device=device)
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    entry = importlib.import_module(f"portbench.entry.{cell['config']}")
    driver.run(run, entry, traffic, trace, t0 if t0 is not None else
               time.perf_counter(), hook)
    gc.collect()
    return run


def read_metrics(run, entries):
    """{name: {"value", "unit"}} of the metrics that found something."""
    out = {}
    for m in entries:
        value = load.module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run, metrics, trace, limit):
    import torch

    dev = {"platform": "gpu" if run.device == "cuda" else run.device,
           "kind": (torch.cuda.get_device_name(0) if run.device == "cuda"
                    else "cpu"),
           "count": run.cell["chips"], "memory_peak_bytes": run.peak_bytes,
           "power_limit": limit}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = run.checks
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches()

    cell = load.cell(args.workload)
    bench = load.benchmark()
    e2e, layer = load.metrics_of(bench, args.workload)
    have = guard.card_count()
    if have < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), torch sees {have}", file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
    banned = guard.banned_modules()
    if banned:
        print(f"portbench: the process loaded {banned}: the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 3
    limit = power_limit()
    metrics = read_metrics(run, layer if args.trace else e2e)
    out = result(run, metrics, bool(args.trace), limit)
    for note in run.notes:
        print(f"portbench: {note}", file=sys.stderr)
    unit, units = run.launch_units
    print(f"portbench: {launches.per_unit(run.launches, units, unit)}",
          file=sys.stderr)
    print(f"portbench: {out['device']['kind']}, power limit {limit}",
          file=sys.stderr)
    for name, m in metrics.items():
        print(f"portbench: {name} = {m['value']} {m['unit']}",
              file=sys.stderr)
    print(f"portbench: correct {out['correct']}; the numbers compared:",
          file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
