"""Find a cell, its configuration, its driver and its metrics by name.

Everything that belongs to one configuration, cell, driver or metric sits
in files of its own under ``portbench/``; ``BENCHMARK.json`` at the root
lists the cells and metrics.  Nothing here names a cell or a metric."""

import importlib.util
import json
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name):
    """``workloads/<name>.json`` with its name filled in."""
    path = os.path.join(PKG, "workloads", f"{name}.json")
    if not os.path.isfile(path):
        raise SystemExit(f"portbench: no cell {name!r} ({path})")
    spec = read_json(path)
    spec["name"] = name
    return spec


def config(name):
    return read_json(os.path.join(PKG, "configs", f"{name}.json"))


def module(folder, name):
    """``portbench/<folder>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(PKG, folder, f"{name}.py")
    key = f"portbench_{folder}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _reports(entry, cell_name, e2e_names):
    listed = entry.get("workloads")
    if listed is not None:
        return cell_name in listed
    moves = entry.get("moves")
    return moves is None or moves in e2e_names


def metrics_of(bench, cell_name):
    """(end-to-end entries, per-layer entries) that ``cell_name`` reports,
    by the rule of ``BENCHMARK.json``: an entry with ``workloads`` in the
    cells it lists, else an end-to-end metric everywhere and a per-layer
    one wherever the end-to-end metric it moves is reported."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell_name, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, cell_name, names)]
    return e2e, layer
