"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration and metric found by its name."""

import importlib
import json
import os
import re

import pytest

from portbench.core import load

BENCH = load.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # a full check of 24 cells fits its 43200 seconds
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert all(_line(x["why"]) for x in BENCH["configs"] + BENCH["workloads"])
    assert all(_line(m["layer"]) for m in BENCH["per_layer"])


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and _line(c["source"])
        assert c["file"].startswith("portbench/configs/")
        assert os.path.isfile(os.path.join(load.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in E2E_SOURCES
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_config_is_used_and_every_cell_reports_enough():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for name in CELLS:
        e2e, layer = load.metrics_of(BENCH, name)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer, name


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_loads_and_its_metrics_moves_are_reported(cell):
    spec = load.cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert spec["config"] == entry["config"]
    assert spec["chips"] == entry["chips"]
    assert spec["why"] == entry["why"]
    load.config(spec["config"])
    importlib.import_module(f"portbench.drivers.{spec['driver']}")
    importlib.import_module(f"portbench.entry.{spec['config']}")
    importlib.import_module(f"portbench.counts.{spec['config']}")
    importlib.import_module(f"portbench.reference.{spec['config']}")
    e2e, layer = load.metrics_of(BENCH, cell)
    names = {m["name"] for m in e2e}
    for m in layer:
        assert m["moves"] in names, (cell, m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in CELLS


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader_of_its_own(metric):
    mod = load.module("metrics", metric)
    assert callable(mod.read)
    # a reader takes its name, unit and layer from BENCHMARK.json alone
    assert not {"NAME", "UNIT", "SOURCE", "LAYER", "MOVES"} & set(vars(mod))


def test_one_layer_name_per_layer():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_without_a_card_a_run_prints_no_result():
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    out = subprocess.run(
        [sys.executable, os.path.join(load.PKG, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=load.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_the_cells_entry_module_has_what_its_driver_calls(cell):
    spec = load.cell(cell)
    driver = importlib.import_module(f"portbench.drivers.{spec['driver']}")
    entry = importlib.import_module(f"portbench.entry.{spec['config']}")
    assert all(callable(getattr(entry, n, None)) for n in driver.ENTRY)


@pytest.mark.parametrize("driver", ["stream", "pairs", "train"])
def test_a_driver_names_no_model_of_the_port(driver):
    """The model's calls sit in ``entry/<config>.py``: a configuration
    added later brings files of its own and edits no driver."""
    import ast

    path = os.path.join(load.PKG, "drivers", f"{driver}.py")
    tree = ast.parse(open(path).read())
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {a.name for n in ast.walk(tree)
              if isinstance(n, (ast.Import, ast.ImportFrom))
              for a in n.names}
    modules = {n.module for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.module}
    assert not {n for n in names if n.startswith(("stylize_", "make_"))}
    assert not {m for m in modules if m.startswith(
        ("vst_tpu_torch.models", "vst_tpu_torch.infer.image",
         "vst_tpu_torch.train"))}
