"""Whole runs at small sizes on the CPU, past the look for a card: a sound
run checks as correct, and ``correct`` comes out false with each fault a
cell can have planted under the timed path, and with the serving
control.  The training control (TF32) exists only on the card
(``tools/control.py`` runs it there)."""

import importlib

import pytest
import torch

from portbench import run as run_m
from portbench.core import load
from portbench.tools.plants import FAULTS, hook

CELLS = [w["name"] for w in load.benchmark()["workloads"]]
SEED = 2**31 + 12345


def small_run(cell, plant=None, seconds=0.6):
    """A run of ``cell`` at the small size its file gives (``small``)."""
    torch.set_num_threads(4)
    spec = load.cell(cell)
    small = spec["small"]
    return run_m.run_cell(spec, SEED, seconds, False, device="cpu",
                          hook=plant and hook(plant),
                          overrides=small.get("traffic"),
                          train_overrides=small.get("train"))


def test_every_cell_has_a_small_size():
    assert all("small" in load.cell(c) for c in CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    run = small_run(cell)
    assert run.correct, run.checks
    assert run.setup_s > 0 and run.window_s > 0


def hook_of(cell):
    driver = load.cell(cell)["driver"]
    return importlib.import_module(f"portbench.drivers.{driver}").HOOK


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in FAULTS[hook_of(c)]])
def test_a_planted_fault_is_not_correct(cell, fault):
    run = small_run(cell, fault)
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", [c for c in CELLS if hook_of(c) == "serve"])
def test_the_serving_control_is_not_correct(cell):
    run = small_run(cell, "control")
    assert not run.correct, run.checks


@pytest.mark.parametrize("cell", [c for c in CELLS if hook_of(c) == "step"])
def test_the_training_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("TF32, the training control, exists only on the card")
    run = run_m.run_cell(load.cell(cell), SEED, 1.0, False,
                         hook=hook("control"))
    assert not run.correct, run.checks
