"""The port's own launch counters (``<wrapper>.launches`` on its
hand-written kernels), read over the window.  Each file
``portbench/launches/*.json`` maps a short name to ``module:wrapper``.
The counts are printed on standard error before the result; nothing is
gated on them."""

import glob
import importlib
import os

from portbench.core.load import PKG, read_json


def counters():
    """{name: "module:wrapper"} of every file in ``launches/``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(PKG, "launches", "*.json"))):
        out.update(read_json(path))
    return out


def _wrapper(target):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def reset():
    """Every counter to 0 (at the window's start)."""
    for target in counters().values():
        _wrapper(target).launches = 0


def read():
    """{name: launches since ``reset``}."""
    return {name: _wrapper(t).launches for name, t in counters().items()}


def per_unit(counts, units, unit):
    """One line: launches of each kernel per frame, image or step."""
    if not counts or not units:
        return f"launches per {unit}: none read"
    return f"launches per {unit} ({units} in the window): " + ", ".join(
        f"{k} {v / units:.4g}" for k, v in counts.items())
