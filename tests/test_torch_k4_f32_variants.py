"""The text edits of experiments/k4_f32_variants.py still apply to the f32
K4's sources.

Each variant of the float32 K4 is the shipped ``csrc/adaattn_bwd.cu`` and
``csrc/attn_common.cuh`` with a few (file, old, new) edits; an edit that
no longer matches exactly once would only show as a failed build on the
card.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variants_module():
    spec = importlib.util.spec_from_file_location(
        "k4_f32_variants",
        os.path.join(ROOT, "experiments", "k4_f32_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


K4V = _variants_module()
SRC = K4V.sources()
VARIANTS = K4V.variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_edits_apply_once(name):
    texts = dict(SRC)
    edits, _ = VARIANTS[name]
    for f, old, new in edits:
        assert texts[f].count(old) == 1, old[:80]
        texts[f] = texts[f].replace(old, new)
    assert (texts == SRC) == (name == "shipped")
