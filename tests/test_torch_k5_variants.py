"""The text edits of experiments/k5_f32_variants.py still apply to K5's
source.

Each variant of the float32 K5 is the shipped ``csrc/adaattn_bwd.cu`` with
a few (old, new) edits; an edit that no longer matches exactly once would
only show as a failed build on the card.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variants_module():
    spec = importlib.util.spec_from_file_location(
        "k5_f32_variants",
        os.path.join(ROOT, "experiments", "k5_f32_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


K5V = _variants_module()
SRC = open(K5V.SRC_PATH).read()
VARIANTS = K5V.variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_edits_apply_once(name):
    text = SRC
    for old, new in VARIANTS[name]:
        assert text.count(old) == 1, old[:80]
        text = text.replace(old, new)
    assert (text == SRC) == (name == "shipped")
