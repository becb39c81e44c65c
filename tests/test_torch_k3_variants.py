"""The text edits of experiments/k3_variants.py still apply to K3's source.

Each variant of the bf16 K3 is the shipped ``csrc/adaattn_fwd.cu`` with a
few (old, new) edits; an edit that no longer matches exactly once would
only show as a failed build on the card.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variants_module():
    spec = importlib.util.spec_from_file_location(
        "k3_variants", os.path.join(ROOT, "experiments", "k3_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


K3V = _variants_module()
SRC = open(K3V.SRC_PATH).read()
VARIANTS = K3V.variants(SRC)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_edits_apply_once(name):
    edits, _ = VARIANTS[name]
    text = SRC
    for old, new in edits:
        assert text.count(old) == 1, old[:80]
        text = text.replace(old, new)
    assert (text == SRC) == (name == "shipped")
