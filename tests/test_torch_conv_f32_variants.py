"""The text edits of experiments/conv_f32_variants.py still apply to the
f32 K1/K2 body.

Each variant of the float32 conv body is the shipped
``csrc/conv3x3_tf32.cuh`` with a few (file, old, new) edits, built beside
copies of ``res_block.cu`` and ``head_conv.cu``; an edit that no longer
matches exactly once would only show as a failed build on the card.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variants_module():
    spec = importlib.util.spec_from_file_location(
        "conv_f32_variants",
        os.path.join(ROOT, "experiments", "conv_f32_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CV = _variants_module()
SRC = CV.sources()
VARIANTS = CV.variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_edits_apply_once(name):
    texts = dict(SRC)
    edits, _ = VARIANTS[name]
    for f, old, new in edits:
        assert texts[f].count(old) == 1, old[:80]
        texts[f] = texts[f].replace(old, new)
    assert (texts == SRC) == (name == "shipped")
    assert CV.apply(SRC, edits) == texts


def test_variants_build_beside_both_kernels():
    """The edited header is the one both sources include, and the chained
    variant leaves no fresh partial in the stage loop."""
    for lib in CV.LIBS:
        assert f'#include "{CV.BODY}"' in SRC[f"{lib}.cu"]
    chained = CV.apply(SRC, VARIANTS["chain"][0])[CV.BODY]
    assert "wgmma_tf32n<N>(part" not in chained
    assert "acc[k] += part[k]" not in chained
