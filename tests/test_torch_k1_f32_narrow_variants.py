"""The text edits of experiments/k1_f32_narrow_variants.py still apply to
the float32 K1's bodies and launch.

Each variant of the float32 K1 at narrow widths is the shipped
``csrc/conv3x3_tf32_narrow.cuh``, ``csrc/conv3x3_tf32.cuh`` or
``csrc/res_block_common.cuh`` with a few (file, old, new) edits, built
beside copies of the others and of ``res_block.cu``; an edit that no
longer matches exactly once would only show as a failed build on the card.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variants_module():
    spec = importlib.util.spec_from_file_location(
        "k1_f32_narrow_variants",
        os.path.join(ROOT, "experiments", "k1_f32_narrow_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


KV = _variants_module()
SRC = KV.sources()
VARIANTS = KV.variants(SRC)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_edits_apply_once(name):
    texts = dict(SRC)
    edits, _ = VARIANTS[name]
    for f, old, new in edits:
        assert texts[f].count(old) == 1, old[:80]
        texts[f] = texts[f].replace(old, new)
    assert (texts == SRC) == (name == "narrow")
    assert KV.kn.apply(SRC, edits) == texts


def test_variants_build_beside_the_reflect_kernel():
    """The copied headers are the ones the copied source includes, the
    variants that compute the function are checked and the timing-only
    ones are not, and every wide variant takes the wide body at C, Co <=
    64."""
    for header in (KV.NARROW, KV.WIDE, KV.COMMON):
        assert f'#include "{header}"' in SRC["res_block.cu"]
    checked = {name for name, (_, c) in VARIANTS.items() if c}
    assert checked == {"narrow", "narrow_two_chains", "narrow_wait1",
                       "narrow_mt1", "wide", "wide_wait1", "wide_tap"}
    for name, (edits, _) in VARIANTS.items():
        if name.startswith("wide"):
            narrow = KV.kn.apply(SRC, edits)[KV.NARROW]
            assert "return c < 0 && co < 0;" in narrow
    wait1 = KV.kn.apply(SRC, VARIANTS["wide_wait1"][0])[KV.WIDE]
    assert "wg::wgmma_wait<1>();" in wait1
