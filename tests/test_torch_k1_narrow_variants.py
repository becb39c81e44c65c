"""The text edits of experiments/k1_narrow_variants.py still apply to the
bf16 K1's body and launch.

Each variant of the narrow bf16 K1 is the shipped ``csrc/conv3x3_wgmma.cuh``
or ``csrc/res_block_common.cuh`` with a few (file, old, new) edits, built
beside copies of ``conv3x3_tf32.cuh`` and ``res_block.cu``; an edit that no
longer matches exactly once would only show as a failed build on the card.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variants_module():
    spec = importlib.util.spec_from_file_location(
        "k1_narrow_variants",
        os.path.join(ROOT, "experiments", "k1_narrow_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


KV = _variants_module()
SRC = KV.sources()
VARIANTS = KV.variants()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_edits_apply_once(name):
    texts = dict(SRC)
    edits, _ = VARIANTS[name]
    for f, old, new in edits:
        assert texts[f].count(old) == 1, old[:80]
        texts[f] = texts[f].replace(old, new)
    assert (texts == SRC) == (name == "shipped")
    assert KV.apply(SRC, edits) == texts


def test_variants_build_beside_the_reflect_kernel():
    """The copied headers are the ones the copied source includes (the
    body through conv3x3_tf32.cuh), the variants that compute the function
    are checked, and the timing-only ones are not."""
    assert '#include "conv3x3_tf32.cuh"' in SRC["res_block.cu"]
    assert '#include "res_block_common.cuh"' in SRC["res_block.cu"]
    assert f'#include "{KV.BODY}"' in SRC["conv3x3_tf32.cuh"]
    checked = {name for name, (_, c) in VARIANTS.items() if c}
    assert checked == {"shipped", "mt1", "prologue_launch", "staged"}
    staged = KV.apply(SRC, VARIANTS["staged"][0])[KV.BODY]
    assert "return stats && n < 0;" in staged
