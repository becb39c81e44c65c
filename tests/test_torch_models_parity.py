"""The port's ReCoNet family against the JAX forwards at a batch of two
non-square frames and with a two-frame input window (f32, all taps, the
JAX package's own tolerance against its torch oracles)."""

import numpy as np
import pytest

from tests.test_torch_models import FAMILIES, forward_both, image


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_all_taps_batch2(rng, family):
    ref, ours = forward_both(family, image(rng, 2, 48, 64), seed=11)
    for i, (r, o) in enumerate(zip(ref, ours)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=2e-3, err_msg=f"tap {i}")


def test_two_frame_window(rng):
    ref, ours = forward_both("reconet", image(rng, 1, 32, 32, 6), seed=2,
                             input_frame_num=2)
    for i, (r, o) in enumerate(zip(ref, ours)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-3,
                                   atol=2e-3, err_msg=f"tap {i}")
