"""The ops of the port's AdaAttN path (vgg_normalize, conv2d, max_pool2d,
resize_bilinear, feature_down_sample) against their JAX counterparts on
the same numpy inputs, NHWC at both ends, at odd and even sizes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.ops import conv as jconv
from vst_tpu.ops import feature_down_sample as j_feature_down_sample
from vst_tpu.ops import resize_bilinear as j_resize_bilinear
from vst_tpu.ops import vgg_normalize as j_vgg_normalize
from vst_tpu_torch.ops import (conv2d, feature_down_sample, max_pool2d,
                               resize_bilinear, vgg_normalize)

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _x(rng, h, w, c, n=2):
    return rng.standard_normal((n, h, w, c)).astype(np.float32)


def test_vgg_normalize(rng):
    x = (rng.random((2, 7, 9, 3)) * 255).astype(np.float32)
    np.testing.assert_allclose(vgg_normalize(t(x)).numpy(),
                               np.asarray(j_vgg_normalize(jnp.asarray(x))),
                               **TOL)
    xb = t(x).bfloat16()
    ref = np.asarray(j_vgg_normalize(jnp.asarray(x, jnp.bfloat16))
                     .astype(jnp.float32))
    np.testing.assert_array_equal(vgg_normalize(xb).float().numpy(), ref)


@pytest.mark.parametrize("h,w", [(8, 12), (9, 7)])
@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (1, 1, 0), (3, 2, 1)])
def test_conv2d(rng, h, w, k, stride, padding):
    x = _x(rng, h, w, 6)
    wt = (rng.standard_normal((k, k, 6, 5)) * 0.2).astype(np.float32)
    b = rng.random(5).astype(np.float32)
    ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                       stride=stride, padding=padding)
    ours = conv2d(t(x), t(wt.transpose(3, 2, 0, 1)), t(b), stride=stride,
                  padding=padding)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("h,w", [(8, 12), (9, 7)])
def test_max_pool2d(rng, h, w):
    x = _x(rng, h, w, 4)
    np.testing.assert_array_equal(max_pool2d(t(x)).numpy(),
                                  np.asarray(jconv.max_pool2d(jnp.asarray(x))))


@pytest.mark.parametrize("src,dst", [
    ((16, 24), (8, 12)),    # integer ×2 down (feature pyramid)
    ((27, 18), (9, 6)),     # integer ×3 down (odd factor)
    ((32, 48), (8, 12)),    # integer ×4 down
    ((5, 7), (10, 14)),     # ×2 up (decoder), odd sizes
    ((9, 7), (5, 11)),      # dense, down and up at once
])
@pytest.mark.parametrize("bf16", [False, True])
def test_resize_bilinear(rng, src, dst, bf16):
    """float32 to 1e-5; bf16 in and out, within one bf16 rounding."""
    x = t(_x(rng, *src, 3))
    jx = jnp.asarray(x.numpy())
    tol = TOL
    if bf16:
        x, jx = x.bfloat16(), jx.astype(jnp.bfloat16)
        tol = dict(rtol=2.0 ** -8, atol=2.0 ** -8)
    ours = resize_bilinear(x, dst)
    assert ours.dtype == x.dtype
    ref = np.asarray(j_resize_bilinear(jx, dst).astype(jnp.float32))
    np.testing.assert_allclose(ours.float().numpy(), ref, **tol)


@pytest.mark.parametrize("idx", [2, 3, 4])
def test_feature_down_sample(rng, idx):
    sizes = [(32, 48, 4), (16, 24, 6), (8, 12, 8), (4, 6, 8), (2, 3, 8)]
    feats = [_x(rng, *s) for s in sizes]
    ref = j_feature_down_sample([jnp.asarray(f) for f in feats], idx)
    ours = feature_down_sample([t(f) for f in feats], idx)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
