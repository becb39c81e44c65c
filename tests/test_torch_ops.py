"""The port's ops (vst_tpu_torch/ops) against their JAX counterparts on the
same numpy inputs, NHWC at both ends."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from vst_tpu.ops import conv as jconv
from vst_tpu.ops import instance_norm as j_instance_norm
from vst_tpu.ops import reflection_pad2d as j_reflection_pad2d
from vst_tpu.ops import upsample_nearest as j_upsample_nearest
from vst_tpu.ops.yuv import rgb_to_i420 as j_rgb_to_i420
from vst_tpu_torch.ops import (conv2d_nearest_up2, conv2d_polyphase_reflect,
                               conv2d_reflect, instance_norm, polyphase_weights,
                               reflection_pad2d, rgb_to_i420, upsample_nearest,
                               vgg_normalize)
from vst_tpu_torch.ops.constants import device_constant
from vst_tpu_torch.ops.image import (IMAGENET_MEAN, IMAGENET_STD,
                                     rgb_to_luma709)

TOL = dict(rtol=1e-4, atol=1e-4)
SIZES = [(8, 12), (9, 7)]   # even and odd H, W


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def oihw(w):
    return t(w.transpose(3, 2, 0, 1))


def _x(rng, h, w, c):
    return rng.standard_normal((2, h, w, c)).astype(np.float32)


def _w(rng, k, cin, cout):
    return (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("h,w", SIZES)
class TestElementwise:
    def test_reflection_pad(self, rng, h, w):
        x = _x(rng, h, w, 3)
        for pad in (1, 4):
            np.testing.assert_array_equal(
                reflection_pad2d(t(x), pad).numpy(),
                np.asarray(j_reflection_pad2d(jnp.asarray(x), pad)))

    def test_instance_norm(self, rng, h, w):
        x = _x(rng, h, w, 5) * 4 + 1
        s, b = rng.random(5).astype(np.float32), rng.random(5).astype(np.float32)
        np.testing.assert_allclose(
            instance_norm(t(x), t(s), t(b)).numpy(),
            np.asarray(j_instance_norm(jnp.asarray(x), jnp.asarray(s),
                                       jnp.asarray(b))), **TOL)

    def test_upsample_nearest(self, rng, h, w):
        x = _x(rng, h, w, 3)
        np.testing.assert_array_equal(
            upsample_nearest(t(x), 2).numpy(),
            np.asarray(j_upsample_nearest(jnp.asarray(x), 2)))


@pytest.mark.parametrize("h,w", SIZES)
class TestConvForms:
    def test_k3s1(self, rng, h, w):
        x, wt, b = _x(rng, h, w, 6), _w(rng, 3, 6, 5), rng.random(5).astype(np.float32)
        ref = jconv.conv2d_reflect1_k3s1(jnp.asarray(x), jnp.asarray(wt),
                                         jnp.asarray(b))
        np.testing.assert_allclose(
            conv2d_reflect(t(x), oihw(wt), t(b)).numpy(), np.asarray(ref), **TOL)

    def test_k3s2(self, rng, h, w):
        x, wt, b = _x(rng, h, w, 6), _w(rng, 3, 6, 5), rng.random(5).astype(np.float32)
        xj, wj, bj = jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b)
        if h % 2 == 0 and w % 2 == 0:
            ref = jconv.conv2d_reflect1_k3s2(xj, wj, bj)
        else:  # the JAX model routes odd sizes to pad + conv2d
            ref = jconv.conv2d(j_reflection_pad2d(xj, 1), wj, bj, stride=2)
        np.testing.assert_allclose(
            conv2d_reflect(t(x), oihw(wt), t(b), stride=2).numpy(),
            np.asarray(ref), **TOL)

    def test_nearest_up2(self, rng, h, w):
        x, wt, b = _x(rng, h, w, 6), _w(rng, 3, 6, 5), rng.random(5).astype(np.float32)
        ref = jconv.conv2d_nearest_up2(jnp.asarray(x), jnp.asarray(wt),
                                       jnp.asarray(b))
        np.testing.assert_allclose(
            conv2d_nearest_up2(t(x), oihw(wt), t(b)).numpy(), np.asarray(ref),
            **TOL)

    def test_polyphase_reflect_k9(self, rng, h, w):
        """The 9×9 layers (f=4 packing + K2's plain version) against the JAX
        polyphase form where it applies, else pad + conv2d."""
        x, wt, b = _x(rng, h, w, 3), _w(rng, 9, 3, 4), rng.random(4).astype(np.float32)
        xj, wj, bj = jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b)
        if h % 4 == 0 and w % 4 == 0:
            ref = jconv.conv2d_polyphase_reflect(xj, wj, bj, factor=4)
        else:
            ref = jconv.conv2d(j_reflection_pad2d(xj, 4), wj, bj)
        np.testing.assert_allclose(
            conv2d_polyphase_reflect(t(x), oihw(wt), t(b)).numpy(),
            np.asarray(ref), **TOL)


def test_polyphase_weights_match_jax(rng):
    wt = _w(rng, 9, 3, 48)
    np.testing.assert_array_equal(
        polyphase_weights(oihw(wt), 4).numpy(),
        np.asarray(jconv._polyphase_weights(jnp.asarray(wt), 4)))


def _indexed_polyphase(w, f):
    """``polyphase_weights`` as it was with its gather index made on the
    host for every call: the form the kept index must reproduce."""
    cout, cin, k, _ = w.shape
    t = (k + f - 2) // f + 1
    pad = f - 1
    w_pad = F.pad(w.permute(2, 3, 1, 0), (0, 0, 0, 0, pad, pad, pad, pad))
    di = torch.arange(t)[:, None, None]
    p = torch.arange(f)[None, :, None]
    a = torch.arange(f)[None, None, :]
    idx = (f * di + p - a + pad).reshape(-1).to(w.device)
    g = w_pad[idx].reshape(t, f, f, k + 2 * pad, cin, cout)
    g = g[:, :, :, idx].reshape(t, f, f, t, f, f, cin, cout)
    return g.permute(0, 3, 1, 4, 6, 2, 5, 7).reshape(
        t, t, f * f * cin, f * f * cout).contiguous()


# the 9×9 stems and heads (cin, cout): ReCoNet, SD1, SD2
K9_WIDTHS = [(3, 48), (48, 3), (3, 32), (32, 3), (3, 16), (16, 3)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout", K9_WIDTHS)
class TestPolyphaseKeptIndex:
    def test_equals_the_index_form(self, rng, cin, cout, dtype):
        w = oihw(_w(rng, 9, cin, cout)).to(dtype)
        assert torch.equal(polyphase_weights(w, 4), _indexed_polyphase(w, 4))

    def test_gradient_equals_the_index_form(self, rng, cin, cout, dtype):
        """The gather's backward still reaches w, bit for bit the old
        form's.  On one thread: the CPU's index backward sums the gathered
        rows' gradients in a thread-dependent order, so the old form on
        several threads differs from itself in the last bit."""
        w = oihw(_w(rng, 9, cin, cout)).to(dtype)
        cot = t(rng.standard_normal((3, 3, 16 * cin, 16 * cout))
                .astype(np.float32)).to(dtype)
        grads = []
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for fn in (polyphase_weights, _indexed_polyphase):
                leaf = w.clone().requires_grad_()
                fn(leaf, 4).backward(cot)
                grads.append(leaf.grad)
        finally:
            torch.set_num_threads(threads)
        assert torch.equal(*grads)


def _old_normalize(x):
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    mean = torch.tensor(IMAGENET_MEAN, dtype=acc, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=acc, device=x.device)
    return ((x.to(acc) / 255.0 - mean) / std).to(x.dtype)


def _old_luma(x):
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    wts = torch.tensor([0.2126, 0.7152, 0.0722], dtype=acc, device=x.device)
    return (x.to(acc) * wts).sum(dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("fn,old", [(vgg_normalize, _old_normalize),
                                    (rgb_to_luma709, _old_luma)],
                         ids=["vgg_normalize", "rgb_to_luma709"])
def test_kept_constants_give_the_same_bits(rng, fn, old, dtype):
    x = t(rng.random((2, 5, 7, 3)) * 255).to(dtype)
    assert torch.equal(fn(x), old(x))


@pytest.mark.parametrize("call", [
    lambda: polyphase_weights(torch.ones(48, 3, 9, 9), 4),
    lambda: vgg_normalize(torch.ones(1, 2, 2, 3, dtype=torch.bfloat16)),
    lambda: rgb_to_luma709(torch.ones(1, 2, 2, 3, dtype=torch.float64)),
], ids=["polyphase_weights", "vgg_normalize", "rgb_to_luma709"])
def test_constants_are_built_once(call):
    """After a first call has made its constants, a second and a third
    build nothing."""
    call()
    before = device_constant.builds
    call()
    call()
    assert device_constant.builds == before


def test_constant_made_in_inference_mode_serves_a_backward():
    """A constant first asked for under ``torch.inference_mode`` (a served
    forward) is a normal tensor, which a later training step's autograd
    may save."""
    values = (0.125, 0.375, 0.625)
    before = device_constant.builds
    with torch.inference_mode():
        made = device_constant(values, torch.float32, "cpu")
    assert device_constant.builds == before + 1
    assert not made.is_inference()
    x = torch.ones(3, requires_grad=True)
    (x / device_constant(values, torch.float32, "cpu")).sum().backward()
    assert device_constant.builds == before + 1
    torch.testing.assert_close(x.grad, 1 / made)


class TestI420:
    @pytest.mark.parametrize("h,w", [(360, 640), (4, 4), (30, 34)])
    def test_bit_exact_with_jax_and_cv2(self, rng, h, w):
        rgb = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
        ours = rgb_to_i420(t(rgb)).numpy()
        np.testing.assert_array_equal(ours, np.asarray(j_rgb_to_i420(jnp.asarray(rgb))))
        cv2 = pytest.importorskip("cv2")
        for i in range(2):
            np.testing.assert_array_equal(
                ours[i], cv2.cvtColor(rgb[i], cv2.COLOR_RGB2YUV_I420))

    def test_float_input_truncates_like_uint8(self, rng):
        f = (rng.random((1, 16, 20, 3)) * 255.99).astype(np.float32)
        np.testing.assert_array_equal(rgb_to_i420(t(f)).numpy(),
                                      rgb_to_i420(t(f.astype(np.uint8))).numpy())

    def test_odd_shape_rejected(self):
        with pytest.raises(ValueError, match="even"):
            rgb_to_i420(torch.zeros((1, 5, 4, 3)))
