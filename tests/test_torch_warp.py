"""The port's warp (``vst_tpu_torch/ops/warp.py``) against the JAX
package's ``vst_tpu/ops/warp.py``: grid sampling, backward warping and the
occlusion mask, values and gradients, on the cases of
tests/test_ops_parity.py::TestWarp at its tolerance (1e-4; 1e-3 for the
grid's gradient there)."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vst_tpu_torch.ops import warp as pw

# the module (vst_tpu.ops re-exports a function of the same name)
jw = importlib.import_module("vst_tpu.ops.warp")


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [3, 48])
def test_warp_matches_jax(rng, padding_mode, c):
    """Both of JAX's gathers (corner-packed at C ≤ 32, per corner above)
    against the port's single grid_sample, flows reaching off the image."""
    x = rand(rng, 2, 24, 30, c)
    flow = rand(rng, 2, 24, 30, 2) * 6
    ref = jw.warp(jnp.asarray(x), jnp.asarray(flow), padding_mode)
    ours = pw.warp(torch.from_numpy(x), torch.from_numpy(flow), padding_mode)
    assert ours.shape == x.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_grid_sample_extreme_coords(rng):
    x = rand(rng, 1, 16, 16, 2)
    grid = rand(rng, 1, 10, 12, 2) * 1.5
    ref = jw.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid))
    ours = pw.grid_sample_bilinear(torch.from_numpy(x), torch.from_numpy(grid))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_grads_match_jax(rng, padding_mode):
    """The gradients of x and of the grid, at non-integer, partly
    out-of-bounds positions (off the floor's measure-zero kinks)."""
    x = rand(rng, 2, 9, 11, 3)
    grid = rand(rng, 2, 7, 8, 2) * 0.9 + 0.013
    cot = rand(rng, 2, 7, 8, 3)
    dx, dgrid = jax.grad(
        lambda a, g: jnp.sum(jw.grid_sample_bilinear(a, g, padding_mode)
                             * jnp.asarray(cot)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(grid))
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(grid).requires_grad_()
    (pw.grid_sample_bilinear(xt, gt, padding_mode)
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(dgrid), rtol=1e-3,
                               atol=1e-3)


def test_warp_grads_match_jax(rng):
    """warp's gradient of the warped tensor and of the flow."""
    x = rand(rng, 2, 12, 14, 4)
    flow = rand(rng, 2, 12, 14, 2) * 3 + 0.013
    cot = rand(rng, 2, 12, 14, 4)
    dx, dflow = jax.grad(
        lambda a, f: jnp.sum(jw.warp(a, f) * jnp.asarray(cot)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(flow))
    xt = torch.from_numpy(x).requires_grad_()
    ft = torch.from_numpy(flow).requires_grad_()
    (pw.warp(xt, ft) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(dflow), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("threshold", [2.0, 0.5])
def test_flow_warp_mask_matches_jax(rng, batched, threshold):
    """The forward/backward consistency mask, batched (N, H, W, 2) or one
    (H, W, 2) flow pair: equal everywhere but where the round trip's error
    lies within float32 rounding of the threshold."""
    shape = (2, 20, 26, 2) if batched else (20, 26, 2)
    f01 = rand(rng, *shape) * 2
    f10 = -f01 + rand(rng, *shape) * 0.8
    ref = np.asarray(jw.flow_warp_mask(jnp.asarray(f01), jnp.asarray(f10),
                                       threshold=threshold))
    ours = pw.flow_warp_mask(torch.from_numpy(f01), torch.from_numpy(f10),
                             threshold=threshold).numpy()
    assert ours.shape == shape[:-1] and ours.dtype == np.float32
    assert set(np.unique(ours)) <= {0.0, 1.0}
    assert 0 < ours.mean() < 1
    # where the two disagree, the error is at the threshold
    t = torch.from_numpy
    grid = pw._pixel_grid(20, 26, torch.float32, "cpu")
    f01b, f10b = (t(f01), t(f10)) if batched else (t(f01)[None], t(f10)[None])
    warped = pw.warp((grid + f01b).contiguous(), f10b)
    err = (warped - grid).abs().sum(-1).numpy().reshape(ours.shape)
    differ = ours != ref
    assert np.all(np.abs(err[differ] - threshold) < 1e-4)
    assert differ.mean() < 1e-3


def test_float64_warp_stays_float64(rng):
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 2)))
    flow = torch.from_numpy(rng.standard_normal((1, 5, 6, 2)))
    assert pw.warp(x, flow).dtype == torch.float64
