"""The port's RAFT (torchvision ``raft_large``) against the JAX package's
on the CPU: ``init_raft``'s draws bit for bit, the correlation pyramid,
the pixel-space bilinear sampler (points outside the level included),
the window lookup and the convex upsampling, the full ``raft_flow`` at
64×64 (a 1×1 coarsest level) and 128×160, and torchvision's key table
both ways, through ``compat_raft`` and the CLI loader."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.compat.raft_torchvision import convert_raft_state_dict as jconv
from vst_tpu.models import raft as jr
from vst_tpu_torch import compat_raft
from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.models import raft as pr
from tests import torch_refs as tr


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jr.init_raft(0)


def test_init_raft_bitwise(params):
    ours = pr.init_raft_numpy(0)
    assert list(ours) == list(params)
    for k in ours:
        np.testing.assert_array_equal(ours[k], params[k], err_msg=k)
    on_cpu = pr.init_raft(0, device="cpu")
    for k, v in params_from_jax(params).items():
        torch.testing.assert_close(on_cpu[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("hw,levels", [((8, 10), 4), ((5, 7), 3)])
def test_corr_pyramid(hw, levels):
    """The all-pairs product and its 2× average pools (odd sizes drop the
    last row/column, down to 1×1)."""
    rng = np.random.default_rng(0)
    f1, f2 = rng.standard_normal((2, 2, *hw, 16)).astype(np.float32)
    ref = jr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels)
    ours = pr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2),
                                 levels)
    assert len(ours) == len(ref) == levels
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_sample_bilinear_pixel():
    """Integer, fractional and out-of-range points (zero padding), on a
    1×1 level as well: no division by (w − 1)."""
    rng = np.random.default_rng(1)
    for shape in ((3, 6, 9), (3, 1, 1)):
        img = rng.standard_normal(shape).astype(np.float32)
        h, w = shape[1:]
        xy = np.stack([rng.uniform(-2.5, w + 1.5, (3, 40)),
                       rng.uniform(-2.5, h + 1.5, (3, 40))], -1)
        xy[:, :4] = np.round(xy[:, :4])
        xy = xy.astype(np.float32)
        ref = jr._sample_bilinear_pixel(jnp.asarray(img), jnp.asarray(xy))
        ours = pr._sample_bilinear_pixel(torch.from_numpy(img),
                                         torch.from_numpy(xy))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
        inside = ((xy[..., 0] > -1) & (xy[..., 0] < w)
                  & (xy[..., 1] > -1) & (xy[..., 1] < h))
        assert (~inside).any() and (ours.numpy()[~inside] == 0).all()


def test_lookup_corr():
    """Radius-4 windows at four levels around displaced positions, the
    x-offset-major channel order included."""
    rng = np.random.default_rng(2)
    f1, f2 = rng.standard_normal((2, 1, 8, 8, 16)).astype(np.float32)
    gy, gx = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    coords = (np.stack([gx, gy], -1)[None]
              + rng.normal(0, 1.5, (1, 8, 8, 2))).astype(np.float32)
    ref = jr.lookup_corr(jr.build_corr_pyramid(jnp.asarray(f1),
                                               jnp.asarray(f2)),
                         jnp.asarray(coords))
    ours = pr.lookup_corr(pr.build_corr_pyramid(torch.from_numpy(f1),
                                                torch.from_numpy(f2)),
                          torch.from_numpy(coords))
    assert ours.shape == (1, 8, 8, 4 * 81)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_convex_upsample():
    rng = np.random.default_rng(3)
    flow = rng.standard_normal((2, 3, 4, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 4, 576)).astype(np.float32)
    ref = jr.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    ours = pr.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("h,w,iters", [(64, 64, 2), (128, 160, 3),
                                       (48, 64, 2)])
def test_raft_flow(params, h, w, iters):
    """The whole model against ``raft_flow`` at rtol 1e-3, atol 2e-4 (the
    JAX package's own tolerance against torchvision's, tests/test_raft.py);
    at 64×64 the coarsest correlation level is 1×1, at 48×64 it is empty
    (its window samples zeros, as JAX's masked gather gives)."""
    rng = np.random.default_rng(4)
    a = (rng.random((1, h, w, 3)) * 2 - 1).astype(np.float32)
    b = (rng.random((1, h, w, 3)) * 2 - 1).astype(np.float32)
    ref = np.asarray(jr.raft_flow(params, jnp.asarray(a), jnp.asarray(b),
                                  iters=iters))
    ours = pr.raft_flow(params_from_jax(params), a, b, iters=iters).numpy()
    assert ours.shape == (1, h, w, 2)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=2e-4)


def test_raft_flow_takes_a_module():
    """``raft_flow`` reads a module's state_dict as its parameters."""
    params = pr.init_raft(1, device="cpu")

    class Holder(torch.nn.Module):
        def state_dict(self, *args, **kwargs):
            return params

    module = Holder()
    x = np.random.default_rng(5).random((1, 64, 64, 3)).astype(np.float32)
    torch.testing.assert_close(pr.raft_flow(module, x, x[:, ::-1].copy(), 1),
                               pr.raft_flow(params, x, x[:, ::-1].copy(), 1),
                               rtol=0, atol=0)


def test_torchvision_key_table(tmp_path):
    """A torchvision-keyed ``raft_large`` state converts to the JAX
    package's conversion (bias-less convs get zero biases), covers
    ``init_raft``'s keys, goes back unchanged, and loads from ``.pth``
    through ``load_raft_pth`` and the CLI loader, as does a JAX ``.npz``."""
    from vst_tpu.train.checkpoint import save_params
    from vst_tpu_torch.cli.common import load_raft_weights

    state = tr.t_raft_random_state(1)
    ours = compat_raft.convert_raft_state_dict(state)
    ref = params_from_jax(jconv(state))
    assert set(ours) == set(ref) == set(pr.init_raft_numpy(0))
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
    back = compat_raft.raft_params_to_torchvision(ours)
    assert set(back) == set(state)
    for k in state:
        torch.testing.assert_close(back[k], state[k], rtol=0, atol=0)
    path = str(tmp_path / "raft_large.pth")
    torch.save({"model": state}, path)
    npz = str(tmp_path / "raft.npz")
    save_params(jconv(state), npz)
    for loaded in (compat_raft.load_raft_pth(path),
                   load_raft_weights(path, "cpu"),
                   load_raft_weights(npz, "cpu")):
        assert set(loaded) == set(ref)
        for k in ref:
            torch.testing.assert_close(loaded[k], ref[k], rtol=0, atol=0)
    assert compat_raft.raft_params(ours) is ours
