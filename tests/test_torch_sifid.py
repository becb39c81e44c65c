"""The port's InceptionV3 blocks and SIFID against the JAX package's on
the CPU: every block's output at 1e-4 of its scale, the block shapes at
299², ``init_inception``'s draws bit for bit, the activation statistics
and SIFID at each feature width — with a singular covariance (fewer
positions than channels) and without — and the Fréchet distance's eps
jitter branch taken on both sides."""

import functools
import importlib
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.eval import inception as jinc
from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.eval import inception as pinc

# the packages export a function ``sifid`` under the modules' name
jsifid = importlib.import_module("vst_tpu.eval.sifid")
psifid = importlib.import_module("vst_tpu_torch.eval.sifid")


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
    return jinc.init_inception(3)


def _close(ours, ref, rel):
    """|ours − ref| ≤ rel · max|ref|, elementwise."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_init_inception_bitwise(params):
    ours = pinc.init_inception(3, device="cpu")
    ref = params_from_jax(params)
    assert list(ours) == list(ref)
    for k in ours:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
    assert set(pinc.BLOCK_INDEX_BY_DIM.items()) == set(
        jinc.BLOCK_INDEX_BY_DIM.items())


@pytest.mark.parametrize("hw", [(75, 75), (96, 90)])
def test_blocks_against_jax(params, hw):
    """All four blocks of one run against ``inception_blocks``, block by
    block; the odd and even sizes take the stride-2 convs and the 3×3/2
    pools through both parities."""
    x = np.random.default_rng(0).random((1, *hw, 3)).astype(np.float32)
    ref = jinc.inception_blocks(params, jnp.asarray(x), 3)
    ours = pinc.inception_blocks(params_from_jax(params), x, 3)
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        _close(o.numpy(), np.asarray(r), 1e-4)
    # a shorter run stops at its block with the same outputs
    short = pinc.inception_blocks(params_from_jax(params), x, 1)
    assert len(short) == 2
    torch.testing.assert_close(short[1], ours[1], rtol=0, atol=0)


def test_block_shapes_at_299():
    """torchvision inception_v3's block sizes at 299², as
    tests/test_sifid.py::TestStructure checks the JAX package's."""
    x = np.random.default_rng(1).random((1, 299, 299, 3)).astype(np.float32)
    outs = pinc.inception_blocks(pinc.init_inception(0, device="cpu"), x, 3)
    assert [o.shape[-1] for o in outs] == [64, 192, 768, 2048]
    assert [tuple(o.shape[1:3]) for o in outs] == [
        (147, 147), (71, 71), (17, 17), (8, 8)]


@pytest.mark.parametrize("dims", [64, 192, 768, 2048])
def test_activation_statistics(params, dims):
    """Mean and covariance over positions at 96² (64 and 192: more
    positions than channels; 768: 4² positions, a singular covariance)
    and at 128² for 2048 (2² positions; at 96² it has one)."""
    hw = 128 if dims == 2048 else 96
    x = np.random.default_rng(2).random((1, hw, hw, 3)).astype(np.float32)
    mu, sigma = psifid.activation_statistics(params_from_jax(params), x,
                                             dims)
    jmu, jsigma = jsifid.activation_statistics(params, jnp.asarray(x), dims)
    assert mu.dtype == sigma.dtype == np.float64
    assert sigma.shape == (dims, dims)
    _close(mu, jmu, 1e-4)
    _close(sigma, jsigma, 1e-4)


@pytest.mark.parametrize("dims", [64, 192, 768])
def test_sifid(params, dims):
    """SIFID of two 96² images of different brightness at 1e-3 relative
    (64, 192: non-singular covariances; 768: singular, sqrtm warns), and 0
    for an image against itself.  At 768 the seeded trunk's block 2
    barely depends on its input (both traces 0.4831, the means 3e-4
    apart), so the distance is round-off of that scale (about −1e-7 in
    both packages) and is held at 1e-6 absolute."""
    rng = np.random.default_rng(3)
    a = (rng.random((96, 96, 3)) * 255).astype(np.float32)
    b = (rng.random((96, 96, 3)) ** 3 * 255).astype(np.float32)
    tp = params_from_jax(params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = psifid.sifid(tp, a, b, dims)
        ref = jsifid.sifid(params, a, b, dims)
        same = psifid.sifid(tp, a, a, dims)
    assert ours == pytest.approx(ref, rel=1e-3, abs=1e-6)
    assert dims == 768 or ours > 1e-3
    assert same == pytest.approx(0.0, abs=1e-3)


def test_frechet_jitter_branch(monkeypatch):
    """A nilpotent covariance has no square root: sqrtm gives inf, and
    both packages take the eps-jitter branch (a second sqrtm) to the same
    distance, and ``frechet_distance_branch`` says which branch ran."""
    from scipy import linalg

    calls = []
    sqrtm = linalg.sqrtm

    @functools.wraps(sqrtm)
    def counted(*a, **k):
        calls.append(1)
        return sqrtm(*a, **k)

    monkeypatch.setattr(linalg, "sqrtm", counted)
    s1 = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0]])
    s2 = np.eye(3)
    mu1, mu2 = np.array([0.1, 0.2, 0.3]), np.array([0.0, 0.5, 0.1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = psifid.frechet_distance(mu1, s1, mu2, s2)
        n_ours = len(calls)
        ref = jsifid.frechet_distance(mu1, s1, mu2, s2)
        branch = psifid.frechet_distance_branch(mu1, s1, mu2, s2)
    assert n_ours == 2 and len(calls) == 6
    assert np.isfinite(ours) and ours == ref and branch == (ours, True)
    calls.clear()
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((2, 40, 6))
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    ours = psifid.frechet_distance(a.mean(0), s1, b.mean(0), s2)
    assert len(calls) == 1
    assert ours == jsifid.frechet_distance(a.mean(0), s1, b.mean(0), s2)
    assert psifid.frechet_distance_branch(a.mean(0), s1, b.mean(0),
                                          s2) == (ours, False)
