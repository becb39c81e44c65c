"""Sequence-parallel AdaAttN attention and the data-parallel AdaAttN steps
on real spawned gloo groups (tests/torch_dist.py), against the JAX
package's single-device functions that tests/test_parallel.py holds its
sharded ones against: cosine and ring-softmax moments at D = 2 and 3
against ``attention_moments(mode="exact")`` (with scores of std 30), the
stylizer with ``mesh=``, and ``fold_block`` over D blocks in one
process."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.models import adaattn as ja
from vst_tpu.models import vgg as jv
from vst_tpu_torch.kernels import adaattn_attention as k3
from vst_tpu_torch.parallel import attention as sp
from tests import torch_dist as td


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, n, m, d, c, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in (((b, n, d), scale), ((b, m, d), scale),
                          ((b, m, c), 1.0))]


@pytest.mark.parametrize("activation,world,scale", [
    ("cosine", 2, 1.0),
    ("cosine", 3, 1.0),
    ("softmax", 2, 1.0),
    ("softmax", 3, 1.0),     # the ring's order over three hops
    ("softmax", 3, 30.0),    # scores that overflow a naive exp
])
def test_sharded_moments_match_jax_exact(tmp_path, activation, world, scale):
    """Every rank's full M1, M2 (its shard computed, the rest gathered)
    and its own shard equal JAX's exact moments at 1e-4 (f32)."""
    q, k, v = _qkv(world, 2, 48, 48, 24, 16, scale)
    ref = [np.asarray(t) for t in ja.attention_moments(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), activation,
        mode="exact")]
    for rank, (full, own) in enumerate(td.spawn(
            td.sharded_moments, world, tmp_path, activation, q, k, v)):
        rows = slice(rank * 48 // world, (rank + 1) * 48 // world)
        for ours, mine, r in zip(full, own, ref):
            assert np.isfinite(ours).all()
            np.testing.assert_allclose(ours, r, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(mine, r[:, rows], rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("blocks", [2, 3, 4])
def test_fold_block_equals_one_call(blocks):
    """K3's plain version over D key blocks, folded by logsumexp, equals
    one call over all keys: M1, M2 and L."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 2, 40, 60, 16, 8, 3.0))
    ref = k3.softmax_attention_moments(q, k, v)
    acc = None
    for kb, vb in zip(k.chunk(blocks, 1), v.chunk(blocks, 1)):
        acc = sp.fold_block(acc, *k3.softmax_attention_moments(q, kb, vb))
    for ours, r in zip(acc, ref):
        assert ours.dtype == torch.float32
        torch.testing.assert_close(ours, r.float(), rtol=1e-5, atol=1e-6)


def test_sharded_serve_only(tmp_path):
    """A call that needs a gradient raises (the backward is not ported)."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(1, 1, 4, 4, 8, 8))
    with td.world1(tmp_path) as mesh:
        for fn in (sp.sharded_cosine_attention_moments,
                   sp.sharded_softmax_attention_moments):
            with pytest.raises(NotImplementedError, match="serves only"):
                fn(mesh, q, k, v)
            with torch.no_grad():
                fn(mesh, q, k, v)


@pytest.mark.parametrize("activation", ["cosine", "softmax"])
def test_stylizer_with_mesh_matches_jax(tmp_path, activation):
    """The full stylizer with a 2-rank mesh (cosine: one all-reduce of the
    key moments; softmax: the ring through K3's plain version) on 64×64
    frames against JAX's single-device ``stylizing_network`` at 1e-3."""
    rng = np.random.default_rng(11)
    c, s = ((rng.random((1, 64, 64, 3)) * 255).astype(np.float32)
            for _ in range(2))
    vp, ap = jv.init_vgg19_adaattn(0), ja.init_stylizing_network(1)
    ref = np.asarray(ja.stylizing_network(
        ap, jv.vgg19_adaattn_features(vp, jnp.asarray(c)),
        jv.vgg19_adaattn_features(vp, jnp.asarray(s)), activation))
    for out in td.spawn(td.stylizer_with_mesh, 2, tmp_path, activation, c, s):
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
