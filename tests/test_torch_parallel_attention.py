"""Sequence-parallel AdaAttN attention and the data-parallel AdaAttN steps
on real spawned gloo groups (tests/torch_dist.py), against the JAX
package's single-device functions that tests/test_parallel.py holds its
sharded ones against: cosine and ring-softmax moments at D = 2 and 3
against ``attention_moments(mode="exact")`` (with scores of std 30), the
stylizer with ``mesh=``, and ``fold_block`` over D blocks in one
process.  And their backward: each rank's dQ, dK, dV at D = 2, 3 and 4
against its rows of ``jax.vjp`` of JAX's sharded functions, ``block_grads``
over D × D (query shard, key block) pairs in one process, world 1 bit for
bit the unsharded route, the full tensors through
``attention_moments(mesh=)``, a bf16 ring, and the parameter gradients
through ``stylizing_network(..., mesh=)`` (with and without remat) against
``mesh=None``.  Each world's ranks are spawned once for all of its
gradient cases (``_grad_cases``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.models import adaattn as ja
from vst_tpu.models import vgg as jv
from vst_tpu_torch.kernels import adaattn_attention as k3
from vst_tpu_torch.models import adaattn as pa
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


# ------------------------------------------------------------ gradients

def _cotangents(seed, b, n, c):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, c)).astype(np.float32)
            for _ in range(2)]


def _stylizer_inputs():
    rng = np.random.default_rng(11)
    c, s = ((rng.random((1, 64, 64, 3)) * 255).astype(np.float32)
            for _ in range(2))
    return c, s, rng.standard_normal((1, 64, 64, 3)).astype(np.float32)


# name → (world, case for ``td.sharded_grads``)
SHARD_GRADS = {f"{act} D{world} std{scale:g}": (world, act, scale)
               for act, world, scale in [("cosine", 2, 1.0),
                                         ("cosine", 4, 1.0),
                                         ("softmax", 2, 1.0),
                                         ("softmax", 3, 30.0),
                                         ("softmax", 4, 1.0)]}


def _grad_cases():
    cases = {}
    for name, (world, act, scale) in SHARD_GRADS.items():
        cases[name] = (world, ("shard", act, torch.float32,
                               *_qkv(world, 2, 48, 48, 24, 16, scale),
                               *_cotangents(world + 10, 2, 48, 16)))
    cases["softmax bf16"] = (2, ("shard", "softmax", torch.bfloat16,
                                 *_qkv(5, 2, 48, 48, 24, 16),
                                 *_cotangents(15, 2, 48, 16)))
    for act in ("cosine", "softmax"):
        cases[f"full {act}"] = (2, ("full", act, *_qkv(6, 2, 48, 48, 24, 16),
                                    *_cotangents(16, 2, 48, 16)))
    for act, remat in (("cosine", False), ("softmax", False),
                       ("softmax", True)):
        cases[f"stylizer {act} remat={remat}"] = (
            2, ("stylizer", act, torch.float64, *_stylizer_inputs(), remat))
    return cases


@pytest.fixture(scope="module")
def grad_results(tmp_path_factory):
    """``get(name)`` → every rank's result of ``_grad_cases()[name]``;
    each world's ranks spawned once, for all of its cases."""
    cases, worlds = _grad_cases(), {}

    def get(name):
        world = cases[name][0]
        if world not in worlds:
            names = [k for k, v in cases.items() if v[0] == world]
            ranks = td.spawn(td.sharded_grads, world,
                             tmp_path_factory.mktemp(f"grads{world}"),
                             [cases[k][1] for k in names], timeout=240)
            worlds[world] = {k: [r[i] for r in ranks]
                             for i, k in enumerate(names)}
        return cases[name][1], worlds[world][name]

    return get


def _jax_sharded_vjp(activation, world, q, k, v, c1, c2):
    """``jax.vjp`` of JAX's sharded function on a ``world``-device mesh:
    the full dQ, dK, dV for the cotangents (c1, c2)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vst_tpu.parallel import attention as jpa
    from vst_tpu.parallel import make_mesh as jax_mesh

    mesh = jax_mesh(world, ("data",))
    spec = NamedSharding(mesh, P(None, "data", None))
    fn = getattr(jpa, f"sharded_{activation}_attention_moments")
    args = [jax.device_put(jnp.asarray(a), spec) for a in (q, k, v)]

    @jax.jit
    def grads(q, k, v, c1, c2):
        return jax.vjp(lambda *a: fn(mesh, *a), q, k, v)[1]((c1, c2))

    return [np.asarray(g) for g in grads(*args, jnp.asarray(c1),
                                         jnp.asarray(c2))]


def _close_to_scale(ours, ref, tol, what, scale=None):
    np.testing.assert_allclose(
        ours, ref, rtol=0, atol=tol * (np.abs(ref).max() if scale is None
                                       else scale), err_msg=what)


@pytest.mark.parametrize("name", list(SHARD_GRADS))
def test_sharded_grads_match_jax(grad_results, name):
    """Each rank's dQ, dK, dV (for its rows of a seeded cotangent) equal
    its rows of ``jax.vjp`` of JAX's sharded function on a mesh of the
    same size, within 1e-4 of each gradient's largest (f32): the cosine
    all-reduce's backward and the ring's (K4/K5 plain versions per hop,
    the dK/dV accumulators sent home).  A gradient that is 0 in exact
    arithmetic is held to 1e-4 of the largest of the three: at scores of
    std 30 the softmax is one-hot, JAX's dQ and dK are ~1e-19, and the
    kernels' form dS = A∘(dA − D) leaves the float32 rounding of
    dA − D ≈ 0, as the unsharded route does."""
    (_, act, _, *arrays), ranks = grad_results(name)
    world = len(ranks)
    ref = _jax_sharded_vjp(act, world, *arrays)
    top = max(np.abs(r).max() for r in ref)
    for rank, grads in enumerate(ranks):
        for g, r, what in zip(grads, ref, ("dQ", "dK", "dV")):
            assert np.isfinite(g).all()
            scale = np.abs(r).max()
            _close_to_scale(g, td.rows_of(r, rank, world), 1e-4,
                            f"{name} rank {rank} {what}",
                            scale if scale > 1e-6 * top else top)


def test_ring_grads_bf16(grad_results):
    """A bf16 ring at world 2: each rank's dQ, dK, dV against its rows of
    the port's unsharded bf16 route (K4/K5's plain versions on the CPU),
    within 2 bf16 steps (2^-7 relative) of each gradient's largest."""
    (_, _, dtype, q, k, v, c1, c2), ranks = grad_results("softmax bf16")
    ins = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    ref = torch.autograd.grad(
        k3.softmax_attention_moments(*ins)[:2], ins,
        [torch.from_numpy(c).to(dtype) for c in (c1, c2)])
    for rank, grads in enumerate(ranks):
        for g, r, what in zip(grads, ref, ("dQ", "dK", "dV")):
            _close_to_scale(g, td.rows_of(r.float().numpy(), rank, 2),
                            2 * 2.0 ** -7, f"rank {rank} {what}")


@pytest.mark.parametrize("activation", ["cosine", "softmax"])
def test_attention_moments_mesh_grads(grad_results, activation):
    """``attention_moments(mesh=)`` on full q, k, v at world 2: the
    scatter of the tokens and the gather of M1, M2 are adjoint, so every
    rank's dQ, dK, dV of the full tensors equal the single-device ones
    within 1e-4 of each gradient's largest (f32)."""
    (_, _, *arrays), ranks = grad_results(f"full {activation}")
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays[:3]]
    ref = torch.autograd.grad(pa.attention_moments(*ins, activation), ins,
                              [torch.from_numpy(c) for c in arrays[3:]])
    for rank, grads in enumerate(ranks):
        for g, r, what in zip(grads, ref, ("dQ", "dK", "dV")):
            _close_to_scale(g, r.numpy(), 1e-4, f"rank {rank} {what}")


@pytest.mark.parametrize("activation,remat", [("cosine", False),
                                              ("softmax", False),
                                              ("softmax", True)])
def test_stylizer_grads_with_mesh(grad_results, activation, remat):
    """Every parameter gradient of a fixed loss through
    ``stylizing_network(..., mesh=)`` of the seeded AdaAttN on 64×64
    frames at world 2 equals the ``mesh=None`` gradient within 1e-4 of
    the key's largest, and is the same on both ranks.  In float64: the
    attention convs' true gradients are small sums of cancelling terms,
    which float32 leaves at its rounding noise (the plain K3-K5 and the
    ring run in float64 for float64 input).  With ``remat=True`` the
    ring's forward and its collectives run again inside the backward."""
    _, ranks = grad_results(f"stylizer {activation} remat={remat}")
    (g0, ref), (g1, _) = ranks
    assert set(g0) == set(ref)
    for key in ref:
        assert np.isfinite(g0[key]).all(), key
        np.testing.assert_array_equal(g1[key], g0[key], err_msg=key)
        _close_to_scale(g0[key], ref[key], 1e-4, key)


@pytest.mark.parametrize("blocks", [2, 3, 4])
def test_block_grads_equal_one_call(blocks):
    """``block_grads`` over D query shards × D key blocks, with the global
    L and D: the dQ shares summed over the blocks and the dK, dV shares
    summed over the shards equal ``softmax_attention_moments_bwd_plain``
    over all keys (the backward twin of
    ``test_fold_block_equals_one_call``)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 2, 40, 60, 16, 8, 3.0))
    dm1, dm2 = (torch.from_numpy(a) for a in _cotangents(8, 2, 40, 8))
    m1, m2, lse = k3.softmax_attention_moments(q, k, v)
    ref = k3.softmax_attention_moments_bwd_plain(q, k, v, m1, m2, lse, dm1,
                                                 dm2)
    dd = k3.row_term(m1, m2, dm1, dm2)
    rows = [torch.arange(40).chunk(blocks)[i] for i in range(blocks)]
    keys = [torch.arange(60).chunk(blocks)[j] for j in range(blocks)]
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in rows:
        qs, ls, ds, d1, d2 = (t[:, r].contiguous()
                              for t in (q, lse, dd, dm1, dm2))
        for c in keys:
            pq, pk, pv = sp.block_grads(qs, k[:, c].contiguous(),
                                        v[:, c].contiguous(), ls, ds, d1, d2)
            dq[:, r] += pq
            dk[:, c] += pk
            dv[:, c] += pv
    for ours, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(ours, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ["cosine", "softmax"])
def test_world1_grads_bitwise(tmp_path, activation):
    """At world 1 (``td.world1``) the sharded function's forward and its
    dQ, dK, dV are bit for bit the unsharded route's (``attention_moments``
    without a mesh), in f32 and bf16, and so are those of
    ``attention_moments(mesh=)``; under ``torch.no_grad()`` it serves."""
    fn = {"cosine": sp.sharded_cosine_attention_moments,
          "softmax": sp.sharded_softmax_attention_moments}[activation]
    arrays = _qkv(1, 2, 16, 24, 8, 8)
    cot = _cotangents(2, 2, 16, 8)
    with td.world1(tmp_path) as mesh:
        for dtype in (torch.float32, torch.bfloat16):
            def grads(f):
                ins = [torch.from_numpy(a).to(dtype).requires_grad_()
                       for a in arrays]
                out = f(*ins)
                return out, torch.autograd.grad(
                    out, ins, [torch.from_numpy(c).to(out[0].dtype)
                               for c in cot])

            ref = grads(lambda *t: pa.attention_moments(*t, activation))
            for f in (lambda *t: fn(mesh, *t),
                      lambda *t: pa.attention_moments(*t, activation,
                                                      mesh=mesh)):
                got = grads(f)
                for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
                    assert a.dtype == b.dtype
                    assert torch.equal(a, b), (activation, dtype)
            with torch.no_grad():
                ins = [torch.from_numpy(a).to(dtype).requires_grad_()
                       for a in arrays]
                out = fn(mesh, *ins)
                assert not any(t.requires_grad for t in out)
                for a, b in zip(out, ref[0]):
                    assert torch.equal(a, b.detach())
