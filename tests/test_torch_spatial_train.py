"""Data × space training of the port on real spawned gloo groups
(tests/torch_dist.py): the ReCoNet flow step with its batch placed by
``shard_batch_spatial`` on a ("data", "space") mesh, against JAX's
single-device step (as tests/test_parallel.py's ``Test2DMeshComposition``
holds JAX's own (4 × 2) step) and against the port's single-process step,
every rank's parameters equal bit for bit; ``shard_batch_spatial``'s
layout and its ``ValueError``; and K1's halo-rows Function
(``Conv3x3InStatsHalo``) against ``jax.vjp`` of its VALID form.

Each world's ranks are spawned once for all their steps (module-scoped
caches), and each JAX step is compiled once."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.models import reconet as jr
from vst_tpu.models import vgg as jv
from vst_tpu.train import config as jc
from vst_tpu.train import steps as js
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch.compat import params_to_jax
from vst_tpu_torch.kernels import res_block
from vst_tpu_torch.train import config as pc
from tests import torch_dist as td
from tests.test_torch_reconet_train import EPS, GRAD_TOL, TORCH, _rel, _x64

H, W = 32, 24
RNG = np.random.default_rng(0)
STYLE = (RNG.random((1, H, W, 3)) * 255).astype(np.float32)


def _flow_batch(n, frames=1):
    return ((RNG.random((n, H, W, 3 * frames)) * 255).astype(np.float32),
            (RNG.random((n, H, W, 3 * frames)) * 255).astype(np.float32),
            (RNG.standard_normal((n, H, W, 2)) * 2).astype(np.float32),
            (RNG.random((n, H, W)) > 0.2).astype(np.float32))


BATCH4 = _flow_batch(4)
BATCH4F = _flow_batch(2, 4)
FIELDS = dict(img_size=(H, W))
# case → (config fields, global batch, mesh shape, world, JAX reference);
# the last case has no JAX reference of its own (the port's
# single-process step is held against JAX in test_torch_reconet_steps)
CASES = {
    "2x2": (FIELDS, BATCH4, (2, 2), 4, True),
    "1x4": (FIELDS, BATCH4, (1, 4), 4, True),
    "1x2_remat_4frame": (dict(FIELDS, input_frame_num=4, remat=True),
                         BATCH4F, (1, 2), 2, True),
    "1x2_no_ftl": (dict(FIELDS, use_ftl=False),
                   tuple(a[:2] for a in BATCH4), (1, 2), 2, False),
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(case):
    return dataclasses.replace(pc.RECONET_CANDY, **CASES[case][0])


def _cached(fn):
    cache = {}

    def get(key):
        if key not in cache:
            cache[key] = fn(key)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """case → every rank's (metrics, gradients (rank 0), parameters); each
    world spawned once for all of its cases.  "layout" → world 4's
    ``shard_batch_spatial`` results on the (2 × 2) mesh."""
    worlds = {}

    def run(world):
        names = [k for k, v in CASES.items() if v[3] == world]
        ranks = td.spawn(td.spatial_flow_steps, world,
                         tmp_path_factory.mktemp(f"steps{world}"),
                         [(_cfg(k), CASES[k][1], CASES[k][2])
                          for k in names], STYLE, timeout=240.0)
        out = {k: [r[i + 1] for r in ranks] for i, k in enumerate(names)}
        out["layout"] = [r[0] for r in ranks]
        return out

    def get(case):
        world = 4 if case == "layout" else CASES[case][3]
        if world not in worlds:
            worlds[world] = run(world)
        return worlds[world][case]

    return get


@pytest.fixture(scope="module")
def single():
    """case → the port's single-process step on the global batch."""
    return _cached(lambda case: td.reconet_flow_step(
        0, 1, _cfg(case), CASES[case][1], STYLE, False))


@pytest.fixture(scope="module")
def jax_step():
    """case → JAX's single-device step (metrics, parameters)."""
    def run(case):
        cfg = dataclasses.replace(jc.RECONET_CANDY, **CASES[case][0])
        vp = jv.init_vgg16_reconet(0)
        opt = make_optimizer(cfg.lr)
        step = js.make_reconet_flow_step(
            cfg, vp, js.reconet_style_grams(vp, jnp.asarray(STYLE)), opt)
        s, m = step(j_create(jr.init_reconet(0, cfg.input_frame_num), opt),
                    tuple(map(jnp.asarray, CASES[case][1])))
        return ({k: float(v) for k, v in m.items()},
                {k: np.asarray(v) for k, v in s.params.items()})

    return _cached(run)


JAX_CASES = [k for k, v in CASES.items() if v[4]]


@pytest.mark.parametrize("case", JAX_CASES)
def test_flow_step_matches_jax(sharded, jax_step, case):
    """Every metric (FTL, OTL, CL, SL, RL, loss: the global batch's, summed
    over "space", averaged over "data") within rtol 1e-4 of JAX's
    single-device step, and the parameters within Adam's ±lr envelope
    (atol 2.1·lr): JAX's own bounds for its (4 × 2) step."""
    m_j, p_j = jax_step(case)
    m, _, p = sharded(case)[0]
    for key in m_j:
        np.testing.assert_allclose(m[key], m_j[key], rtol=1e-4, err_msg=key)
    ours = params_to_jax({k: torch.from_numpy(v) for k, v in p.items()})
    lr = _cfg(case).lr
    for key, ref in p_j.items():
        np.testing.assert_allclose(ours[key], ref, atol=2.1 * lr,
                                   err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_flow_step_matches_single_process(sharded, single, case):
    """Against the port's single-process step on the global batch: the
    metrics within rtol 1e-5; the reduced gradients within 1e-4 of each
    key's largest (the conv biases an instance norm follows, whose true
    gradient is 0, aside); the update is Adam's first step on them,
    p0 − lr·g/(|g| + eps), within 1e-3·lr at every element, and within
    1e-3·lr of the single-process parameters wherever that step's
    gradient lies above the gradient tolerance (below it float32 rounding
    decides the sign of a ±lr step, and JAX's bound, 2.1·lr, holds)."""
    cfg = _cfg(case)
    m_1, g_1, p_1 = single(case)
    m, g, p = sharded(case)[0]
    assert set(m) == set(m_1)
    for key in m_1:
        np.testing.assert_allclose(m[key], m_1[key], rtol=1e-5, err_msg=key)
    p0 = td._seeded(0, cfg.input_frame_num).state_dict()
    top = max(np.abs(v).max() for v in g_1.values())
    for key, ref in g_1.items():
        np.testing.assert_allclose(
            p[key], p0[key].numpy() - cfg.lr * g[key] / (np.abs(g[key])
                                                         + 1e-8),
            rtol=0, atol=1e-3 * cfg.lr, err_msg=key)
        scale = np.abs(ref).max()
        if scale < 1e-6 * top:   # a bias before an instance norm
            continue
        np.testing.assert_allclose(g[key], ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=key)
        firm = np.abs(ref) > 1e-4 * scale
        np.testing.assert_allclose(p[key][firm], p_1[key][firm], rtol=0,
                                   atol=1e-3 * cfg.lr, err_msg=key)
        np.testing.assert_allclose(p[key], p_1[key], rtol=0,
                                   atol=2.1 * cfg.lr, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_flow_step_ranks_agree_bitwise(sharded, case):
    """Every rank logs the same metrics and holds the same parameters,
    bit for bit, after the step."""
    ranks = sharded(case)
    m0, _, p0 = ranks[0]
    for m, _, p in ranks[1:]:
        assert m == m0
        for key in p0:
            np.testing.assert_array_equal(p[key], p0[key], err_msg=key)


def test_shard_batch_spatial_layout(sharded):
    """On the (2 × 2) mesh rank (d, s) gets dim-0 rows [2d, 2d + 2) and
    H rows [4s, 4s + 4) of every leaf with ndim >= 2 (an NHWC batch and an
    (N, H, W) mask), on its device; an H that does not split raises
    ValueError naming both axes."""
    x = np.arange(4 * 8 * 3 * 2, dtype=np.float32).reshape(4, 8, 3, 2)
    for index, own, own_m, dev, err in sharded("layout"):
        d, s = index["data"], index["space"]
        np.testing.assert_array_equal(own, x[2 * d:2 * d + 2,
                                             4 * s:4 * s + 4])
        np.testing.assert_array_equal(own_m, own[..., 0])
        assert dev == "cpu"
        assert err is not None and "2-way 'space' axis" in err


# ---------------------------------------------------- K1's halo-rows VJP

def _jax_k1_halo(xh, w, b, stats_in=None, gamma=None, beta=None):
    """K1's halo-rows mode in plain JAX: the optional normalize+relu
    prologue, a VALID 3×3 conv over xh (its border rows and columns
    given), and the per-image channel sums Σy, Σy²."""
    v = xh
    if stats_in is not None:
        scale = gamma * jax.lax.rsqrt(stats_in[:, 1] + EPS)
        v = jax.nn.relu((xh - stats_in[:, None, None, 0])
                        * scale[:, None, None] + beta)
    y = jax.lax.conv_general_dilated(
        v, w, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + b
    return y, jnp.stack([y.sum(axis=(1, 2)), (y * y).sum(axis=(1, 2))], 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_halo_function_vjp_matches_jax(dtype, prologue):
    """Every input's gradient of ``Conv3x3InStatsHalo`` (the plain forward
    on the CPU, the VJP the card runs too: a VALID conv, the sums folded
    as gΣy + 2·y·gΣy²) against ``jax.vjp`` of ``_jax_k1_halo``, at
    GRAD_TOL of each gradient's largest element."""
    rng = np.random.default_rng(7)
    n, r, wd, c, co = 2, 6, 7, 16, 12
    args = [rng.standard_normal((n, r + 2, wd + 2, c)) * 3,
            rng.standard_normal((3, 3, c, co)) / np.sqrt(9 * c),
            rng.standard_normal(co) * 0.1]
    if prologue:
        args += [np.stack([rng.standard_normal((n, c)),
                           rng.random((n, c)) + 0.5], 1),
                 rng.random(c) + 0.5, rng.standard_normal(c) * 0.1]
    args = [a.astype(dtype) for a in args]
    cot = (rng.standard_normal((n, r, wd, co)).astype(dtype),
           (rng.standard_normal((n, 2, co)) * 1e-2).astype(dtype))
    with _x64(dtype):
        ref, vjp = jax.vjp(_jax_k1_halo, *map(jnp.asarray, args))
        jgrads = vjp(tuple(map(jnp.asarray, cot)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, sums = res_block.conv3x3_in_stats_halo(*leaves)
    assert y.grad_fn is not None and "Conv3x3InStatsHalo" in str(
        type(y.grad_fn))
    torch.autograd.backward((y, sums), tuple(map(torch.from_numpy, cot)))
    tol = GRAD_TOL[dtype]
    assert _rel(y.detach(), ref[0]) < tol
    assert _rel(sums.detach(), ref[1]) < tol
    for i, (leaf, g) in enumerate(zip(leaves, jgrads)):
        assert leaf.grad.dtype == TORCH[dtype]
        assert _rel(leaf.grad, g) < tol, (i, _rel(leaf.grad, g))
