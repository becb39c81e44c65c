"""The port's data parallelism on real spawned gloo groups (the harness in
tests/torch_dist.py): the mesh's rules and layout, the 2-rank ReCoNet
flow step and AdaAttN image step (K3, K4 and K5's plain versions) against
JAX's single-device steps (as tests/test_parallel.py holds JAX's 8-device
step) and against the port's own single-process steps, and the AdaAttN
video step against the port's."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.models import adaattn as ja
from vst_tpu.models import reconet as jr
from vst_tpu.models import vgg as jv
from vst_tpu.train import config as jc
from vst_tpu.train import steps as js
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch.compat import params_to_jax
from vst_tpu_torch.parallel import make_mesh
from vst_tpu_torch.parallel.mesh import _mesh_shape
from vst_tpu_torch.train import config as pc
from tests import torch_dist as td


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- mesh

@pytest.mark.parametrize("n,axes,shape,expect", [
    (8, ("data",), None, (8,)),
    (8, ("data", "space"), None, (4, 2)),     # balanced, data-major
    (6, ("data", "space"), None, (3, 2)),
    (7, ("data", "space"), None, (7, 1)),
    (4, ("a", "b", "c"), (1, 2, 2), (1, 2, 2)),
    (4, ("a", "b", "c"), None, "pass shape="),
    (8, ("data", "space"), (2, 2), r"shape \(2, 2\) != 8 devices"),
])
def test_mesh_shape_rules(n, axes, shape, expect):
    """make_mesh's factoring and errors are JAX's."""
    if isinstance(expect, str):
        with pytest.raises(ValueError, match=expect):
            _mesh_shape(n, axes, shape)
    else:
        assert _mesh_shape(n, axes, shape) == expect


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_mesh_layout_shard_and_replicate(tmp_path):
    """Two ranks as a (1, 2) data×space mesh: the groups, indices and
    rank lists; shard_batch gives rank i rows [2i, 2i+2) on the data axis
    of a 2-way 1-D mesh; replicate broadcasts rank 0's tensors."""
    flat, grid = zip(*td.spawn(td.mesh_layouts, 2, tmp_path))
    for rank, (one, two) in enumerate(zip(flat, grid)):
        assert one["shape"] == {"data": 2} and one["index"] == {"data": rank}
        assert one["ranks"] == {"data": [0, 1]}
        x = np.arange(12, dtype=np.float32).reshape(4, 3)
        np.testing.assert_array_equal(one["own"], x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(one["own_y"], x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(one["w"], np.zeros(3))
        np.testing.assert_array_equal(one["b"], np.zeros(2))
        assert two["shape"] == {"data": 1, "space": 2}
        assert two["index"] == {"data": 0, "space": rank}
        assert two["ranks"] == {"data": [rank], "space": [0, 1]}


# ------------------------------------------------------- data-parallel step

H, W = 16, 24


def _flow_batch(rng, n):
    return ((rng.random((n, H, W, 3)) * 255).astype(np.float32),
            (rng.random((n, H, W, 3)) * 255).astype(np.float32),
            (rng.standard_normal((n, H, W, 2)) * 2).astype(np.float32),
            (rng.random((n, H, W)) > 0.2).astype(np.float32))


def test_dp_reconet_flow_step_matches_single_device(tmp_path):
    """RECONET_CANDY at 16×24, global batch 4 over 2 ranks: the metrics
    (JAX's global-batch losses: FTL and OTL divide by the global mask
    count, RL sums the global batch) within rtol 1e-4 of JAX's
    single-device step, and the parameters within Adam's ±lr step
    envelope (atol 2.1·lr), as tests/test_parallel.py holds JAX's own
    8-device step; against the port's single-process step, the averaged
    gradients within 1e-4 of each key's largest and the updated parameters
    within 1e-3·lr (the conv biases an instance norm follows, whose true
    gradient is 0, aside)."""
    rng = np.random.default_rng(0)
    batch = _flow_batch(rng, 4)
    style = (rng.random((1, H, W, 3)) * 255).astype(np.float32)
    jcfg = dataclasses.replace(jc.RECONET_CANDY, img_size=(H, W))
    pcfg = dataclasses.replace(pc.RECONET_CANDY, img_size=(H, W))

    vp = jv.init_vgg16_reconet(0)
    opt = make_optimizer(jcfg.lr)
    step = js.make_reconet_flow_step(
        jcfg, vp, js.reconet_style_grams(vp, jnp.asarray(style)), opt)
    s_j, m_j = step(j_create(jr.init_reconet(0), opt),
                    tuple(map(jnp.asarray, batch)))

    m_1, g_1, p_1 = td.reconet_flow_step(0, 1, pcfg, batch, style, False)
    ranks = td.spawn(td.reconet_flow_step, 2, tmp_path, pcfg, batch, style,
                     True)
    (m_dp, g_dp, p_dp), (m_r1, _, p_r1) = ranks
    assert m_dp == m_r1
    for key in m_j:
        np.testing.assert_allclose(m_dp[key], float(m_j[key]), rtol=1e-4,
                                   err_msg=key)
        np.testing.assert_allclose(m_dp[key], m_1[key], rtol=1e-5,
                                   err_msg=key)
    for key in p_dp:   # the replicas took the same update
        np.testing.assert_array_equal(p_dp[key], p_r1[key], err_msg=key)
    ours = params_to_jax({k: torch.from_numpy(v) for k, v in p_dp.items()})
    for key in s_j.params:
        np.testing.assert_allclose(ours[key], np.asarray(s_j.params[key]),
                                   atol=2.1 * jcfg.lr, err_msg=key)
    top = max(np.abs(g).max() for g in g_1.values())
    for key, g in g_1.items():
        if np.abs(g).max() < 1e-6 * top:   # a bias before an instance norm
            continue
        np.testing.assert_allclose(g_dp[key], g, rtol=0,
                                   atol=1e-4 * np.abs(g).max(), err_msg=key)
        # the update taken is the single-process step's: Adam's first step
        # moves each weight by lr·g/(|g|+eps), so a gradient of another
        # sign, or an update made before the all-reduce, is off by ~lr
        np.testing.assert_allclose(p_dp[key], p_1[key], rtol=0,
                                   atol=1e-3 * pcfg.lr, err_msg=key)


# --------------------------------------------- data-parallel AdaAttN steps

def _images(seed, n, count, h=32, w=32):
    rng = np.random.default_rng(seed)
    return tuple((rng.random((n, h, w, 3)) * 255).astype(np.float32)
                 for _ in range(count))


def test_dp_adaattn_image_step_matches_single_device(tmp_path):
    """The image step (softmax: K3 forward, K4/K5 backward, their plain
    versions here), global batch 2 over 2 ranks at 32²: the metrics within
    rtol 2e-3 of JAX's single-device step (the tolerance of the port's own
    single step against JAX, tests/test_torch_adaattn_train.py) and 1e-5
    of the port's single-process step, the parameters within Adam's ±lr
    envelope of JAX's (atol 2.1·lr) and equal on both ranks, and the
    decoder's gradients the mean of each rank's shard stepped alone and its
    update Adam's step on that mean (``_assert_mean_of_shards``)."""
    batch = _images(21, 2, 2)
    jcfg = jc.AdaAttNImageConfig(batch_size=2, crop_size=(32, 32))
    pcfg = pc.AdaAttNImageConfig(batch_size=2, crop_size=(32, 32))
    opt = make_optimizer(jcfg.lr)
    s_j, m_j = js.make_adaattn_image_step(
        jcfg, jv.init_vgg19_adaattn(0), opt)(
            j_create(ja.init_stylizing_network(1), opt),
            tuple(map(jnp.asarray, batch)))

    m_1, _, _ = td.adaattn_step(0, 1, "image", pcfg, batch, False)
    (m_dp, g_dp, p_dp), (m_r1, _, p_r1) = td.spawn(
        td.adaattn_step, 2, tmp_path, "image", pcfg, batch, True)
    assert m_dp == m_r1
    for key in m_j:
        np.testing.assert_allclose(m_dp[key], float(m_j[key]), rtol=2e-3,
                                   err_msg=key)
        np.testing.assert_allclose(m_dp[key], m_1[key], rtol=1e-5,
                                   err_msg=key)
    for key in p_dp:
        np.testing.assert_array_equal(p_dp[key], p_r1[key], err_msg=key)
    ours = params_to_jax({k: torch.from_numpy(v) for k, v in p_dp.items()})
    for key in s_j.params:
        np.testing.assert_allclose(ours[key], np.asarray(s_j.params[key]),
                                   atol=2.1 * jcfg.lr, err_msg=key)
    _assert_mean_of_shards("image", pcfg, batch, g_dp, p_dp)


def _assert_mean_of_shards(kind, cfg, batch, g_dp, p_dp):
    """The averaged gradients are the mean of each rank's shard stepped
    alone, within 1e-5 relative L2, at every decoder key, and the decoder's
    updated parameters are Adam's first step on that mean, p0 − lr·ḡ/(|ḡ| +
    eps), within 1e-3·lr: a gradient of another sign, or an update made
    before the all-reduce, is off by ~lr.  (The step on the whole batch in
    one process differs from that mean by about 1e-3: the seeded model's
    moments sit at their variance clamp, where float32 rounding that
    depends on the batch's blocking shows.)"""
    from vst_tpu_torch.models import adaattn as pa

    p0 = pa.init_stylizing_network(1, device="cpu").state_dict()
    halves = [td.adaattn_step(0, 1, kind, cfg, tuple(x[i:i + 1]
                                                     for x in batch),
                              False)[1] for i in range(2)]
    for key in g_dp:
        if key.startswith("decoder."):
            mean = (halves[0][key] + halves[1][key]) / 2
            err = np.linalg.norm(g_dp[key] - mean) / np.linalg.norm(mean)
            assert err < 1e-5, (key, err)
            step = p0[key].numpy() - cfg.lr * mean / (np.abs(mean) + 1e-8)
            np.testing.assert_allclose(p_dp[key], step, rtol=0,
                                       atol=1e-3 * cfg.lr, err_msg=key)


def test_dp_adaattn_video_step_matches_single_process(tmp_path):
    """The video step (cosine; its image-similarity loss sums over the
    batch, so each rank scales its share by the rank count) over 2 ranks
    against the port's single-process step: metrics within 1e-5, and the
    decoder's gradients within 1e-2 relative L2 (the step on the whole
    batch differs from its shards' by float32 rounding at the variance
    clamp, ``_assert_mean_of_shards``, about 1e-3)."""
    batch = _images(22, 2, 3, 32, 64)
    cfg = pc.AdaAttNVideoConfig(batch_size=2, frame_size=(32, 64))
    m_1, g_1, _ = td.adaattn_step(0, 1, "video", cfg, batch, False)
    (m_dp, g_dp, _), _ = td.spawn(td.adaattn_step, 2, tmp_path, "video", cfg,
                                  batch, True)
    assert set(m_dp) == {"loss_gs", "loss_lf", "loss_is", "loss"}
    for key in m_1:
        np.testing.assert_allclose(m_dp[key], m_1[key], rtol=1e-5,
                                   err_msg=key)
    for key, g in g_1.items():
        if key.startswith("decoder."):
            err = np.linalg.norm(g_dp[key] - g) / np.linalg.norm(g)
            assert err < 1e-2, (key, err)
