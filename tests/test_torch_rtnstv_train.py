"""The port's RTNSTV training against the JAX package at a small size: the
VGG19 RTNSTV taps, ``rtnstv_style_grams``, both losses (values and input
gradients), one ``make_rtnstv_step`` against JAX's jitted step in float32
and float64, remat, a bf16 step, and a slow multi-step trajectory."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vst_tpu import losses as jl
from vst_tpu.models import rtnstv as jr
from vst_tpu.models import vgg as jv
from vst_tpu.ops import gram_matrix_hw as j_gram_hw
from vst_tpu.train import config as jc
from vst_tpu.train import steps as js
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch import losses as pl
from vst_tpu_torch.compat import params_to_jax
from vst_tpu_torch.models import rtnstv as pr
from vst_tpu_torch.models import vgg as pv
from vst_tpu_torch.train import config as pc
from vst_tpu_torch.train import state as ps
from vst_tpu_torch.train import steps as pst
from tests.test_torch_adaattn_train import assert_params_close
from tests.test_torch_reconet_steps import _flow_mask, images

SEED_VGG, SEED_NET = 0, 1
H, W = 32, 40


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and torch's default of one thread per core oversubscribes them
    (these steps then ran 50× slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _style():
    return images(np.random.default_rng(20), 1)


def _batches(steps, seed=10):
    rng = np.random.default_rng(seed)
    return [(images(rng, 2), images(rng, 2)) + _flow_mask(rng, 2, H, W)
            for _ in range(steps)]


def _configs(**kw):
    return (dataclasses.replace(jc.RTNSTVConfig(), img_size=(H, W), **kw),
            dataclasses.replace(pc.RTNSTVConfig(), img_size=(H, W), **kw))


def _jax_run(cfg, batches, dtype=np.float32):
    """JAX's jitted RTNSTV step over ``batches``; float64 under
    ``enable_x64`` with every parameter and input in float64."""
    cast = lambda tree: {k: np.asarray(v, dtype) for k, v in tree.items()}
    with jax.enable_x64(dtype == np.float64):
        vp = cast(jv.init_vgg19_rtnstv(SEED_VGG))
        grams = js.rtnstv_style_grams(vp, jnp.asarray(_style(), dtype))
        opt = make_optimizer(cfg.lr)
        state = j_create(cast(jr.init_stylizing_network(SEED_NET)), opt)
        step = js.make_rtnstv_step(cfg, vp, grams, opt)
        metrics = []
        for batch in batches:
            state, m = step(state, tuple(x.astype(dtype) for x in batch))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, {k: np.asarray(v, np.float64)
                         for k, v in state.params.items()}


def _port_run(cfg, batches):
    vgg = pv.init_vgg19_rtnstv(SEED_VGG, device="cpu")
    state = ps.create(pr.init_stylizing_network(SEED_NET, device="cpu"),
                      cfg.lr)
    step = pst.make_rtnstv_step(cfg, vgg, pst.rtnstv_style_grams(vgg,
                                                                 _style()))
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        assert all(v.dtype == torch.float32 and v.dim() == 0
                   for v in m.values())
        metrics.append({k: float(v) for k, v in m.items()})
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    return metrics, params_to_jax(state.model.state_dict()), grads, state


def test_vgg19_rtnstv_taps_match_jax(rng):
    """The seeded VGG19's four RTNSTV taps (relu1_2/2_2/3_2/4_2, the
    input normalized inside) and the remat forward against JAX's
    ``vgg19_rtnstv_features`` at rtol 1e-4 (float32 convs over up to
    4608 terms)."""
    x = images(rng, 2, h=24, w=32)
    ref = jv.vgg19_rtnstv_features(jv.init_vgg19_rtnstv(3), jnp.asarray(x))
    vgg = pv.init_vgg19_rtnstv(3, device="cpu")
    assert list(pv.VGG19_TAPS_RTNSTV.values()) == [3, 8, 13, 22]
    for remat in (False, True):
        ours = pv.vgg19_rtnstv_features(vgg, torch.from_numpy(x),
                                        remat=remat)
        assert list(ours) == list(ref)
        for k in ref:
            scale = np.abs(np.asarray(ref[k])).max()
            np.testing.assert_allclose(ours[k].detach().numpy(),
                                       np.asarray(ref[k]), rtol=1e-4,
                                       atol=1e-5 * scale, err_msg=k)


def test_style_grams_match_jax():
    """``rtnstv_style_grams``: (1, C, C) per tap, / (H·W), rtol 1e-5 of
    each gram's scale."""
    ref = js.rtnstv_style_grams(jv.init_vgg19_rtnstv(SEED_VGG),
                                jnp.asarray(_style()))
    ours = pst.rtnstv_style_grams(pv.init_vgg19_rtnstv(SEED_VGG,
                                                       device="cpu"),
                                  _style())
    assert len(ours) == len(ref) == 4
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.shape == r.shape and o.shape[0] == 1
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def _feats(rng, n=2):
    """An RTNSTV tap dict of nonnegative (post-relu) features."""
    return {k: np.abs(rng.standard_normal((n, h, w, c))).astype(np.float32)
            for k, (h, w, c) in (("relu1_2", (16, 20, 8)),
                                 ("relu2_2", (8, 10, 12)),
                                 ("relu3_2", (4, 5, 16)),
                                 ("relu4_2", (2, 3, 24)))}


def test_spatial_loss_matches_jax(rng):
    """``rtnstv_spatial_loss``: content on relu4_2, H·W grams broadcast
    from the style's batch of one, the sqrt-TV with its 1e-8 clip (a flat
    region makes the clip matter), each term and the gradients of the
    styled features and image against JAX at rtol 1e-5 in float32."""
    cf, sf = _feats(rng), _feats(rng)
    grams = [np.asarray(j_gram_hw(jnp.asarray(f[:1])))
             for f in _feats(rng).values()]
    styled = (rng.random((2, 12, 14, 3)) * 255).astype(np.float32)
    styled[:, :4, :4] = 100.0
    w = (1e7, 5e7, 0.5)
    keys = list(sf)

    def jfn(*args):
        feats = dict(zip(keys, args[:4]))
        return jl.rtnstv_spatial_loss(
            {k: jnp.asarray(v) for k, v in cf.items()}, feats,
            [jnp.asarray(g) for g in grams], args[4], *w)

    jargs = [jnp.asarray(sf[k]) for k in keys] + [jnp.asarray(styled)]
    ref = jfn(*jargs)
    leaves = [torch.from_numpy(sf[k]).requires_grad_() for k in keys]
    leaves.append(torch.from_numpy(styled).requires_grad_())
    ours = pl.rtnstv_spatial_loss(
        {k: torch.from_numpy(v) for k, v in cf.items()},
        dict(zip(keys, leaves[:4])), [torch.from_numpy(g) for g in grams],
        leaves[4], *w)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(float(o), float(r), rtol=1e-5)
    sum(ours).backward()
    jgrads = jax.grad(lambda *a: sum(jfn(*a)),
                      argnums=tuple(range(5)))(*jargs)
    for leaf, g in zip(leaves, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())


def test_temporal_loss_matches_jax(rng):
    """``rtnstv_temporal_loss``: the warped first frame against the
    second, divided by the channel-expanded mask's sum + 1e-8 (not the
    nonzero count: a mask of 0.5s gives twice the count's value), and the
    styled frames' gradients, rtol 1e-5."""
    s1, s2 = ((rng.random((2, 16, 20, 3)) * 255).astype(np.float32)
              for _ in range(2))
    flow, mask = _flow_mask(rng, 2, 16, 20)
    mask = mask * 0.5
    ref = jl.rtnstv_temporal_loss(jnp.asarray(s1), jnp.asarray(s2),
                                  jnp.asarray(flow), jnp.asarray(mask))
    jgrads = jax.grad(lambda a, b: jl.rtnstv_temporal_loss(
        a, b, jnp.asarray(flow), jnp.asarray(mask)), argnums=(0, 1))(
            jnp.asarray(s1), jnp.asarray(s2))
    leaves = [torch.from_numpy(s).requires_grad_() for s in (s1, s2)]
    ours = pl.rtnstv_temporal_loss(*leaves, torch.from_numpy(flow),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)
    ours.backward()
    for leaf, g in zip(leaves, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * np.abs(g).max())


@pytest.fixture(scope="module")
def one_step():
    """One step in JAX float32, JAX float64 and the port (float32)."""
    jcfg, pcfg = _configs()
    batches = _batches(1)
    return (_jax_run(jcfg, batches), _jax_run(jcfg, batches, np.float64),
            _port_run(pcfg, batches))


def test_step_metrics_match_jax(one_step):
    """CL, SL, RL, TL and the total within 1e-4 relative of JAX float32's
    and of JAX float64's."""
    (jm, _), (m64, _), (pm, *_) = one_step
    assert set(pm[0]) == set(jm[0]) == {"CL", "SL", "RL", "TL", "loss"}
    for ref in (jm[0], m64[0]):
        for k, v in ref.items():
            np.testing.assert_allclose(pm[0][k], v, rtol=1e-4, err_msg=k)


def test_step_params_match_jax(one_step):
    """The updated parameters (through ``params_to_jax``: the decoders'
    weights flipped back) held by the masked relative-L2 check against
    JAX float64, calibrated by JAX float32's own distance from it."""
    (_, jax32), (_, jax64), (_, ours, grads, state) = one_step
    assert state.step == 1
    assert_params_close(ours, jax32, jax64,
                        jr.init_stylizing_network(SEED_NET),
                        params_to_jax(grads))


def test_remat_matches_no_remat():
    """cfg.remat (the stylizer checkpointed whole, VGG19 per segment):
    the same metrics, and gradients within 1e-5 of each key's largest."""
    _, pcfg = _configs()
    batches = _batches(1)
    runs = [_port_run(dataclasses.replace(pcfg, remat=remat), batches)
            for remat in (False, True)]
    for key, v in runs[0][0][0].items():
        np.testing.assert_allclose(runs[1][0][0][key], v, rtol=1e-6,
                                   err_msg=key)
    for key, g in runs[0][2].items():
        err = (runs[1][2][key] - g).abs().max() / g.abs().max().clamp_min(
            1e-30)
        assert err < 1e-5, key


def test_bf16_step():
    """cfg.dtype bfloat16: finite metrics over two steps, float32 masters
    with float32 gradients of their own shapes, and they move."""
    _, pcfg = _configs(dtype="bfloat16")
    params0 = jr.init_stylizing_network(SEED_NET)
    metrics, ours, grads, state = _port_run(pcfg, _batches(2))
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    for k, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and grads[k].shape == p.shape, k
        assert grads[k].dtype == torch.float32
    moved = sum(not np.array_equal(ours[k], params0[k]) for k in params0)
    assert moved >= len(params0) - 2


@pytest.mark.slow
def test_trajectory_matches_jax():
    """Five steps on fresh batches: the losses agree at every step (rtol
    2e-3) and the final parameters pass the masked relative-L2 check."""
    jcfg, pcfg = _configs()
    batches = _batches(5, seed=30)
    jm, jax32 = _jax_run(jcfg, batches)
    _, jax64 = _jax_run(jcfg, batches, np.float64)
    pm, ours, grads, _ = _port_run(pcfg, batches)
    np.testing.assert_allclose([m["loss"] for m in pm],
                               [m["loss"] for m in jm], rtol=2e-3)
    assert_params_close(ours, jax32, jax64,
                        jr.init_stylizing_network(SEED_NET),
                        params_to_jax(grads))
