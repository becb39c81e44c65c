"""The port's AdaAttN training against the JAX package at a small size:
the four losses (values and input gradients), one step of each builder
(metrics and updated parameters), remat against no remat, a bf16 step,
and an 8-step trajectory."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vst_tpu import losses as jl
from vst_tpu.models import adaattn as ja
from vst_tpu.models import vgg as jv
from vst_tpu.train import config as jc
from vst_tpu.train import steps as js
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch import losses as pl
from vst_tpu_torch.compat import params_to_jax
from vst_tpu_torch.models import adaattn as pa
from vst_tpu_torch.models import vgg as pv
from vst_tpu_torch.train import config as pc
from vst_tpu_torch.train import state as ps
from vst_tpu_torch.train import steps as pst

SEED_VGG, SEED_NET = 0, 1


def images(seed, n, count, h=32, w=32):
    rng = np.random.default_rng(seed)
    return [(rng.random((n, h, w, 3)) * 255).astype(np.float32)
            for _ in range(count)]


# ------------------------------------------------------------------ losses

def _feats(rng, shape=(2, 6, 7, 16)):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


LOSSES = {
    "global_stylized_loss": 2,
    "local_feature_loss": 2,
    "cosine_distance": 2,
    "image_similarity_loss": 4,
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_match_jax(rng, name):
    """Values and the gradients of a weighted sum, at rtol 1e-4."""
    xs = _feats(rng)[:LOSSES[name]]
    if name == "image_similarity_loss":   # non-negative features, as ReLU taps
        xs = [np.abs(x) for x in xs]
    jfn, pfn = getattr(jl, name), getattr(pl, name)
    ref = jfn(*map(jnp.asarray, xs))
    weight = np.random.default_rng(1).standard_normal(np.shape(ref))
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * weight),
                      argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    leaves = [torch.from_numpy(x).requires_grad_() for x in xs]
    ours = pfn(*leaves)
    assert ours.dtype == torch.float32
    (ours.double() * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-6)
    for leaf, g in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-6)


def test_global_stylized_loss_uses_bessel():
    x = np.arange(2 * 2 * 3 * 1, dtype=np.float32).reshape(2, 2, 3, 1)
    zero = np.zeros_like(x)
    ours = pl.global_stylized_loss(torch.from_numpy(x), torch.from_numpy(zero))
    flat = x.reshape(2, -1)
    expect = np.mean(flat.mean(1) ** 2) + np.mean(flat.std(1, ddof=1) ** 2)
    np.testing.assert_allclose(float(ours), expect, rtol=1e-6)


# ------------------------------------------------------------------- steps

def _jax_step(kind, cfg, batches, dtype=np.float32):
    """JAX's jitted step over ``batches``; float64 runs under
    ``enable_x64`` with every parameter and input in float64 (the
    reference the float32 runs are held to)."""
    cast = lambda tree: {k: np.asarray(v, dtype) for k, v in tree.items()}
    with jax.enable_x64(dtype == np.float64):
        vp = cast(jv.init_vgg19_adaattn(SEED_VGG))
        opt = make_optimizer(cfg.lr)
        state = j_create(cast(ja.init_stylizing_network(SEED_NET)), opt)
        build = {"image": js.make_adaattn_image_step,
                 "video": js.make_adaattn_video_step}[kind]
        step = build(cfg, vp, opt)
        metrics = []
        for batch in batches:
            state, m = step(state, tuple(x.astype(dtype) for x in batch))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, {k: np.asarray(v, np.float64)
                         for k, v in state.params.items()}


def _port_step(kind, cfg, batches):
    vgg = pv.init_vgg19_adaattn(SEED_VGG, device="cpu")
    state = ps.create(pa.init_stylizing_network(SEED_NET, device="cpu"),
                      cfg.lr)
    build = {"image": pst.make_adaattn_image_step,
             "video": pst.make_adaattn_video_step}[kind]
    step = build(cfg, vgg)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        assert all(v.dtype == torch.float32 and v.dim() == 0
                   for v in m.values())
        metrics.append({k: float(v) for k, v in m.items()})
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    return metrics, params_to_jax(state.model.state_dict()), grads, state


def _configs(kind, **kw):
    if kind == "image":
        return (jc.AdaAttNImageConfig(batch_size=1, **kw),
                pc.AdaAttNImageConfig(batch_size=1, **kw))
    return (jc.AdaAttNVideoConfig(batch_size=1, **kw),
            pc.AdaAttNVideoConfig(batch_size=1, **kw))


def _batches(kind, steps):
    count = 2 if kind == "image" else 3
    return [tuple(images(10 + i, 1, count)) for i in range(steps)]


def assert_params_close(ours, jax32, jax64, params0, grads, rel_l2_floor=0.03,
                        calib_factor=2.0, grad_floor=1e-3):
    """The masked relative-L2 check of tests/test_train_parity.py, against
    JAX's float64 run: keys that did not move there (the g conv bias, to
    which softmax is invariant, has a true gradient of about 0) are masked,
    and each other key's movement-relative L2 distance from the float64
    parameters must stay within max(floor, calib_factor × JAX float32's
    own distance from them).  The seeded models' gradients are tiny (the
    decoder's output is small), so float32 alone puts JAX 2–20% from its
    float64 gradients in the attention convs: the bound is that noise.

    Adam's first steps are about ±lr whatever the gradient's size, so an
    element whose gradient lies within float32 noise of 0 steps either way.
    Such elements (the port's last gradient at most ``grad_floor`` of its
    key's largest) are masked too: in the video step, element 169 of
    ``decoder.conv3.1.conv.conv.bias`` has a port gradient of 3.4e-7
    against the key's 4.1e-4 and steps −9.7e-5 where float64 steps
    +9.8e-5, which alone puts the key at 0.169 against a bound of 0.03
    (floor; 2 × JAX float32's noise is 0.006)."""
    moves = {k: np.linalg.norm(jax64[k] - np.asarray(params0[k], np.float64))
             for k in jax64}
    top = max(moves.values())
    mask = [k for k, mv in moves.items() if mv > 1e-3 * top]
    assert len(mask) >= len(jax64) // 2, f"mask too small: {len(mask)}"
    bad = {}
    for key in mask:
        g = np.abs(grads[key])
        held = g > grad_floor * g.max()
        err = np.linalg.norm((ours[key] - jax64[key])[held]) / moves[key]
        noise = np.linalg.norm(jax32[key] - jax64[key]) / moves[key]
        bound = max(rel_l2_floor, calib_factor * noise)
        if err > bound:
            bad[key] = (err, bound)
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1][0])[:5]


@pytest.fixture(scope="module", params=["image", "video"])
def one_step(request):
    kind = request.param
    jcfg, pcfg = _configs(kind)
    batches = _batches(kind, 1)
    return (kind, _jax_step(kind, jcfg, batches),
            _jax_step(kind, jcfg, batches, np.float64),
            _port_step(kind, pcfg, batches))


def test_step_metrics_match_jax(one_step):
    kind, (jm, _), _, (pm, *_) = one_step
    keys = {"loss_gs", "loss_lf", "loss"} | ({"loss_is"} if kind == "video"
                                             else set())
    assert set(pm[0]) == set(jm[0]) == keys
    for key in keys:
        np.testing.assert_allclose(pm[0][key], jm[0][key], rtol=2e-3,
                                   err_msg=key)


def test_step_params_match_jax(one_step):
    """The updated parameters, through ``params_to_jax``."""
    _, (_, jax32), (_, jax64), (_, ours, grads, state) = one_step
    assert state.step == 1
    assert_params_close(ours, jax32, jax64,
                        ja.init_stylizing_network(SEED_NET),
                        params_to_jax(grads))


@pytest.mark.parametrize("kind", ["image", "video"])
def test_remat_matches_no_remat(kind):
    """cfg.remat (VGG segments, attention modules, decoder, conv-free
    target under torch.utils.checkpoint) gives the same losses and
    gradients, in softmax for both builders."""
    _, pcfg = _configs(kind, activation="softmax")
    batches = _batches(kind, 1)
    runs = []
    for remat in (False, True):
        m, _, grads, _ = _port_step(kind, dataclasses.replace(pcfg, remat=remat),
                                    batches)
        runs.append((m[0], grads))
    for key in runs[0][0]:
        np.testing.assert_allclose(runs[1][0][key], runs[0][0][key],
                                   rtol=1e-6, err_msg=key)
    for key, g in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][key], g, rtol=1e-5, atol=1e-9)


def test_bf16_step_is_finite():
    """cfg.dtype bfloat16 on the CPU: the masters stay float32 and move,
    the metrics are finite."""
    _, pcfg = _configs("image", dtype="bfloat16")
    params0 = params_to_jax(
        pa.init_stylizing_network(SEED_NET, device="cpu").state_dict())
    metrics, ours, grads, state = _port_step("image", pcfg,
                                             _batches("image", 2))
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(g.dtype == torch.float32 for g in grads.values())
    moved = sum(not np.array_equal(ours[k], params0[k]) for k in params0)
    assert moved >= len(params0) - 3    # the g biases may not move


def test_create_rejects_non_f32_masters():
    with pytest.raises(TypeError, match="float32"):
        ps.create(pa.init_stylizing_network(SEED_NET, device="cpu",
                                            dtype=torch.bfloat16), 1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["image", "video"])
def test_trajectory_matches_jax(kind):
    """8 steps on fresh batches: the losses agree at every step (any
    gradient or optimizer error compounds into them) and the final
    parameters pass the masked relative-L2 check."""
    jcfg, pcfg = _configs(kind)
    batches = _batches(kind, 8)
    jm, jax32 = _jax_step(kind, jcfg, batches)
    _, jax64 = _jax_step(kind, jcfg, batches, np.float64)
    pm, ours, grads, _ = _port_step(kind, pcfg, batches)
    np.testing.assert_allclose([m["loss"] for m in pm],
                               [m["loss"] for m in jm], rtol=2e-3)
    assert_params_close(ours, jax32, jax64,
                        ja.init_stylizing_network(SEED_NET),
                        params_to_jax(grads))
