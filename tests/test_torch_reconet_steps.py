"""One step of the port's ReCoNet flow and coco builders (and the noFTL and
4-frame configs) against the JAX package's jitted steps in float32 and
float64 at a small size, and slow multi-step trajectories mirroring
tests/test_train_parity.py::TestReCoNetTrajectories.  The helpers serve
tests/test_torch_reconet_distill.py (the SD1/SD2 steps) and
tests/test_torch_reconet_train.py's port-only steps too."""

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
from vst_tpu_torch.compat import params_from_jax, params_to_jax
from vst_tpu_torch.models import reconet as pr
from vst_tpu_torch.models import vgg as pv
from vst_tpu_torch.train import config as pc
from vst_tpu_torch.train import state as ps
from vst_tpu_torch.train import steps as pst
from tests.test_torch_adaattn_train import assert_params_close

SEED_VGG, SEED_NET, SEED_TEACHER = 0, 1, 2
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


def _x64(dtype):
    return jax.enable_x64(dtype == np.float64)


def _flow_mask(rng, n, h, w):
    flow = (rng.standard_normal((n, h, w, 2)) * 2).astype(np.float32)
    mask = (rng.random((n, h, w)) > 0.2).astype(np.float32)
    return flow, mask


def images(rng, n, c=3, h=H, w=W):
    return (rng.random((n, h, w, c)) * 255).astype(np.float32)


def _style(seed=20):
    return images(np.random.default_rng(seed), 1)


KINDS = {
    # kind: (JAX config, port config, family, teacher family, frames)
    "flow": (jc.RECONET_CANDY, pc.RECONET_CANDY, "reconet", None, 1),
    "noftl": (jc.RECONET_NOFTL, pc.RECONET_NOFTL, "reconet", None, 1),
    "multiframe": (jc.RECONET_MULTIFRAME, pc.RECONET_MULTIFRAME, "reconet",
                   None, 4),
    "coco": (jc.ReCoNetCocoConfig(), pc.ReCoNetCocoConfig(), "reconet",
             None, 1),
    "sd1": (jc.DISTILL_SD1, pc.DISTILL_SD1, "sd1", "reconet", 1),
    "sd2": (jc.DISTILL_SD2, pc.DISTILL_SD2, "sd2", "sd1", 1),
}
J_INIT = {"reconet": jr.init_reconet, "sd1": jr.init_reconet_sd1,
          "sd2": jr.init_reconet_sd2}


def _configs(kind, **kw):
    jcfg, pcfg = KINDS[kind][:2]
    return (dataclasses.replace(jcfg, img_size=(H, W), **kw),
            dataclasses.replace(pcfg, img_size=(H, W), **kw))


def _batches(kind, steps):
    frames = KINDS[kind][4]
    rng = np.random.default_rng(10)
    if kind == "coco":
        return [images(rng, 2) for _ in range(steps)]
    return [(images(rng, 2, 3 * frames), images(rng, 2, 3 * frames))
            + _flow_mask(rng, 2, H, W) for _ in range(steps)]


def _jax_run(kind, cfg, batches, dtype=np.float32):
    """JAX's jitted step over ``batches``; float64 runs under
    ``enable_x64`` with every parameter and input in float64."""
    family, teacher, frames = KINDS[kind][2:]
    cast = lambda tree: {k: np.asarray(v, dtype) for k, v in tree.items()}
    with _x64(dtype):
        vp = cast(jv.init_vgg16_reconet(SEED_VGG))
        grams = js.reconet_style_grams(vp, jnp.asarray(_style(), dtype))
        opt = make_optimizer(cfg.lr)
        state = j_create(cast(J_INIT[family](SEED_NET, frames)), opt)
        if teacher:
            step = js.make_reconet_distill_step(
                cfg, vp, grams, cast(J_INIT[teacher](SEED_TEACHER)), opt)
        elif kind == "coco":
            step = js.make_reconet_coco_step(cfg, vp, grams, opt)
        else:
            step = js.make_reconet_flow_step(cfg, vp, grams, opt)
        metrics = []
        for batch in batches:
            batch = (batch.astype(dtype) if kind == "coco"
                     else tuple(x.astype(dtype) for x in batch))
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, {k: np.asarray(v, np.float64)
                         for k, v in state.params.items()}


def _port_run(kind, cfg, batches):
    family, teacher, frames = KINDS[kind][2:]
    vgg = pv.init_vgg16_reconet(SEED_VGG, device="cpu")
    grams = pst.reconet_style_grams(vgg, _style())
    model = pr.FAMILIES[family](frames)
    model.load_state_dict(params_from_jax(J_INIT[family](SEED_NET, frames)))
    state = ps.create(model, cfg.lr)
    if teacher:
        step = pst.make_reconet_distill_step(
            cfg, vgg, grams, pr.build(teacher, params_from_jax(
                J_INIT[teacher](SEED_TEACHER)), device="cpu"))
    elif kind == "coco":
        step = pst.make_reconet_coco_step(cfg, vgg, grams)
    else:
        step = pst.make_reconet_flow_step(cfg, vgg, grams)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        assert all(v.dtype == torch.float32 and v.dim() == 0
                   for v in m.values())
        metrics.append({k: float(v) for k, v in m.items()})
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    return metrics, params_to_jax(state.model.state_dict()), grads, state


def _assert_metrics(ours, ref, rtol=2e-3):
    assert set(ours) == set(ref)
    for key in ref:
        if np.isnan(ref[key]):
            assert np.isnan(ours[key]), key
        else:
            np.testing.assert_allclose(ours[key], ref[key], rtol=rtol,
                                       err_msg=key)


def one_step_runs(kind):
    """One step of ``kind`` in JAX float32, JAX float64 and the port."""
    jcfg, pcfg = _configs(kind)
    batches = _batches(kind, 1)
    return (kind, _jax_run(kind, jcfg, batches),
            _jax_run(kind, jcfg, batches, np.float64),
            _port_run(kind, pcfg, batches))


def check_step_metrics(one_step):
    """Every metric within rtol 2e-3 (tests/test_train_parity.py's loss
    tolerance); the SD1 stage's SD loss is NaN on both sides."""
    kind, (jm, _), _, (pm, *_) = one_step
    keys = {"loss", "CL", "SL"} | (set() if kind == "coco"
                                   else {"FTL", "OTL", "RL"})
    if kind in ("sd1", "sd2"):
        keys.add("SDL")
    assert set(jm[0]) == keys
    _assert_metrics(pm[0], jm[0])
    if "SDL" in keys:
        assert np.isnan(pm[0]["SDL"]) == (kind == "sd1")


def check_step_params(one_step):
    """The updated parameters through ``params_to_jax``, held by
    test_torch_adaattn_train.py's masked relative-L2 check against JAX
    float64, calibrated by JAX float32's own distance from it."""
    kind, (_, jax32), (_, jax64), (_, ours, grads, state) = one_step
    family, _, frames = KINDS[kind][2:]
    assert state.step == 1
    assert_params_close(ours, jax32, jax64, J_INIT[family](SEED_NET, frames),
                        params_to_jax(grads))


@pytest.fixture(scope="module", params=["flow", "coco"])
def one_step(request):
    return one_step_runs(request.param)


def test_step_metrics_match_jax(one_step):
    check_step_metrics(one_step)


def test_step_params_match_jax(one_step):
    check_step_params(one_step)


@pytest.mark.parametrize("kind", ["noftl", "multiframe"])
def test_flow_variants_match_jax(kind):
    """The noFTL and 4-frame configs: one step's metrics against JAX
    float32 (no FTL key without it; the 4-frame stem and the last frame's
    warp index)."""
    jcfg, pcfg = _configs(kind)
    batches = _batches(kind, 1)
    jm, _ = _jax_run(kind, jcfg, batches)
    pm, *_ = _port_run(kind, pcfg, batches)
    assert ("FTL" in jm[0]) == (kind != "noftl")
    _assert_metrics(pm[0], jm[0])


@pytest.mark.slow
@pytest.mark.parametrize("kind,steps,sd_term", [
    ("flow", 6, False), ("multiframe", 4, False), ("coco", 6, False),
    ("sd2", 5, False), ("sd2", 5, True)])
def test_trajectory_matches_jax(kind, steps, sd_term):
    """Several steps on fresh batches: the losses agree at every step
    (rtol 2e-3; any gradient or optimizer error compounds into them) and
    the final parameters pass the masked relative-L2 check; the SD2
    distillation also with its SD term in the total."""
    kw = {"include_sd_in_total": True} if sd_term else {}
    jcfg, pcfg = _configs(kind, **kw)
    batches = _batches(kind, steps)
    jm, jax32 = _jax_run(kind, jcfg, batches)
    _, jax64 = _jax_run(kind, jcfg, batches, np.float64)
    pm, ours, grads, _ = _port_run(kind, pcfg, batches)
    np.testing.assert_allclose([m["loss"] for m in pm],
                               [m["loss"] for m in jm], rtol=2e-3)
    family, _, frames = KINDS[kind][2:]
    assert_params_close(ours, jax32, jax64, J_INIT[family](SEED_NET, frames),
                        params_to_jax(grads))
