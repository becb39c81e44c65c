"""Data × space training of the ReCoNet coco and distillation steps on
real spawned gloo groups (tests/torch_dist.py): each builder's batch
placed by ``shard_batch_spatial`` on a (2 × 2) ("data", "space") mesh and,
under remat, on a 2-way "space" axis alone, against JAX's single-device
step on the global batch (as tests/test_torch_spatial_train.py holds the
flow step), against the port's single-process step, and every rank's
parameters equal bit for bit.  The distillation runs both stages: SD2
with its SD loss in the total (each rank's MSE share), SD1 with its SD
loss NaN.

Each world's ranks are spawned once for all their steps (module-scoped
caches), and each JAX step is compiled once."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.models import reconet as jr
from vst_tpu.models import vgg as jv
from vst_tpu.train import config as jc
from vst_tpu.train import steps as js
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch.train import config as pc
from tests import torch_dist as td

H, W = 32, 24
RNG = np.random.default_rng(5)
STYLE = (RNG.random((1, H, W, 3)) * 255).astype(np.float32)


def _images(n):
    return (RNG.random((n, H, W, 3)) * 255).astype(np.float32)


COCO = _images(2)
FLOW = (_images(2), _images(2),
        (RNG.standard_normal((2, H, W, 2)) * 2).astype(np.float32),
        (RNG.random((2, H, W)) > 0.2).astype(np.float32))
KINDS = {
    # kind: (JAX config, port config, batch, config fields)
    "coco": (jc.ReCoNetCocoConfig(), pc.ReCoNetCocoConfig(), COCO, {}),
    "sd2": (jc.DISTILL_SD2, pc.DISTILL_SD2, FLOW,
            dict(include_sd_in_total=True)),
    "sd1": (jc.DISTILL_SD1, pc.DISTILL_SD1, FLOW, {}),
}
# case → (kind, remat, mesh shape: (data, space), or the size of a
# "space" axis alone)
CASES = {
    "coco_2x2": ("coco", False, (2, 2)),
    "coco_space2_remat": ("coco", True, 2),
    "sd2_2x2": ("sd2", False, (2, 2)),
    "sd1_space2_remat": ("sd1", True, 2),
}
J_INIT = {"coco": jr.init_reconet, "reconet": jr.init_reconet,
          "sd1": jr.init_reconet_sd1, "sd2": jr.init_reconet_sd2}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(kind, remat=False, port=True):
    jcfg, pcfg, _, fields = KINDS[kind]
    return dataclasses.replace(pcfg if port else jcfg, img_size=(H, W),
                               remat=remat, **fields)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """case → every rank's (metrics, gradients (rank 0), parameters)."""
    return td.spatial_step_cache(tmp_path_factory, {
        name: (kind, _cfg(kind, remat), KINDS[kind][2], shape, STYLE)
        for name, (kind, remat, shape) in CASES.items()})


@pytest.fixture(scope="module")
def single():
    """kind → the port's single-process step on the global batch."""
    return functools.cache(lambda kind: td.single_train_step(
        kind, _cfg(kind), KINDS[kind][2], STYLE))


@pytest.fixture(scope="module")
def jax_step():
    """kind → JAX's single-device step (metrics, parameters)."""
    def run(kind):
        cfg = _cfg(kind, port=False)
        vp = jv.init_vgg16_reconet(td.SEED_VGG)
        grams = js.reconet_style_grams(vp, jnp.asarray(STYLE))
        opt = make_optimizer(cfg.lr)
        state = j_create(J_INIT[kind](td.SEED_NET), opt)
        if kind == "coco":
            step = js.make_reconet_coco_step(cfg, vp, grams, opt)
            batch = jnp.asarray(COCO)
        else:
            step = js.make_reconet_distill_step(
                cfg, vp, grams, J_INIT[td.TEACHER[kind]](td.SEED_TEACHER),
                opt)
            batch = tuple(map(jnp.asarray, FLOW))
        s, m = step(state, batch)
        return ({k: float(v) for k, v in m.items()},
                {k: np.asarray(v) for k, v in s.params.items()})

    return functools.cache(run)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(sharded, jax_step, case):
    """Every metric (the global batch's: summed over "space", averaged
    over "data"; SD1's SD loss NaN on both sides) within rtol 1e-4 of
    JAX's single-device step, and the parameters within Adam's ±lr
    envelope (``td.assert_matches_jax``)."""
    kind = CASES[case][0]
    td.assert_matches_jax(sharded(case)[0], jax_step(kind), _cfg(kind).lr)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_single_process(sharded, single, case):
    """Against the port's single-process step on the global batch
    (``td.assert_matches_single``: metrics within rtol 1e-5, gradients
    within 1e-4 of each key's largest, Adam's update on them)."""
    kind = CASES[case][0]
    new_model, _ = td.train_setup(kind, _cfg(kind), STYLE)
    p0 = {k: v.numpy() for k, v in new_model().state_dict().items()}
    td.assert_matches_single(sharded(case)[0], single(kind), p0,
                             _cfg(kind).lr)


@pytest.mark.parametrize("case", list(CASES))
def test_step_ranks_agree_bitwise(sharded, case):
    """Every rank logs the same metrics and holds the same parameters,
    bit for bit, after the step."""
    td.assert_ranks_agree(sharded(case))
