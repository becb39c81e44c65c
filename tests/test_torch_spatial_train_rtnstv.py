"""Data × space training of the RTNSTV step on real spawned gloo groups
(tests/torch_dist.py): its batch placed by ``shard_batch_spatial`` on a
(1 × 4) ("data", "space") mesh (8 rows a block, the fewest RTNSTV and
VGG19's pools before relu4_2 take) and, under remat, on a 2-way "space"
axis alone, against JAX's single-device step on the global batch, against
the port's single-process step, and every rank's parameters equal bit for
bit.

Each world's ranks are spawned once (module-scoped caches), and the JAX
step is compiled once."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.models import rtnstv as jrt
from vst_tpu.models import vgg as jv
from vst_tpu.train import config as jc
from vst_tpu.train import steps as js
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch.train import config as pc
from tests import torch_dist as td

H, W = 32, 24
RNG = np.random.default_rng(6)
STYLE = (RNG.random((1, H, W, 3)) * 255).astype(np.float32)
BATCH = ((RNG.random((2, H, W, 3)) * 255).astype(np.float32),
         (RNG.random((2, H, W, 3)) * 255).astype(np.float32),
         (RNG.standard_normal((2, H, W, 2)) * 2).astype(np.float32),
         (RNG.random((2, H, W)) > 0.2).astype(np.float32))
# case → (remat, mesh shape: (data, space), or the size of a "space" axis
# alone)
CASES = {"1x4": (False, (1, 4)), "space2_remat": (True, 2)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(remat=False, port=True):
    return dataclasses.replace(pc.RTNSTVConfig() if port
                               else jc.RTNSTVConfig(), img_size=(H, W),
                               remat=remat)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """case → every rank's (metrics, gradients (rank 0), parameters)."""
    return td.spatial_step_cache(tmp_path_factory, {
        name: ("rtnstv", _cfg(remat), BATCH, shape, STYLE)
        for name, (remat, shape) in CASES.items()})


@pytest.fixture(scope="module")
def single():
    """The port's single-process step on the global batch."""
    return td.single_train_step("rtnstv", _cfg(), BATCH, STYLE)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's single-device step (metrics, parameters)."""
    cfg = _cfg(port=False)
    vp = jv.init_vgg19_rtnstv(td.SEED_VGG)
    opt = make_optimizer(cfg.lr)
    step = js.make_rtnstv_step(
        cfg, vp, js.rtnstv_style_grams(vp, jnp.asarray(STYLE)), opt)
    s, m = step(j_create(jrt.init_stylizing_network(td.SEED_NET), opt),
                tuple(map(jnp.asarray, BATCH)))
    return ({k: float(v) for k, v in m.items()},
            {k: np.asarray(v) for k, v in s.params.items()})


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(sharded, jax_step, case):
    """Every metric (CL, SL, RL, TL, loss: the global batch's) within rtol
    1e-4 of JAX's single-device step, and the parameters within Adam's
    ±lr envelope (``td.assert_matches_jax``)."""
    td.assert_matches_jax(sharded(case)[0], jax_step, _cfg().lr)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_single_process(sharded, single, case):
    """Against the port's single-process step on the global batch
    (``td.assert_matches_single``)."""
    new_model, _ = td.train_setup("rtnstv", _cfg(), STYLE)
    p0 = {k: v.numpy() for k, v in new_model().state_dict().items()}
    td.assert_matches_single(sharded(case)[0], single, p0, _cfg().lr)


@pytest.mark.parametrize("case", list(CASES))
def test_step_ranks_agree_bitwise(sharded, case):
    """Every rank logs the same metrics and holds the same parameters,
    bit for bit, after the step."""
    td.assert_ranks_agree(sharded(case))
