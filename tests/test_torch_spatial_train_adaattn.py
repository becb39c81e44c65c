"""Data × space training of the AdaAttN image step (softmax: K3 forward,
K4/K5 backward, their plain versions here) and video step (cosine) on
real spawned gloo groups (tests/torch_dist.py): each batch placed by
``shard_batch_spatial`` (the style's rows too, as JAX places them; the
step gathers the style back and encodes it whole) on a (2 × 2) and a
(1 × 4) ("data", "space") mesh, 16 rows a block at 64 (VGG19's four pools
before relu5_1), and, under remat, on a 2-way "space" axis alone; against
JAX's single-device step on the global batch, against the port's
single-process step, and every rank's parameters equal bit for bit.  The
image step runs its two meshes in float64 too: with seeded weights the
softmax moments' variance sits at its 1e-6 clamp, so its float32
gradients (the decoder's included, about 1e-11) are float32 noise that
the order of any sum moves (tests/test_torch_adaattn_train.py holds them
against JAX's float64 step); its gradients and update are held in
float64, its float32 metrics in float32.

Each world's ranks are spawned once for all their steps (module-scoped
caches), and each JAX step is compiled once."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.models import adaattn as ja
from vst_tpu.models import vgg as jv
from vst_tpu.train import config as jc
from vst_tpu.train import steps as js
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch.train import config as pc
from tests import torch_dist as td

H, W = 64, 32
RNG = np.random.default_rng(7)


def _images(count):
    return tuple((RNG.random((2, H, W, 3)) * 255).astype(np.float32)
                 for _ in range(count))


KINDS = {
    # kind: (JAX config class, port config class, size field, batch)
    "adaattn_image": (jc.AdaAttNImageConfig, pc.AdaAttNImageConfig,
                      "crop_size", _images(2)),
    "adaattn_video": (jc.AdaAttNVideoConfig, pc.AdaAttNVideoConfig,
                      "frame_size", _images(3)),
}
# case → (kind, remat, mesh shape: (data, space), or the size of a
# "space" axis alone; dtype)
CASES = {
    "image_2x2": ("adaattn_image", False, (2, 2), "float32"),
    "image_space2_remat": ("adaattn_image", True, 2, "float32"),
    "image_2x2_f64": ("adaattn_image", False, (2, 2), "float64"),
    "image_space2_remat_f64": ("adaattn_image", True, 2, "float64"),
    "video_1x4": ("adaattn_video", False, (1, 4), "float32"),
    "video_space2_remat": ("adaattn_video", True, 2, "float32"),
}
F32_CASES = [k for k, v in CASES.items() if v[3] == "float32"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(kind, remat=False, port=True, dtype="float32"):
    jcls, pcls, size, _ = KINDS[kind]
    if not port:
        return jcls(batch_size=2, **{size: (H, W)})
    return pcls(batch_size=2, remat=remat, dtype=dtype, **{size: (H, W)})




@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """case → every rank's (metrics, gradients (rank 0), parameters)."""
    return td.spatial_step_cache(tmp_path_factory, {
        name: (kind, _cfg(kind, remat, dtype=dtype), KINDS[kind][3], shape,
               None)
        for name, (kind, remat, shape, dtype) in CASES.items()})


@pytest.fixture(scope="module")
def single():
    """(kind, dtype) → the port's single-process step on the global
    batch."""
    return functools.cache(lambda key: td.single_train_step(
        key[0], _cfg(key[0], dtype=key[1]), KINDS[key[0]][3]))


@pytest.fixture(scope="module")
def jax_step():
    """kind → JAX's single-device step (metrics, parameters)."""
    def run(kind):
        cfg = _cfg(kind, port=False)
        opt = make_optimizer(cfg.lr)
        build = {"adaattn_image": js.make_adaattn_image_step,
                 "adaattn_video": js.make_adaattn_video_step}[kind]
        s, m = build(cfg, jv.init_vgg19_adaattn(td.SEED_VGG), opt)(
            j_create(ja.init_stylizing_network(td.SEED_NET), opt),
            tuple(map(jnp.asarray, KINDS[kind][3])))
        return ({k: float(v) for k, v in m.items()},
                {k: np.asarray(v) for k, v in s.params.items()})

    return functools.cache(run)


@pytest.mark.parametrize("case", F32_CASES)
def test_step_matches_jax(sharded, jax_step, case):
    """Every metric (the global batch's) within rtol 1e-4 of JAX's
    single-device step, and the parameters within Adam's ±lr envelope
    (``td.assert_matches_jax``)."""
    kind = CASES[case][0]
    td.assert_matches_jax(sharded(case)[0], jax_step(kind), _cfg(kind).lr)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_single_process(sharded, single, case):
    """Against the port's single-process step on the global batch at the
    same dtype (``td.assert_matches_single``: metrics within rtol 1e-5,
    gradients within 1e-4 of each key's largest, Adam's update on them);
    the image step's float32 cases by their metrics alone (module
    docstring)."""
    kind, _, _, dtype = CASES[case]
    new_model, _ = td.train_setup(kind, _cfg(kind))
    p0 = {k: v.numpy() for k, v in new_model().state_dict().items()}
    keys = [] if (kind, dtype) == ("adaattn_image", "float32") else None
    td.assert_matches_single(sharded(case)[0], single((kind, dtype)), p0,
                             _cfg(kind).lr, keys)


@pytest.mark.parametrize("case", list(CASES))
def test_step_ranks_agree_bitwise(sharded, case):
    """Every rank logs the same metrics and holds the same parameters,
    bit for bit, after the step."""
    td.assert_ranks_agree(sharded(case))
