"""H-sharded serving and data × space training at every H that JAX's
placement takes (H divisible by the axis size D), on real spawned gloo
groups (tests/torch_dist.py): the port's row layout
(``parallel/spatial.py::row_layout``: whole units of m rows spread as
evenly as they go, any remainder on the last block) where m·D does not
divide H.

- ``row_layout`` over a table of (H, D, m): contiguous, aligned, covering
  H, the even split wherever m·D divides H; ``least_height``;
- ``relayout_rows`` at 3 and 4 ranks (rows crossing two ranks) and its
  adjoint, Σ ⟨relayout(x), g⟩ = Σ ⟨x, relayoutᵀ(g)⟩; ``gather_rows`` over
  blocks of different rows and its reduce-scatter;
- every layer kind of ``td.spatial_layer_cases`` on uneven blocks at 3
  ranks (an odd bottom block before the stride-2 conv and the pool, a
  bottom block off K2's 4-row packing) and the loss shares, forward in
  float32 and gradient in float64 against the unsharded layer; at 2
  ranks a feature pyramid whose frame factor no block has;
- ``stylize_spatial_sharded`` of ReCoNet, SD1, SD2 and RTNSTV at 40×32
  over 4 ranks and 24×32 over 2 against JAX's unsharded stylization and
  JAX's own ``stylize_spatial_sharded`` on a virtual CPU mesh, each rank
  holding its H/D rows;
- the six step builders at an H that D divides and m·D does not: the
  flow step on (1 × 4) and (2 × 2) against JAX's single-device step,
  coco, SD1 (on a "space" axis alone, under remat), SD2, RTNSTV and the
  AdaAttN image (float64) and video steps against the port's
  single-process step, every rank's parameters equal bit for bit;
- where m·D divides H the layout is the placement and ``relayout_rows``
  moves nothing.

Each world's ranks are spawned once for all their cases (module-scoped
caches); each JAX reference is computed once."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.infer import image as jimg
from vst_tpu.models import reconet as jr
from vst_tpu.models import rtnstv as jrt
from vst_tpu.models import vgg as jv
from vst_tpu.parallel import make_mesh as jax_mesh
from vst_tpu.train import config as jc
from vst_tpu.train import steps as js
from vst_tpu.train.state import create as j_create
from vst_tpu.train.state import make_optimizer
from vst_tpu_torch.parallel.spatial import least_height, row_layout
from vst_tpu_torch.train import config as pc
from tests import torch_dist as td

TOL = {"reconet": dict(rtol=1e-4, atol=2e-3),
       "sd1": dict(rtol=1e-4, atol=2e-3),
       "sd2": dict(rtol=1e-4, atol=2e-3),
       "rtnstv": dict(rtol=1e-4, atol=1e-3)}
# serving: world → its frames (H = 40 over 4 ranks, 24 over 2: 4·D does
# not divide either; and 42, not a multiple of 4, over 2 and 3)
def _frame(seed, h):
    return (np.random.default_rng(seed).random((1, h, 32, 3)) * 255).astype(
        np.float32)


FRAMES = {4: [_frame(4, 40)], 2: [_frame(2, 24), _frame((2, 42), 42)],
          3: [_frame((3, 42), 42)]}


def _batch(rng, h, w, n=2, flow=True):
    img = [(rng.random((n, h, w, 3)) * 255).astype(np.float32)
           for _ in range(2)]
    if not flow:
        return tuple(img)
    return (*img, (rng.standard_normal((n, h, w, 2)) * 2).astype(np.float32),
            (rng.random((n, h, w)) > 0.2).astype(np.float32))


RNG = np.random.default_rng(11)
FLOW = _batch(RNG, 40, 24)            # 8-row units: 16, 8, 8, 8 / 24, 16
SMALL = _batch(RNG, 24, 16)           # 16, 8 over a 2-way space axis
TALL = _batch(RNG, 40, 16)            # 16, 8, 8, 8 over 4
ADA = _batch(RNG, 48, 16, flow=False)  # 16-row units: 32, 16 over 2
ADA3 = ADA + ((RNG.random((2, 48, 16, 3)) * 255).astype(np.float32),)
STYLE = {h: (np.random.default_rng(h).random((1, h, w, 3)) * 255).astype(
    np.float32) for h, w in ((40, 24), (24, 16))}


def _cfg(kind, size, remat=False, dtype="float32", **fields):
    if kind.startswith("adaattn"):
        cls, key = {"adaattn_image": (pc.AdaAttNImageConfig, "crop_size"),
                    "adaattn_video": (pc.AdaAttNVideoConfig,
                                      "frame_size")}[kind]
        return cls(batch_size=2, remat=remat, dtype=dtype, **{key: size})
    base = {"flow": pc.RECONET_CANDY, "coco": pc.ReCoNetCocoConfig(),
            "sd1": pc.DISTILL_SD1, "sd2": pc.DISTILL_SD2,
            "rtnstv": pc.RTNSTVConfig()}[kind]
    return dataclasses.replace(base, img_size=size, remat=remat,
                               dtype=dtype, **fields)


# case → (kind, config, global batch, mesh shape: (data, space), or the
# size of a "space" axis alone, style)
CASES = {
    "flow_1x4": ("flow", _cfg("flow", (40, 24)), FLOW, (1, 4), STYLE[40]),
    "flow_2x2": ("flow", _cfg("flow", (40, 24)), FLOW, (2, 2), STYLE[40]),
    "coco_2x2_f64": ("coco", _cfg("coco", (24, 16), dtype="float64"),
                     SMALL[0], (2, 2), STYLE[24]),
    "sd2_2x2": ("sd2", _cfg("sd2", (24, 16), include_sd_in_total=True),
                SMALL, (2, 2), STYLE[24]),
    "sd1_space4_remat": ("sd1", _cfg("sd1", (40, 16), remat=True), TALL, 4,
                         STYLE[24]),
    "rtnstv_1x4": ("rtnstv", _cfg("rtnstv", (40, 16)), TALL, (1, 4),
                   STYLE[24]),
    "adaattn_image_2x2_f64": ("adaattn_image",
                              _cfg("adaattn_image", (48, 16),
                                   dtype="float64"), ADA, (2, 2), None),
    "adaattn_video_2x2_f64": ("adaattn_video",
                              _cfg("adaattn_video", (48, 16),
                                   dtype="float64"), ADA3, (2, 2), None),
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cached(fn):
    return functools.cache(fn)


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    """world → each rank's ``td.uneven_layers``."""
    return _cached(lambda world: td.spawn(
        td.uneven_layers, world, tmp_path_factory.mktemp("uneven")))


@pytest.fixture(scope="module")
def stylized(tmp_path_factory):
    """world → each rank's [(rows of every family, the gathered frame)
    for each of the world's ``FRAMES``]."""
    return _cached(lambda world: td.spawn(
        td.uneven_stylize, world, tmp_path_factory.mktemp("ustylize"),
        FRAMES[world], timeout=180.0))


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """case → every rank's ((metrics, gradients (rank 0), parameters),
    the collectives the row layout added to the step)."""
    return td.spatial_step_cache(tmp_path_factory, CASES, timeout=300.0,
                                 worker=td.uneven_train_steps)


@pytest.fixture(scope="module")
def sharded(counted):
    """case → every rank's (metrics, gradients (rank 0), parameters)."""
    return lambda case: [result for result, _ in counted(case)]


# ----------------------------------------------------------- the layout

LAYOUTS = [(40, 4, 4), (40, 4, 8), (1080, 4, 4), (2160, 8, 4), (720, 8, 4),
           (360, 4, 8), (360, 2, 16), (272, 2, 16), (62, 1, 4), (62, 2, 4),
           (28, 1, 8), (64, 4, 16), (360, 3, 8)]


@pytest.mark.parametrize("h,d,m", LAYOUTS)
def test_row_layout(h, d, m):
    """Blocks contiguous from 0 to H, each starting on a multiple of m,
    each but the last whole units of m rows, the units spread as evenly
    as they go (none a unit more than another), the remainder on the last
    block; the even split H/D wherever m·D divides H."""
    bounds = row_layout(h, d, m)
    assert len(bounds) == d and bounds[0][0] == 0 and bounds[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(s % m == 0 for s, _ in bounds)
    assert all((e - s) % m == 0 for s, e in bounds[:-1])
    units = [(e - s) // m for s, e in bounds]
    assert max(units) - min(units) <= 1
    assert (bounds[-1][1] - bounds[-1][0]) % m == h % m
    if h % (m * d) == 0:
        assert bounds == tuple((i * h // d, (i + 1) * h // d)
                               for i in range(d))
    assert least_height(d, m) % d == 0
    ok = min(e - s for s, e in row_layout(least_height(d, m), d, m))
    assert ok >= max(m, 8)


def test_row_layout_of_the_checked_shapes():
    """The blocks the card checks: 1080 rows over 4 ranks at the residual
    level (68, 68, 67, 67 rows), 360 over 4 in 8-row units (24, 22, 22,
    22 at the residual level) and 272 over 2 in 16-row units (9 and 8
    units)."""
    assert [(e - s) // 4 for s, e in row_layout(1080, 4, 4)] == [68, 68, 67,
                                                                  67]
    assert [(e - s) // 4 for s, e in row_layout(360, 4, 8)] == [24, 22, 22,
                                                                 22]
    assert [(e - s) // 16 for s, e in row_layout(272, 2, 16)] == [9, 8]


# -------------------------------------------------- moves and gathers

@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("world", [3, 4])
def test_relayout_rows_and_adjoint(layers, world, case):
    """Each rank's moved rows are its target block of the frame, and
    Σ ⟨relayout(x), g⟩ = Σ ⟨x, relayoutᵀ(g)⟩ to 1e-12 in float64."""
    h, _, dst = td.RELAYOUTS[world][case]
    whole = np.random.default_rng(case).standard_normal((2, h, 3, 2))
    ranks = [r["relayout"][case] for r in layers(world)]
    for rank, (y, _, _) in enumerate(ranks):
        np.testing.assert_array_equal(y, whole[:, dst[rank][0]:dst[rank][1]])
    fwd = sum(r[1] for r in ranks)
    adj = sum(r[2] for r in ranks)
    assert abs(fwd - adj) <= 1e-12 * abs(fwd), (fwd, adj)


@pytest.mark.parametrize("world", [3, 4])
def test_gather_rows_uneven(layers, world):
    """Blocks of different rows gather into the frame on every rank, and
    the backward reduce-scatters: each rank's rows get the sum over the
    ranks of their cotangents' rows."""
    sizes = td.GATHERS[world]
    whole = np.arange(2 * sum(sizes) * 3, dtype=np.float64).reshape(
        2, sum(sizes), 3)
    ranks = [r["gather"] for r in layers(world)]
    cots = [np.random.default_rng(r).standard_normal(whole.shape)
            for r in range(world)]
    start = 0
    for rank, (y, gx) in enumerate(ranks):
        np.testing.assert_array_equal(y, whole)
        want = sum(c[:, start:start + sizes[rank]] for c in cots)
        np.testing.assert_allclose(gx, want, rtol=1e-12, atol=1e-12)
        start += sizes[rank]


# ------------------------------------------------------------- layers

def _layer_names(world):
    return sorted(td.UNEVEN_LAYERS) + (["feature_down_sample_partial"]
                                       if world == 2 else [])


@pytest.mark.parametrize("world,kind",
                         [(3, k) for k in _layer_names(3)]
                         + [(2, "feature_down_sample_partial")])
def test_uneven_layer_matches_unsharded(layers, world, kind):
    """The ranks' rows on uneven blocks, stitched, equal the unsharded
    layer (float32, as tests/test_torch_spatial.py holds even blocks)."""
    fn, x, _, _ = td.uneven_cases(world)[kind]
    with torch.no_grad():
        ref = fn(x, None).numpy()
    got = np.concatenate([r["fwd"][kind] for r in layers(world)], axis=1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _close(got, ref, what, floor=0.0):
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), floor)
    assert err <= 1e-10 * scale, (what, err, scale)


@pytest.mark.parametrize("world,kind",
                         [(3, k) for k in _layer_names(3)
                          + sorted(td.spatial_loss_cases())]
                         + [(2, "feature_down_sample_partial")])
def test_uneven_gradient_matches_unsharded(layers, world, kind):
    """In float64 on uneven blocks: each layer kind's output, input
    gradients (stitched) and parameter gradients (summed) under a seeded
    cotangent, and each loss share (summed) and its input gradients under
    1, equal the unsharded autograd to 1e-10 of their scale: the counts
    of an uneven layout (the norms', the Grams', the MSE and TV shares',
    the gathered warp source's) are the frame's."""
    fn, x, extra, _ = td.uneven_cases(world, torch.float64,
                                      losses=True)[kind]
    if kind in td.spatial_loss_cases():
        y, gx, gp = td.spatial_grad(fn, x, [], extra, None, torch.ones_like)
    else:
        y, gx, gp = td.spatial_grad(fn, x, extra, None, None,
                                    td.rows_cotangent(kind, 0, 1))
    ranks = [r["grad"][kind] for r in layers(world)]
    if y.ndim:
        _close(np.concatenate([r[0] for r in ranks], axis=1), y, "output")
    else:
        _close(np.array(sum(r[0] for r in ranks)), y, "loss")
    for i, ref in enumerate(gx):
        _close(np.concatenate([r[1][i] for r in ranks], axis=1), ref,
               f"input {i}")
    top = max([np.abs(g).max() for g in gx + gp] + [0.0])
    for i, ref in enumerate(gp):
        _close(sum(r[2][i] for r in ranks), ref, f"parameter {i}",
               1e-3 * top)


def test_similarity_bf16_count_is_exact(layers):
    """AdaAttN's image-similarity loss on bfloat16 features over uneven
    blocks (16, 12, 14 rows of 42): the shares sum to the unsharded
    loss to float32's rounding, so the frame's H·W (1092) enters exactly,
    not as bfloat16's 1088."""
    from vst_tpu_torch.losses import image_similarity_loss

    feats, _ = td.similarity_case()
    with torch.no_grad():
        ref = float(image_similarity_loss(*feats))
    got = sum(r["similarity"] for r in layers(3))
    np.testing.assert_allclose(got, ref, rtol=2e-5)


# ------------------------------------------------------------ serving

def _jax_params(family):
    if family == "rtnstv":
        return jrt.init_stylizing_network(0)
    return {"reconet": jr.init_reconet, "sd1": jr.init_reconet_sd1,
            "sd2": jr.init_reconet_sd2}[family](0)


@functools.cache
def _jax_ref(family, world, frame=0):
    x = jnp.asarray(FRAMES[world][frame])
    if family == "rtnstv":
        return np.asarray(jimg.stylize_rtnstv(_jax_params(family), x))
    return np.asarray(jimg.stylize_reconet(_jax_params(family), x, family))


@pytest.mark.parametrize("family", td.SPATIAL_FAMILIES)
@pytest.mark.parametrize("world", [2, 4])
def test_stylize_uneven_matches_jax(stylized, world, family):
    """Each rank returns its H/D rows, and the rows stitched equal JAX's
    unsharded stylization at JAX's tolerances (rtol 1e-4; atol 2e-3
    ReCoNet, 1e-3 RTNSTV)."""
    results = [r[0] for r in stylized(world)]
    h = FRAMES[world][0].shape[1]
    assert [out[family].shape[1] for out, _ in results] == [h // world] * world
    got = np.concatenate([out[family] for out, _ in results], axis=1)
    np.testing.assert_allclose(got, _jax_ref(family, world), **TOL[family])


@pytest.mark.parametrize("family", td.SPATIAL_FAMILIES)
@pytest.mark.parametrize("world", [2, 3])
def test_stylize_rows_not_multiple_of_4(stylized, world, family):
    """A 42-row frame (not a multiple of 4: the last block ends on a
    partial unit, 20 and 22 rows over 2, 16, 12 and 14 over 3) comes out
    44 rows high, as the unsharded model's does, in JAX's placement of 44
    rows (22 and 22; 15, 15 and 14), each rank's rows stitched equal to
    JAX's unsharded stylization at JAX's tolerances."""
    results = [r[-1] for r in stylized(world)]
    c = -(-44 // world)
    assert ([out[family].shape[1] for out, _ in results]
            == [min(c, 44 - i * c) for i in range(world)])
    got = np.concatenate([out[family] for out, _ in results], axis=1)
    np.testing.assert_allclose(got, _jax_ref(family, world, -1),
                               **TOL[family])


@pytest.mark.parametrize("world", [2, 4])
def test_uneven_matches_jax_sharded_entry(stylized, world):
    """Against JAX's own ``stylize_spatial_sharded`` on a ``world``-device
    "space" mesh of the virtual CPU devices that tests/conftest.py sets
    up, which takes these H too; ``gather_rows`` gives every rank the
    stitched frame."""
    ref = np.asarray(jimg.stylize_spatial_sharded(
        jr.init_reconet(0), jnp.asarray(FRAMES[world][0]),
        jax_mesh(world, ("space",))))
    results = [r[0] for r in stylized(world)]
    got = np.concatenate([out["reconet"] for out, _ in results], axis=1)
    np.testing.assert_allclose(got, ref, **TOL["reconet"])
    for _, gathered in results:
        np.testing.assert_array_equal(gathered, got)


@pytest.mark.parametrize("world", [2, 3])
def test_rows_not_multiple_of_4_match_jax_sharded_entry(stylized, world):
    """The 42-row frame against JAX's own ``stylize_spatial_sharded`` on
    a ``world``-device "space" mesh (44 rows out, as XLA pads the uneven
    shards); ``gather_rows`` over the placement's blocks gives every rank
    the stitched frame."""
    ref = np.asarray(jimg.stylize_spatial_sharded(
        jr.init_reconet(0), jnp.asarray(FRAMES[world][-1]),
        jax_mesh(world, ("space",))))
    results = [r[-1] for r in stylized(world)]
    got = np.concatenate([out["reconet"] for out, _ in results], axis=1)
    np.testing.assert_allclose(got, ref, **TOL["reconet"])
    for _, gathered in results:
        np.testing.assert_array_equal(gathered, got)


def test_even_layout_moves_nothing(tmp_path):
    """Where m·D divides H (32 rows over 4 ranks in 4- and 8-row units)
    the layout is the placement: serving a frame and placing a step's
    batch issue no collective of the layout's (``td.layout_collectives``)
    and ``_place`` hands back the placed tensors themselves; at 40 rows
    the serving output moves in one ``batch_isend_irecv`` and the step's
    four batch entries together in one more."""
    for (c_even, same_even, b_even), (c_uneven, same_uneven, b_uneven) in (
            td.spawn(td.relayout_calls, 4, tmp_path, 32, 40)):
        assert c_even == {"level_rows": 0, "frame_count": 0,
                          "relayout_rows": 0} and same_even
        assert b_even == tuple((8 * i, 8 * i + 8) for i in range(4))
        assert b_uneven == row_layout(40, 4, 8) != b_even
        assert not same_uneven
        assert c_uneven == {"level_rows": 0, "frame_count": 0,
                            "relayout_rows": 2}


# -------------------------------------------------------------- steps

@functools.cache
def _jax_flow_step():
    """JAX's single-device flow step on the global batch (VGG16 seed 0,
    ReCoNet seed 1)."""
    cfg = dataclasses.replace(jc.RECONET_CANDY, img_size=(40, 24))
    vp = jv.init_vgg16_reconet(td.SEED_VGG)
    opt = make_optimizer(cfg.lr)
    step = js.make_reconet_flow_step(
        cfg, vp, js.reconet_style_grams(vp, jnp.asarray(STYLE[40])), opt)
    s, m = step(j_create(jr.init_reconet(td.SEED_NET), opt),
                tuple(map(jnp.asarray, FLOW)))
    return ({k: float(v) for k, v in m.items()},
            {k: np.asarray(v) for k, v in s.params.items()})


@functools.cache
def _single(case):
    kind, cfg, batch, _, style = CASES[case]
    return td.single_train_step(kind, cfg, batch, style)


@pytest.mark.parametrize("case", ["flow_1x4", "flow_2x2"])
def test_uneven_flow_step_matches_jax(sharded, case):
    """The flow step at 40×24 (16, 8, 8, 8 rows on 4 space ranks; 24, 16
    on 2) against JAX's single-device step: metrics within rtol 1e-4,
    parameters within Adam's ±lr envelope (``td.assert_matches_jax``)."""
    td.assert_matches_jax(sharded(case)[0], _jax_flow_step(),
                          CASES[case][1].lr)


@pytest.mark.parametrize("case", [c for c in CASES if "flow" not in c])
def test_uneven_step_matches_single_process(sharded, case):
    """Against the port's single-process step on the global batch
    (``td.assert_matches_single``: metrics within rtol 1e-5, gradients
    within 1e-4 of each key's largest, Adam's update on them).  The coco
    and AdaAttN cases run in float64: at these sizes and seeds their
    float32 gradients stand 5e-2 (coco) from the float64 step's in the
    single process itself, float32's conditioning of the step, which the
    float64 step takes out."""
    kind, cfg, _, _, style = CASES[case]
    new_model, _ = td.train_setup(kind, cfg, style)
    p0 = {k: v.numpy() for k, v in new_model().state_dict().items()}
    td.assert_matches_single(sharded(case)[0], _single(case), p0, cfg.lr)


# the collectives an uneven row layout adds to one step of each case
# (``td.layout_collectives``): "level_rows" all-gathers (the warps' and
# the general resizes' block rows, the AdaAttN style gather's), each read
# on the host; "frame_count" all-reduces (the MSE, TV and similarity
# shares' counts); "relayout_rows", the one move of the placed batch
def _layout(level_rows, frame_count):
    return {"level_rows": level_rows, "frame_count": frame_count,
            "relayout_rows": 1}


LAYOUT_COLLECTIVES = {
    "flow_1x4": _layout(2, 2), "flow_2x2": _layout(2, 2),
    "coco_2x2_f64": _layout(0, 1), "sd2_2x2": _layout(2, 4),
    "sd1_space4_remat": _layout(2, 2), "rtnstv_1x4": _layout(1, 4),
    "adaattn_image_2x2_f64": _layout(2, 3),
    "adaattn_video_2x2_f64": _layout(2, 6)}


@pytest.mark.parametrize("case", list(CASES))
def test_uneven_layout_collectives(counted, case):
    """Every rank issues the same layout collectives, as many as
    ``LAYOUT_COLLECTIVES`` pins (PERF.md states their cost)."""
    counts = [c for _, c in counted(case)]
    assert all(c == counts[0] for c in counts)
    assert counts[0] == LAYOUT_COLLECTIVES[case]


@pytest.mark.parametrize("case", list(CASES))
def test_uneven_step_ranks_agree_bitwise(sharded, case):
    """Every rank logs the same metrics and holds the same parameters,
    bit for bit, after the step."""
    td.assert_ranks_agree(sharded(case))
