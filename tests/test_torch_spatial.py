"""H-sharded (spatial) serving of the port on real spawned gloo groups
(tests/torch_dist.py), against the JAX package, and the sharded layers'
gradients.

- ``shard_spatial``'s layout and its ``ValueError``;
- every layer kind of the sharded path (reflect 3×3 stride 1 and 2, the
  9×9 through K2's packing, nearest ×2 + conv, the transposed conv, the
  zero-padded conv, max pool, the feature pyramid, bilinear ×2, instance
  norm, the K1 residual block in its halo-rows mode, the warp over the
  gathered source) on 2 and 4 ranks against the same layer unsharded;
- in the same spawns, each layer kind's gradient and the train steps'
  loss shares' (ReCoNet's Gram, content, TV, FTL, OTL; RTNSTV's content,
  style, TV, temporal and Gram; AdaAttN's mean and std, global stylized,
  cosine distance, image similarity) in float64 against the unsharded
  autograd: the input gradient stitched across ranks, the parameter
  gradient summed over them; and the exchange's adjoint,
  Σ ⟨exchange(x), g⟩ = Σ ⟨x, exchangeᵀ(g)⟩, for each edge mode;
- ``stylize_spatial_sharded`` of ReCoNet, SD1, SD2 and RTNSTV at (1, 64,
  32, 3) on 2 and 4 ranks against JAX's ``stylize_reconet`` /
  ``stylize_rtnstv`` at JAX's own tolerances (tests/test_parallel.py), and
  once against JAX's own ``stylize_spatial_sharded`` on a 4-device mesh;
- ``stylize_adaattn_sharded``, cosine and softmax, at 128² on 2 ranks
  against JAX's ``stylize_adaattn``;
- K1's halo-rows plain version, split 4 ways, against JAX's
  ``conv3x3_in_stats`` (interpret mode) on the whole tensor;
- a world-1 sharded forward against the unsharded one (and its
  gradient), the size rules (every step builder's rows multiple over a
  space axis), and the guard that remains (the sequence-parallel
  attention).

Each world's ranks are spawned once for all their cases (module-scoped
caches); the JAX references are computed once each."""

import copy
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.infer import image as jimg
from vst_tpu.kernels import res_block as jrb
from vst_tpu.models import adaattn as ja
from vst_tpu.models import reconet as jr
from vst_tpu.models import rtnstv as jrt
from vst_tpu.models import vgg as jv
from vst_tpu_torch.infer import image as pim
from vst_tpu_torch.kernels import res_block
from vst_tpu_torch.models import adaattn as pa
from vst_tpu_torch.models import vgg as pv
from vst_tpu_torch.parallel import SpatialContext, make_mesh, shard_spatial
from tests import torch_dist as td

FRAME = (np.random.default_rng(0).random((1, 64, 32, 3)) * 255).astype(
    np.float32)
ADA = tuple((np.random.default_rng(s).random((1, 128, 128, 3)) * 255)
            .astype(np.float32) for s in (1, 2))
TOL = {"reconet": dict(rtol=1e-4, atol=2e-3),
       "sd1": dict(rtol=1e-4, atol=2e-3),
       "sd2": dict(rtol=1e-4, atol=2e-3),
       "rtnstv": dict(rtol=1e-4, atol=1e-3)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cached(fn):
    cache = {}

    def get(key):
        if key not in cache:
            cache[key] = fn(key)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    """world → each rank's outputs ("fwd"), gradients ("grad") and
    exchange adjoint products ("adjoint"), ``td.spatial_layers``."""
    return _cached(lambda world: td.spawn(
        td.spatial_layers, world, tmp_path_factory.mktemp("layers")))


@pytest.fixture(scope="module")
def stylized(tmp_path_factory):
    """world → each rank's (rows of every family (and AdaAttN at world
    2), the gathered ReCoNet frame)."""
    return _cached(lambda world: td.spawn(
        td.spatial_stylize, world, tmp_path_factory.mktemp("stylize"),
        FRAME, ADA if world == 2 else None, timeout=180.0))


def _jax_params(family):
    if family == "rtnstv":
        return jrt.init_stylizing_network(0)
    return {"reconet": jr.init_reconet, "sd1": jr.init_reconet_sd1,
            "sd2": jr.init_reconet_sd2}[family](0)


@pytest.fixture(scope="module")
def jax_ref():
    """family → JAX's unsharded stylization of FRAME; "adaattn_<act>" →
    JAX's ``stylize_adaattn`` of ADA."""
    def ref(key):
        x = jnp.asarray(FRAME)
        if key == "rtnstv":
            return np.asarray(jimg.stylize_rtnstv(_jax_params(key), x))
        if key in td.SPATIAL_FAMILIES:
            return np.asarray(jimg.stylize_reconet(_jax_params(key), x, key))
        act = key.split("_")[1]
        return np.asarray(jimg.stylize_adaattn(
            jv.init_vgg19_adaattn(0), ja.init_stylizing_network(1),
            *map(jnp.asarray, ADA), act))

    return _cached(ref)


def test_shard_spatial_layout(tmp_path):
    """Each of 2 ranks gets its contiguous H rows of every leaf, on its
    device; an H that does not split raises ValueError."""
    x = np.arange(2 * 6 * 3 * 2, dtype=np.float32).reshape(2, 6, 3, 2)
    for rank, (own, own_y, dev, err) in enumerate(
            td.spawn(td.spatial_layout, 2, tmp_path, x)):
        np.testing.assert_array_equal(own, x[:, 3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(own_y, own)
        assert dev == "cpu"
        assert err is not None and "must divide by the 2-way" in err


@pytest.mark.parametrize("kind", sorted(td.spatial_layer_cases()))
@pytest.mark.parametrize("world", [2, 4])
def test_layer_kind_matches_unsharded(layers, world, kind):
    """The ranks' rows, stitched, equal the unsharded layer (float32)."""
    fn, x, _ = td.spatial_layer_cases()[kind]
    with torch.no_grad():
        ref = fn(x, None).numpy()
    got = np.concatenate([r["fwd"][kind] for r in layers(world)], axis=1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _close(got, ref, what, floor=0.0):
    """Within 1e-10 of the reference's largest magnitude, or of ``floor``
    where that is larger (float64)."""
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max()
    scale = max(np.abs(ref).max(), floor)
    assert err <= 1e-10 * scale, (what, err, scale)


@pytest.mark.parametrize("kind", sorted(td.spatial_layer_cases())
                         + sorted(td.spatial_loss_cases()))
@pytest.mark.parametrize("world", [2, 4])
def test_layer_kind_gradient_matches_unsharded(layers, world, kind):
    """In float64, each layer kind under a seeded cotangent of its whole
    output (each rank its rows) and each loss share under 1: the output
    (rows stitched, shares summed), the inputs' gradients stitched across
    the ranks and the parameters' gradients summed over them equal the
    unsharded layer's autograd to 1e-10 of their scale.  This holds the
    exchange's adjoint, the all-reduce's and the gather's backward, K1's
    halo-rows VJP (the residual block) and the loss shares' factors (a
    term of all-reduced or whole quantities, the style losses of the
    all-reduced Grams, the global stylized and image similarity losses,
    enters each share divided by the axis size: without it the shares'
    sum and its gradient come out that many times too large)."""
    if kind in td.spatial_layer_cases():
        fn, x, params = td.spatial_layer_cases(dtype=torch.float64)[kind]
        idx, cot = None, td.rows_cotangent(kind, 0, 1)
    else:
        (fn, x, idx), params = td.spatial_loss_cases()[kind], []
        cot = torch.ones_like
    y, gx, gp = td.spatial_grad(fn, x, params, idx, None, cot)
    ranks = [r["grad"][kind] for r in layers(world)]
    if y.ndim:
        _close(np.concatenate([r[0] for r in ranks], axis=1), y, "output")
    else:
        _close(np.array(sum(r[0] for r in ranks)), y, "loss")
    for i, ref in enumerate(gx):
        _close(np.concatenate([r[1][i] for r in ranks], axis=1), ref,
               f"input {i}")
    # a conv bias that an instance norm follows has a true gradient of 0:
    # its float64 rounding is held against the layer's gradient scale
    top = max(np.abs(g).max() for g in gx + gp)
    for i, ref in enumerate(gp):
        _close(sum(r[2][i] for r in ranks), ref, f"parameter {i}",
               1e-3 * top)


@pytest.mark.parametrize("edge,wpad", td.EXCHANGE_CASES)
@pytest.mark.parametrize("world", [2, 4])
def test_exchange_rows_adjoint(layers, world, edge, wpad):
    """Σ_ranks ⟨exchange(x), g⟩ = Σ_ranks ⟨x, exchangeᵀ(g)⟩ in float64
    (2 rows above, 1 below, the W border ``wpad`` reflected, or zero with
    the zero edge): the backward is the forward's adjoint, halo rows sent
    back to their ranks and edge rows folded."""
    fwd, adj = (sum(r["adjoint"][(edge, wpad)][i] for r in layers(world))
                for i in (0, 1))
    assert abs(fwd - adj) <= 1e-12 * abs(fwd), (fwd, adj)


@pytest.mark.parametrize("family", td.SPATIAL_FAMILIES)
@pytest.mark.parametrize("world", [2, 4])
def test_stylize_spatial_sharded_matches_jax(stylized, jax_ref, world,
                                             family):
    """Each rank's rows, stitched, equal JAX's unsharded stylization at
    JAX's tolerances (rtol 1e-4; atol 2e-3 ReCoNet, 1e-3 RTNSTV)."""
    got = np.concatenate([out[family] for out, _ in stylized(world)], axis=1)
    np.testing.assert_allclose(got, jax_ref(family), **TOL[family])


@pytest.mark.parametrize("world", [2, 4])
def test_gather_rows_assembles_the_frame(stylized, world):
    """``gather_rows`` gives every rank the stitched frame."""
    results = stylized(world)
    stitched = np.concatenate([out["reconet"] for out, _ in results], axis=1)
    for _, gathered in results:
        np.testing.assert_array_equal(gathered, stitched)


def test_matches_jax_sharded_entry(stylized):
    """4 gloo ranks against JAX's own ``stylize_spatial_sharded`` on a
    4-device "space" mesh of the virtual CPU devices that
    tests/conftest.py sets up."""
    from vst_tpu.parallel import make_mesh as jax_mesh

    mesh = jax_mesh(4, ("space",))
    ref = np.asarray(jimg.stylize_spatial_sharded(
        jr.init_reconet(0), jnp.asarray(FRAME), mesh))
    got = np.concatenate([out["reconet"] for out, _ in stylized(4)], axis=1)
    np.testing.assert_allclose(got, ref, **TOL["reconet"])


@pytest.mark.parametrize("activation", ["cosine", "softmax"])
def test_adaattn_sharded_matches_jax(stylized, jax_ref, activation):
    """``stylize_adaattn_sharded`` at 128² on 2 ranks against JAX's
    unsharded ``stylize_adaattn`` (rtol 1e-3, atol 5e-2, as
    tests/test_parallel.py holds JAX's sharded program)."""
    key = f"adaattn_{activation}"
    got = np.concatenate([out[key] for out, _ in stylized(2)], axis=1)
    np.testing.assert_allclose(got, jax_ref(key), rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("prologue", [False, True])
def test_k1_halo_plain_matches_jax(rng, prologue):
    """K1's halo-rows plain version over a 4-way row split (each shard
    with its neighbours' rows, reflected rows at the frame's edges), the
    outputs stitched and the sums combined into (mean, var), equals JAX's
    ``conv3x3_in_stats`` (interpret mode) on the whole tensor."""
    x = (rng.standard_normal((2, 16, 12, 8)) * 3).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 8)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(8) * 0.1).astype(np.float32)
    kw = {}
    if prologue:
        kw = dict(stats_in=np.stack([rng.standard_normal((2, 8)),
                                     rng.random((2, 8)) + 0.5],
                                    1).astype(np.float32),
                  gamma=(rng.random(8) + 0.5).astype(np.float32),
                  beta=(rng.standard_normal(8) * 0.1).astype(np.float32))
    yj, sj = jrb.conv3x3_in_stats(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        **{k: jnp.asarray(v) for k, v in kw.items()}, interpret=True)
    xp = torch.nn.functional.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 (1, 1, 1, 1), mode="reflect").permute(
                                     0, 2, 3, 1)
    tw = {k: torch.from_numpy(v) for k, v in kw.items()}
    ys, sums = [], 0
    for i in range(4):
        y, s = res_block.conv3x3_in_stats_halo(
            xp[:, 4 * i:4 * i + 6].contiguous(), torch.from_numpy(w),
            torch.from_numpy(b), **tw)
        assert y.shape == (2, 4, 12, 8) and s.dtype == torch.float32
        ys.append(y)
        sums = sums + s
    mean = sums[:, 0] / (16 * 12)
    var = sums[:, 1] / (16 * 12) - mean * mean
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(sj[:, 0]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(sj[:, 1]),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("family", td.SPATIAL_FAMILIES)
def test_world1_matches_unsharded(tmp_path, family):
    """A world-1 sharded forward on the CPU gives the unsharded one's
    bits: the exchange pads as the layers do, and the two-pass instance
    norm and K1's sums divide as the unsharded ones."""
    model = td.spatial_model(family)
    plain = pim.stylize_rtnstv if family == "rtnstv" else pim.stylize_reconet
    with td.world1(tmp_path):
        mesh = make_mesh(None, ("space",))
        got = pim.stylize_spatial_sharded(model, FRAME, mesh)
    assert torch.equal(got, plain(model, FRAME))


def test_world1_adaattn_matches_unsharded(tmp_path):
    """The same for AdaAttN cosine at 64²: the local queries are all the
    queries, so the moments are the unsharded ones."""
    vgg = pv.init_vgg19_adaattn(0, device="cpu")
    net = pa.init_stylizing_network(1, device="cpu")
    c, s = (a[:, :64, :64] for a in ADA)
    with td.world1(tmp_path):
        mesh = make_mesh(None, ("space",))
        got = pim.stylize_adaattn_sharded(vgg, net, c, s, mesh)
    ref = pim.stylize_adaattn(vgg, net, c, s, "cosine")
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_size_rules_and_serving_only(tmp_path):
    """At world 1 a sharded entry takes every H the unsharded model takes:
    a 62-row frame (not a multiple of 4) serves to the unsharded model's
    64 rows, and a 28-row ReCoNet flow step (not a multiple of 8) equals
    the unsharded step; below the least block (8 rows) both raise
    ValueError naming the least H; ``stylize_adaattn_sharded`` keeps
    JAX's own 16·D; a world-1 sharded forward differentiates to the
    unsharded forward's gradients; and the sequence-parallel attention on
    the "space" axis, whose guard is gone, differentiates to the
    unsharded linear form's gradient bit for bit."""
    from vst_tpu_torch.ops.conv import conv2d_reflect
    from vst_tpu_torch.parallel.attention import (
        sharded_cosine_attention_moments)
    from vst_tpu_torch.train import config as pc
    from vst_tpu_torch.train import steps as pst
    from vst_tpu_torch.train.state import create

    model = td.spatial_model("reconet")
    vgg = pv.init_vgg19_adaattn(0, device="cpu")
    net = pa.init_stylizing_network(1, device="cpu")
    with td.world1(tmp_path):
        mesh = make_mesh(None, ("space",))
        got = pim.stylize_spatial_sharded(model, FRAME[:, :62], mesh)
        assert got.shape == (1, 64, 32, 3)
        torch.testing.assert_close(
            got, pim.stylize_reconet(model, FRAME[:, :62]), rtol=0,
            atol=1e-4)
        with pytest.raises(ValueError, match="must be at least 8 for 1"):
            pim.stylize_spatial_sharded(model, FRAME[:, :4], mesh)
        with pytest.raises(ValueError, match="divide by 16"):
            pim.stylize_adaattn_sharded(vgg, net, ADA[0][:, :120], ADA[1],
                                        mesh)
        ctx = SpatialContext(mesh)
        x = shard_spatial(mesh, torch.from_numpy(FRAME))
        w = torch.zeros(4, 3, 3, 3).normal_(generator=torch.Generator()
                                            .manual_seed(0))
        wu = w.clone().requires_grad_()
        w.requires_grad_()
        conv2d_reflect(x, w, spatial=ctx).square().sum().backward()
        conv2d_reflect(x, wu).square().sum().backward()
        torch.testing.assert_close(w.grad, wu.grad, rtol=1e-5, atol=0)
        # the whole model's gradient, in float64: the biases an instance
        # norm follows (true gradient 0) against the largest gradient
        m64, x64 = copy.deepcopy(model).double(), x.double()
        sharded = torch.autograd.grad(m64(x64, spatial=ctx)[-1].sum(),
                                      list(m64.parameters()))
        plain = torch.autograd.grad(m64(x64)[-1].sum(),
                                    list(m64.parameters()))
        top = max(b.abs().max().item() for b in plain)
        for (k, _), a, b in zip(m64.named_parameters(), sharded, plain):
            scale = max(b.abs().max().item(), 1e-3 * top)
            torch.testing.assert_close(a, b, rtol=0, atol=1e-10 * scale,
                                       msg=k)
        with torch.no_grad():
            assert conv2d_reflect(x, w, spatial=ctx).shape == (1, 64, 32, 4)
        q = torch.linspace(-1, 1, 32).reshape(1, 8, 4).requires_grad_()
        grads = [torch.autograd.grad(sum(t.sum() for t in fn(q)), q)[0]
                 for fn in (lambda t: sharded_cosine_attention_moments(
                                mesh, t, t, t, axis="space"),
                            lambda t: pa.attention_moments(t, t, t,
                                                           "cosine"))]
        assert torch.equal(*grads)
        grid = make_mesh(None, ("data", "space"), (1, 1))
        cfg = dataclasses.replace(pc.RECONET_CANDY, img_size=(28, 24))
        v16 = pv.init_vgg16_reconet(0, device="cpu")
        grams = [torch.zeros(1, c, c) for c in (64, 128, 256, 512)]
        g = np.random.default_rng(3)
        batch = ((g.random((1, 28, 24, 3)) * 255).astype(np.float32),
                 (g.random((1, 28, 24, 3)) * 255).astype(np.float32),
                 g.standard_normal((1, 28, 24, 2)).astype(np.float32),
                 np.ones((1, 28, 24), np.float32))
        step = pst.make_reconet_flow_step(cfg, v16, grams, grid)
        _, metrics = step(create(td._seeded(0), cfg.lr), batch)
        with pytest.raises(ValueError, match="must be at least 8 for 1"):
            step(create(td._seeded(0), cfg.lr), tuple(b[:, :4]
                                                       for b in batch))
    _, plain = pst.make_reconet_flow_step(cfg, v16, grams)(
        create(td._seeded(0), cfg.lr), batch)
    for k, v in plain.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)


# builder kind → (its row unit over a space axis (8: the stylizer's
# stride-2 layers and VGG16's pools before relu4_3 or RTNSTV's VGG19's
# before relu4_2; 16: AdaAttN's VGG19's before relu5_1), the batch's
# entries (ReCoNet's flow pair: two frames, a flow, a mask))
ROW_RULES = {"coco": (8, 1), "sd1": (8, 4), "sd2": (8, 4), "rtnstv": (8, 4),
             "adaattn_image": (16, 2), "adaattn_video": (16, 3)}


def _rules_case(kind, h):
    """(config in float64, batch of 1 at H = h, the make_*_step name) of a
    ``ROW_RULES`` kind; AdaAttN at 32 columns (relu5_1 keeps two)."""
    from vst_tpu_torch.train import config as pc

    cfg = {"coco": pc.ReCoNetCocoConfig(), "sd1": pc.DISTILL_SD1,
           "sd2": pc.DISTILL_SD2, "rtnstv": pc.RTNSTVConfig(),
           "adaattn_image": pc.AdaAttNImageConfig(),
           "adaattn_video": pc.AdaAttNVideoConfig()}[kind]
    cfg = dataclasses.replace(cfg, dtype="float64")
    entries = ROW_RULES[kind][1]
    g = np.random.default_rng(h)
    width = 32 if kind.startswith("adaattn") else 16
    frames = [(g.random((1, h, width, 3)) * 255).astype(np.float32)
              for _ in range(min(entries, 3))]
    batch = tuple(frames) if entries != 4 else (
        *frames[:2], g.standard_normal((1, h, width, 2)).astype(np.float32),
        (g.random((1, h, width)) > 0.2).astype(np.float32))
    builder = ("make_reconet_distill_step" if kind in ("sd1", "sd2") else
               f"make_{'reconet_' * (kind == 'coco')}{kind}_step")
    return cfg, batch, builder


@pytest.mark.parametrize("kind", sorted(ROW_RULES))
def test_step_builder_rows_multiple(tmp_path, kind):
    """Every step builder on a world-1 ("data", "space") mesh at an H
    that is not a multiple of its row unit but that the unsharded step
    takes (12 rows for the 8-row unit; 18 for AdaAttN's 16, whose decoder
    asks H mod 16 < 4 of the unsharded step too): the step runs and
    equals the unsharded step (float64; ``td.assert_matches_single``)."""
    from vst_tpu_torch.train.state import create

    unit = ROW_RULES[kind][0]
    h = unit + (4 if unit == 8 else 2)
    cfg, batch, _ = _rules_case(kind, h)
    new_model, build = td.train_setup(kind, cfg, batch[0][:, :8])
    with td.world1(tmp_path):
        step = build(make_mesh(None, ("data", "space"), (1, 1)))
        state, metrics = step(create(new_model(), cfg.lr), batch)
        result = td._step_result(state, metrics)
    p0 = {k: v.numpy() for k, v in new_model().state_dict().items()}
    td.assert_matches_single(result, td.single_train_step(
        kind, cfg, batch, batch[0][:, :8]), p0, cfg.lr)


@pytest.mark.parametrize("kind", sorted(ROW_RULES))
def test_step_builder_least_height(tmp_path, kind):
    """Below the least block (a whole unit and at least 8 rows) every
    builder raises ValueError naming itself and the least H for the axis
    size: 8 at world 1 for the 8-row unit, 16 for AdaAttN's."""
    from vst_tpu_torch.train.state import create

    unit = ROW_RULES[kind][0]
    h = unit // 2
    cfg, batch, builder = _rules_case(kind, h)
    style = np.full((1, 16, 16, 3), 128.0, np.float32)
    new_model, build = td.train_setup(kind, cfg, style)
    with td.world1(tmp_path):
        step = build(make_mesh(None, ("data", "space"), (1, 1)))
        with pytest.raises(ValueError, match=(
                rf"{builder}: H {h} over the 1-way 'space' axis leaves a "
                rf"block of {h} rows; .* H must be at least {unit} for 1 "
                rf"ranks")):
            step(create(new_model(), cfg.lr), batch)
