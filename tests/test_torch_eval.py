"""The port's metrics against the JAX package's on the CPU: histograms,
SSIM, the Gram distance, the temporal metrics (``map_batched`` with a
ragged tail included), LPIPS on its three trunks and in every mode, the
FakeNet baselines, the LPIPS ranking trainer, the 2AFC/JND scores and
``visualize_flow``.  Inputs are numpy arrays from a seed; seeded weights
go across through ``params_from_jax``."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu import eval as jeval
from vst_tpu.eval import lpips as jlp
from vst_tpu.eval import lpips_trainer as jlt
from vst_tpu.eval import temporal as jtemp
from vst_tpu_torch import eval as peval
from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.eval import histogram as phist
from vst_tpu_torch.eval import lpips as plp
from vst_tpu_torch.eval import lpips_trainer as plt_
from vst_tpu_torch.eval import temporal as ptemp


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores, and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _img(rng, shape, scale=255.0):
    return (rng.random(shape) * scale).astype(np.float32)


def _close(ours, ref, rel):
    """|ours − ref| ≤ rel · max|ref|, elementwise."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def test_exported_names():
    assert peval.__all__ == jeval.__all__
    for name in peval.__all__:
        assert callable(getattr(peval, name)), name


# ------------------------------------------------------------- histograms

def test_histogram_metrics_bitwise():
    from vst_tpu.eval import histogram as jhist

    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)
    b = (rng.random((24, 40, 3)) ** 2 * 255).astype(np.uint8)
    gray = a[..., 0]
    np.testing.assert_array_equal(phist.compute_histogram(a, 1),
                                  jhist.compute_histogram(a, 1))
    np.testing.assert_array_equal(phist.compute_histogram(gray),
                                  jhist.compute_histogram(gray))
    assert phist.kl_divergence_rgb(a, b) == jhist.kl_divergence_rgb(a, b)
    for fn in ("nth_order_moment", "uniformity", "average_entropy"):
        assert getattr(phist, fn)(gray) == getattr(jhist, fn)(gray), fn


# ------------------------------------------------------------ SSIM, Gram

@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_ssim(reduction):
    rng = np.random.default_rng(1)
    a = _img(rng, (2, 30, 37, 3))
    b = np.clip(a + _img(rng, (2, 30, 37, 3), 60.0) - 30, 0, 255)
    ref = np.asarray(jeval.ssim(jnp.asarray(a), jnp.asarray(b),
                                reduction=reduction))
    ours = peval.ssim(torch.from_numpy(a), torch.from_numpy(b),
                      reduction=reduction).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_ssim_rejects_shapes():
    with pytest.raises(ValueError, match="one shape"):
        peval.ssim(torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 9, 3))


def test_gram_loss_5tap():
    from vst_tpu.models import vgg as jv
    from vst_tpu_torch.models import vgg as pv

    rng = np.random.default_rng(2)
    a, b = _img(rng, (1, 32, 32, 3)), _img(rng, (1, 32, 40, 3))
    ref = float(jeval.gram_loss_5tap(jv.init_vgg19_adaattn(0),
                                     jnp.asarray(a), jnp.asarray(b)))
    ours = float(peval.gram_loss_5tap(pv.init_vgg19_adaattn(0, "cpu"),
                                      torch.from_numpy(a),
                                      torch.from_numpy(b)))
    _close(ours, ref, 1e-4)


# -------------------------------------------------------------- temporal

def _toy_model(x):
    """A stand-in stylizer, the same function on both sides: the last
    frame of the window, mixed with the first, clamped."""
    return np.clip(0.7 * x[..., -3:] + 0.2 * x[..., :3] + 12.0, 0, 255)


def _toy_model_torch(x):
    return torch.from_numpy(_toy_model(np.asarray(x)).astype(np.float32))


@pytest.mark.parametrize("input_frame_num", [1, 2])
def test_temporal_mse(input_frame_num):
    rng = np.random.default_rng(3)
    frames = list(_img(rng, (6, 20, 24, 3)))
    ref = jtemp.temporal_mse(_toy_model, iter(frames), input_frame_num)
    ours = ptemp.temporal_mse(_toy_model_torch, iter(frames),
                              input_frame_num)
    _close(ours, ref, 1e-5)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_map_batched_ragged_tail(as_tensor):
    """11 items in chunks of 4: three calls, each of 4 (the tail padded by
    its last item), the padded outputs dropped — JAX's chunks, calls and
    outputs, bit for bit (the function is the same numpy arithmetic on
    both sides; with ``as_tensor`` the port's chunks are tensors)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((11, 3, 2)).astype(np.float32)
    y = rng.standard_normal((11, 3, 2)).astype(np.float32)
    calls = {"jax": [], "port": []}

    def fn(tag, a, b):
        a, b = np.asarray(a), np.asarray(b)
        calls[tag].append(a.copy())
        out = (a * b).sum(axis=(1, 2))
        return torch.from_numpy(out) if as_tensor and tag == "port" else out

    ref = jtemp.map_batched(functools.partial(fn, "jax"), (x, y), 4)
    args = ((torch.from_numpy(x), torch.from_numpy(y)) if as_tensor
            else (x, y))
    ours = ptemp.map_batched(functools.partial(fn, "port"), args, 4)
    assert isinstance(ours, torch.Tensor) == as_tensor
    assert len(calls["port"]) == len(calls["jax"]) == 3
    for a, b in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(ours), ref)


def _pairs(rng, n=5, h=24, w=32):
    frames = list(_img(rng, (n, h, w, 3)))
    flows = list((rng.standard_normal((n - 1, h, w, 2)) * 2)
                 .astype(np.float32))
    masks = list((rng.random((n - 1, h, w)) > 0.2).astype(np.float32))
    return frames, flows, masks


def test_temporal_error_sintel():
    frames, flows, masks = _pairs(np.random.default_rng(5))
    ref = jtemp.temporal_error_sintel(lambda x: _toy_model(x), frames,
                                      flows, masks, batch_size=3)
    ours = ptemp.temporal_error_sintel(_toy_model_torch, frames, flows,
                                       masks, batch_size=3)
    _close(ours, ref, 1e-5)


@pytest.mark.parametrize("metric", ["warping", "sintel_mae", "sintel_mse"])
def test_pair_terms(metric):
    rng = np.random.default_rng(6)
    frames, flows, masks = _pairs(rng)
    a, b = np.stack(frames[:-1]), np.stack(frames[1:])
    f, m = np.stack(flows), np.stack(masks)
    if metric == "warping":
        j_terms, j_step = jtemp.warping_error_terms, jtemp.warping_error_step
        p_terms, p_step = ptemp.warping_error_terms, ptemp.warping_error_step
    else:
        use_mae = metric == "sintel_mae"
        a, b = a / 255.0, b / 255.0
        j_terms = functools.partial(jtemp.sintel_optical_loss_terms,
                                    use_mae=use_mae)
        j_step = functools.partial(jtemp.sintel_optical_loss_step,
                                   use_mae=use_mae)
        p_terms = functools.partial(ptemp.sintel_optical_loss_terms,
                                    use_mae=use_mae)
        p_step = functools.partial(ptemp.sintel_optical_loss_step,
                                   use_mae=use_mae)
    jargs = tuple(jnp.asarray(v) for v in (a, b, f, m))
    pargs = tuple(torch.from_numpy(np.ascontiguousarray(v))
                  for v in (a, b, f, m))
    _close(p_terms(*pargs).numpy(), np.asarray(j_terms(*jargs)), 1e-5)
    _close(float(p_step(*pargs)), float(j_step(*jargs)), 1e-5)


def test_flow_mse():
    rng = np.random.default_rng(7)
    fa, fb = rng.standard_normal((2, 12, 16, 2)).astype(np.float32)
    assert ptemp.flow_mse(fa, fb) == jtemp.flow_mse(fa, fb)


# ------------------------------------------------------------------ LPIPS

_LPIPS_SIZE = {"vgg": (32, 32), "alex": (64, 64), "squeeze": (67, 70)}


def _lpips_pair(rng, net, n=2):
    h, w = _LPIPS_SIZE[net]
    return tuple((rng.random((n, h, w, 3)) * 2 - 1).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
def test_lpips_trunk_taps(net):
    """Every trunk tap against JAX's, block by block (the squeezenet size
    is odd, so its ceil-mode pools pad)."""
    params = jlp.random_lpips_params(0, net)
    x = _lpips_pair(np.random.default_rng(8), net)[0]
    ref = jlp._TRUNKS[net](params, jnp.asarray(x))
    ours = plp._TRUNKS[net](params_from_jax(params), torch.from_numpy(x))
    assert len(ours) == len(ref) == len(jlp.LPIPS_CHANNELS_BY_NET[net])
    for o, r in zip(ours, ref):
        _close(o.numpy(), np.asarray(r), 1e-4)


@pytest.mark.parametrize("version", ["0.1", "0.0"])
@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
def test_lpips_distance(net, version):
    params = jlp.random_lpips_params(1, net)
    a, b = _lpips_pair(np.random.default_rng(9), net)
    ref = np.asarray(jlp.lpips_distance(params, jnp.asarray(a),
                                        jnp.asarray(b), net,
                                        version=version))
    ours = plp.lpips_distance(params_from_jax(params), a, b, net,
                              version=version).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
def test_lpips_baseline_spatial_per_layer(net):
    """Baseline mode (no heads) with the spatial maps and the per-layer
    values."""
    params = jlp.random_lpips_params(2, net)
    a, b = _lpips_pair(np.random.default_rng(10), net, n=1)
    for use_lpips in (False, True):
        val, layers = jlp.lpips_distance(
            params, jnp.asarray(a), jnp.asarray(b), net, use_lpips=use_lpips,
            spatial=True, ret_per_layer=True)
        pval, players = plp.lpips_distance(
            params_from_jax(params), a, b, net, use_lpips=use_lpips,
            spatial=True, ret_per_layer=True)
        assert pval.shape == (1,) + _LPIPS_SIZE[net] + (1,)
        np.testing.assert_allclose(pval.numpy(), np.asarray(val),
                                   rtol=1e-4, atol=1e-5)
        assert len(players) == len(layers)
        for o, r in zip(players, layers):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-5)


def test_lpips_helpers(tmp_path):
    img = _img(np.random.default_rng(11), (6, 5, 3))
    np.testing.assert_array_equal(plp.image_to_lpips_input(img),
                                  jlp.image_to_lpips_input(img))
    for net in ("vgg", "alex", "squeeze"):
        a, b = plp.random_lpips_params(3, net), jlp.random_lpips_params(3, net)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # a vendored head checkpoint: "lin<k>.model.1.weight" (1, C, 1, 1)
    rng = np.random.default_rng(12)
    state = {f"lin{k}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1)).astype(np.float32))
        for k, c in enumerate(plp.LPIPS_CHANNELS)}
    path = str(tmp_path / "vgg.pth")
    torch.save(state, path)
    ours = plp.load_linear_heads(path)
    ref = params_from_jax(jlp.load_linear_heads(path))
    assert set(ours) == set(ref)
    for k in ours:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)


def test_rgb2lab_and_fakenets():
    rng = np.random.default_rng(13)
    a = rng.integers(0, 256, (20, 24, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (20, 24, 3)).astype(np.uint8)
    np.testing.assert_allclose(plp.rgb2lab(a), jlp.rgb2lab(a), rtol=1e-10,
                               atol=1e-10)
    for space in ("RGB", "Lab"):
        for fn in ("l2_baseline", "dssim_baseline"):
            ours = getattr(plp, fn)(a, b, space)
            ref = getattr(jlp, fn)(a, b, space)
            assert ours == pytest.approx(ref, rel=1e-10, abs=1e-10), (fn,
                                                                      space)


# ------------------------------------------------------- ranking trainer

def test_ranking_trainer_three_steps():
    """Three calibration steps against JAX's at 1e-5 relative: the losses
    and distances elementwise, the heads (clamped ≥ 0, some to 0) and the
    rank net of each tensor's scale.  Some head gradients sit near Adam's
    eps (1e-8, channels barely alive in the seeded trunk), where the step
    lr·g/(|g| + eps) magnifies float32 rounding in g: the learning rate is
    the JAX package's own test's, 1e-3, at which that stays under the
    tolerance (2.5e-6 of a 0.35 scale)."""
    rng = np.random.default_rng(14)
    lp = jlp.random_lpips_params(0, "alex")
    rank = jlt.init_dist2logit(1)
    ref = (rng.random((2, 64, 64, 3)) * 2 - 1).astype(np.float32)
    p0 = (rng.random((2, 64, 64, 3)) * 2 - 1).astype(np.float32)
    p1 = ref + 0.01 * rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    judge = np.array([1.0, -0.5], np.float32)
    lr = 1e-3
    j_init, j_step = jlt.make_lpips_ranking_step("alex", lr=lr)
    p_init, p_step = plt_.make_lpips_ranking_step("alex", lr=lr)
    jstate = j_init(lp, rank)
    pstate = p_init(params_from_jax(lp), params_from_jax(rank))
    for _ in range(3):
        jstate, jm = j_step(jstate, jnp.asarray(ref), jnp.asarray(p0),
                            jnp.asarray(p1), jnp.asarray(judge))
        pstate, pm = p_step(pstate, ref, p0, p1, judge)
        for k in ("loss_total", "d0", "d1"):
            np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)
    heads = params_from_jax({k: v for k, v in jstate["lpips"].items()
                             if k.startswith("lin")})
    zeros = 0
    for k, v in heads.items():
        ours = pstate.lpips[k].detach()
        assert (ours >= 0).all(), k
        zeros += int((ours == 0).sum())
        _close(ours.numpy(), v.numpy(), 1e-5)
    assert zeros > 0        # the clamp acted
    for k, v in params_from_jax(jstate["rank"]).items():
        if v.abs().max() > 0:
            _close(pstate.rank[k].detach().numpy(), v.numpy(), 1e-5)
    # the trunk did not move
    for k, v in params_from_jax(lp).items():
        if not k.startswith("lin"):
            torch.testing.assert_close(pstate.lpips[k], v, rtol=0, atol=0)


def test_dist2logit_and_bce():
    rng = np.random.default_rng(15)
    rank = jlt.init_dist2logit(2)
    d0, d1 = rng.random((2, 6)).astype(np.float32)
    judge = (rng.random(6) * 2 - 1).astype(np.float32)
    prank = params_from_jax(rank)
    ours = plt_.dist2logit(prank, torch.from_numpy(d0), torch.from_numpy(d1))
    ref = jlt.dist2logit(rank, jnp.asarray(d0), jnp.asarray(d1))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)
    ours = plt_.bce_ranking_loss(prank, torch.from_numpy(d0),
                                 torch.from_numpy(d1), torch.from_numpy(judge))
    ref = jlt.bce_ranking_loss(rank, jnp.asarray(d0), jnp.asarray(d1),
                               jnp.asarray(judge))
    _close(float(ours), float(ref), 1e-5)
    for k, v in plt_.init_dist2logit(2).items():
        np.testing.assert_array_equal(v, rank[k])


def test_scores():
    rng = np.random.default_rng(16)
    d0, d1 = rng.random((2, 40))
    d1[:5] = d0[:5]                          # ties count one half
    judges = rng.random(40)
    sames = (rng.random(40) > 0.5).astype(np.float64)
    assert plt_.score_2afc(d0, d1, judges) == jlt.score_2afc(d0, d1, judges)
    assert plt_.compute_accuracy(d0, d1, judges) == \
        jlt.compute_accuracy(d0, d1, judges)
    assert plt_.compute_accuracy(torch.from_numpy(d0), torch.from_numpy(d1),
                                 judges) == jlt.compute_accuracy(d0, d1,
                                                                 judges)
    assert plt_.score_jnd(d0, sames) == jlt.score_jnd(d0, sames)
    rec, prec = np.sort(rng.random(9)), rng.random(9)
    assert plt_.voc_ap(rec, prec) == jlt.voc_ap(rec, prec)


# ---------------------------------------------------------------- flowviz

def test_visualize_flow_bitwise():
    from vst_tpu.utils.flowviz import visualize_flow as jviz
    from vst_tpu_torch.utils.flowviz import visualize_flow

    rng = np.random.default_rng(17)
    flow = (rng.standard_normal((12, 16, 2)) * 5).astype(np.float32)
    np.testing.assert_array_equal(visualize_flow(flow), jviz(flow))
    still = np.zeros((4, 4, 2), np.float32)
    np.testing.assert_array_equal(visualize_flow(still), jviz(still))
