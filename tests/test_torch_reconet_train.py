"""The port's ReCoNet training against the JAX package at a small size:
the K1 and K2 autograd Functions' gradients against ``jax.vjp`` of the
JAX plain forms, the image math, VGG16 and the losses (values and input
gradients), and the port's own step checks (remat, bf16 4-frame and SD2
steps).  One step of each builder against JAX's, and the trajectories,
are in tests/test_torch_reconet_steps.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vst_tpu import losses as jl
from vst_tpu.models import reconet as jr
from vst_tpu.models import vgg as jv
from vst_tpu.ops import gram_matrix as j_gram
from vst_tpu.ops import gram_matrix_hw as j_gram_hw
from vst_tpu.ops import rgb_to_luma709 as j_luma
from vst_tpu.ops.conv import conv2d_reflect1_k3s1
from vst_tpu_torch import losses as pl
from vst_tpu_torch.compat import params_from_jax, params_to_jax
from vst_tpu_torch.kernels import res_block
from vst_tpu_torch.models import reconet as pr
from vst_tpu_torch.models import vgg as pv
from vst_tpu_torch.ops import image as pimg
from tests.test_torch_reconet_steps import (J_INIT, _batches, _configs,
                                            _flow_mask, _port_run)

SEED_VGG, SEED_NET = 0, 1
EPS = 1e-5


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


def _rel(a, b):
    """max |a − b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# tolerance of a gradient against jax.vjp: float32 rounding of sums over
# a few hundred terms (relative to the gradient's largest element), and
# float64's
GRAD_TOL = {np.float32: 2e-5, np.float64: 1e-10}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


# --------------------------------------------------------- K1 and K2 VJPs

def _k1_inputs(rng, dtype, prologue, n=2, h=6, wd=7, c=16, co=12):
    x = rng.standard_normal((n, h, wd, c)) * 3
    w = rng.standard_normal((3, 3, c, co)) / np.sqrt(9 * c)
    b = rng.standard_normal(co) * 0.1
    args = [x, w, b]
    if prologue:
        args += [np.stack([rng.standard_normal((n, c)),
                           rng.random((n, c)) + 0.5], 1),
                 rng.random(c) + 0.5, rng.standard_normal(c) * 0.1]
    cot = (rng.standard_normal((n, h, wd, co)),
           rng.standard_normal((n, 2, co)))
    return [a.astype(dtype) for a in args], [a.astype(dtype) for a in cot]


def _jax_k1(x, w, b, stats_in=None, gamma=None, beta=None):
    """K1's function in plain JAX: the residual block's conv (the form
    ``residual_block`` runs) with the optional normalize+relu prologue,
    and the per-image channel (mean, biased var)."""
    v = x
    if stats_in is not None:
        scale = gamma * jax.lax.rsqrt(stats_in[:, 1] + EPS)
        v = jax.nn.relu((x - stats_in[:, None, None, 0]) * scale[:, None, None]
                        + beta)
    y = conv2d_reflect1_k3s1(v, w, b)
    mean = jnp.mean(y, axis=(1, 2))
    var = jnp.mean(y * y, axis=(1, 2)) - mean * mean
    return y, jnp.stack([mean, var], axis=1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_function_vjp_matches_jax(rng, dtype, prologue):
    """Every input's gradient of ``Conv3x3InStats`` (the plain forward on
    the CPU, the explicit VJP the card runs too) against ``jax.vjp``."""
    args, cot = _k1_inputs(rng, dtype, prologue)
    with _x64(dtype):
        ref, vjp = jax.vjp(_jax_k1, *map(jnp.asarray, args))
        jgrads = vjp(tuple(map(jnp.asarray, cot)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, stats = res_block.conv3x3_in_stats(*leaves)
    torch.autograd.backward((y, stats), tuple(map(torch.from_numpy, cot)))
    tol = GRAD_TOL[dtype]
    assert _rel(y.detach(), ref[0]) < tol and _rel(stats.detach(), ref[1]) < tol
    for i, (leaf, g) in enumerate(zip(leaves, jgrads)):
        assert leaf.grad.dtype == TORCH[dtype]
        assert _rel(leaf.grad, g) < tol, (i, _rel(leaf.grad, g))


def _block_params(dtype, name="res1"):
    return {k: v.astype(dtype) for k, v in jr.init_reconet(SEED_NET).items()
            if k.startswith(name + ".")}


def _instance_norm_f64(x, scale, bias, eps=EPS):
    """The JAX package's instance_norm without its float32 cast."""
    mean = jnp.mean(x, axis=(1, 2), keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=(1, 2), keepdims=True)
    return (x - mean) / jnp.sqrt(var + eps) * scale + bias


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_residual_block_vjp_matches_jax(rng, dtype, monkeypatch):
    """Two K1 Functions (the second with the prologue, fed the first's
    statistics) and the torch tail against ``jax.vjp`` of
    ``vst_tpu.models.reconet.residual_block``: the gradients of x and of
    all eight block parameters.  The JAX package normalizes in float32
    whatever the input, so the float64 case gives its residual_block an
    instance norm in float64."""
    if dtype == np.float64:
        monkeypatch.setattr(jr, "instance_norm", _instance_norm_f64)
    params = _block_params(dtype)
    x = (rng.standard_normal((2, 8, 10, 192)) * 2).astype(dtype)
    cot = rng.standard_normal(x.shape).astype(dtype)
    with _x64(dtype):
        ref, vjp = jax.vjp(lambda p, xx: jr.residual_block(p, "res1", xx),
                           {k: jnp.asarray(v) for k, v in params.items()},
                           jnp.asarray(x))
        jp, jx = vjp(jnp.asarray(cot))
    model = pr.build("reconet", params_from_jax(
        {k: v.astype(dtype) for k, v in jr.init_reconet(SEED_NET).items()}),
        device="cpu", dtype=TORCH[dtype]).res1
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt)
    out.backward(torch.from_numpy(cot))
    tol = GRAD_TOL[dtype]
    assert _rel(out.detach(), ref) < tol
    assert _rel(xt.grad, jx) < tol
    grads = params_to_jax({f"res1.{k}": p.grad
                           for k, p in model.named_parameters()})
    for k, g in jp.items():
        if k.endswith("conv1.conv2d.bias") or k.endswith("conv2.conv2d.bias"):
            # instance norm follows: the true gradient is 0, both sides
            # hold rounding noise only
            assert np.abs(grads[k]).max() < 1e3 * tol * np.abs(jx).max()
            continue
        assert _rel(grads[k], g) < tol, (k, _rel(grads[k], g))


@pytest.mark.parametrize("dtype,h,wd", [(np.float32, 12, 16),
                                        (np.float64, 13, 18)])
@pytest.mark.parametrize("name,cin", [("conv1", 3), ("deconv3", 48)])
def test_k2_function_vjp_matches_jax(rng, dtype, h, wd, name, cin):
    """The 9×9 stem and head as the port runs them (the polyphase packing
    around the K2 Function, at any size) against ``jax.vjp`` of the JAX
    package's ``conv_layer``: the gradients of the input, the weight and
    the bias.  At H, W multiples of 4 that is JAX's own polyphase form,
    whose weight packing rounds to float32, so float64 is held at a size
    where JAX takes its plain reflect-pad conv."""
    params = {k: v.astype(dtype) for k, v in jr.init_reconet(SEED_NET).items()
              if k.startswith(name + ".conv2d")}
    x = (rng.standard_normal((2, h, wd, cin)) * 10).astype(dtype)
    with _x64(dtype):
        ref, vjp = jax.vjp(
            lambda p, xx: jr.conv_layer(p, name, xx, 9, 1),
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
        cot = rng.standard_normal(ref.shape).astype(dtype)
        jp, jx = vjp(jnp.asarray(cot))
    layer = pr.ConvLayer(cin, params[f"{name}.conv2d.bias"].shape[0], 9)
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in
                           params_from_jax(params).items()})
    xt = torch.from_numpy(x).requires_grad_()
    out = layer.to(TORCH[dtype])(xt)
    out.backward(torch.from_numpy(cot))
    tol = GRAD_TOL[dtype]
    assert _rel(out.detach(), ref) < tol
    assert _rel(xt.grad, jx) < tol
    grads = params_to_jax({f"{name}.{k}": p.grad
                           for k, p in layer.named_parameters()})
    for k, g in jp.items():
        assert _rel(grads[k], g) < tol, (k, _rel(grads[k], g))


# --------------------------------------------------- image math and VGG16

def test_gram_and_luma_match_jax(rng):
    """gram_matrix (/(C·H·W)), gram_matrix_hw (/(H·W)) and rgb_to_luma709
    against JAX at rtol 1e-5."""
    f = rng.standard_normal((2, 6, 7, 16)).astype(np.float32)
    img = rng.standard_normal((2, 6, 7, 3)).astype(np.float32)
    for jfn, pfn, a in ((j_gram, pimg.gram_matrix, f),
                        (j_gram_hw, pimg.gram_matrix_hw, f),
                        (j_luma, pimg.rgb_to_luma709, img)):
        ours = pfn(torch.from_numpy(a))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(jfn(a)),
                                   rtol=1e-5, atol=1e-6)


def test_vgg16_taps_match_jax(rng):
    """The seeded VGG16's four taps and the remat forward against JAX's
    ``vgg16_features`` at rtol 1e-4 (float32 convs over up to 4608
    terms)."""
    x = rng.standard_normal((2, 24, 32, 3)).astype(np.float32)
    ref = jv.vgg16_features(jv.init_vgg16_reconet(SEED_VGG), jnp.asarray(x))
    vgg = pv.init_vgg16_reconet(SEED_VGG, device="cpu")
    assert set(vgg.state_dict()) == set(params_from_jax(
        jv.init_vgg16_reconet(SEED_VGG)))
    for remat in (False, True):
        ours = pv.vgg16_features(vgg, torch.from_numpy(x), remat=remat)
        assert list(ours) == list(ref) == ["relu1_2", "relu2_2", "relu3_3",
                                           "relu4_3"]
        for k in ref:
            np.testing.assert_allclose(ours[k].detach().numpy(),
                                       np.asarray(ref[k]), rtol=1e-4,
                                       atol=1e-4 * np.abs(ref[k]).max())


def _feats(rng, n=2):
    shapes = [(n, 8, 10, 4), (n, 4, 5, 8), (n, 2, 3, 16), (n, 1, 2, 16)]
    return [np.abs(rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _loss_cases(rng):
    """name → (JAX function, port function, differentiable inputs, other
    inputs)."""
    sf, cf = _feats(rng), _feats(rng)
    grams = [np.asarray(j_gram(jnp.asarray(f[:1]))) for f in _feats(rng)]
    flow, mask = _flow_mask(rng, 2, 16, 20)
    fm = [rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
          for _ in range(2)]
    imgs = [rng.standard_normal((2, 16, 20, 3)).astype(np.float32)
            for _ in range(4)]
    return {
        "content": (lambda *f: jl.reconet_content_loss(f[:4], f[4:]),
                    lambda *f: pl.reconet_content_loss(f[:4], f[4:]),
                    sf + cf, []),
        "style": (lambda *f: jl.reconet_style_loss(f[:4], f[4:]),
                  lambda *f: pl.reconet_style_loss(f[:4], f[4:]), sf, grams),
        "reg": (jl.reconet_reg_loss, pl.reconet_reg_loss, imgs[:1], []),
        "ftl": (jl.reconet_feature_temporal_loss,
                pl.reconet_feature_temporal_loss, fm, [flow, mask]),
        "otl": (jl.reconet_output_temporal_loss,
                pl.reconet_output_temporal_loss, imgs, [flow, mask]),
    }


@pytest.mark.parametrize("name", ["content", "style", "reg", "ftl", "otl"])
def test_losses_match_jax(rng, name):
    """Each ReCoNet loss and the gradients of its differentiable inputs
    against JAX at rtol 1e-4; the temporal losses keep the flow resize
    with its per-axis rescale, the re-binarized mask, the division by the
    nonzero count and the luma-relaxed input term."""
    jfn, pfn, diff, rest = _loss_cases(rng)[name]
    jargs = [jnp.asarray(a) for a in diff + rest]
    ref = jfn(*jargs)
    jgrads = jax.grad(lambda *d: jfn(*d, *jargs[len(diff):]),
                      argnums=tuple(range(len(diff))))(*jargs[:len(diff)])
    leaves = [torch.from_numpy(a).requires_grad_() for a in diff]
    ours = pfn(*leaves, *map(torch.from_numpy, rest))
    assert ours.dtype == torch.float32
    ours.backward()
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-4)
    for leaf, g in zip(leaves, jgrads):
        if leaf.grad is None:       # an input the loss does not read
            assert not np.asarray(g).any()
            continue
        scale = np.abs(np.asarray(g)).max()
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-5 * scale)


# ------------------------------------------------------- port-only steps

def test_remat_matches_no_remat():
    """cfg.remat (the stylizer checkpointed whole, VGG16 per segment)
    gives the flow step the same metrics, and gradients within 1e-5 of
    each key's largest (the recomputed convs may sum in another order;
    lambda_f = 1e12 makes the stem's gradients about 1e8)."""
    _, pcfg = _configs("flow")
    batches = _batches("flow", 1)
    runs = [_port_run("flow", dataclasses.replace(pcfg, remat=remat),
                      batches) for remat in (False, True)]
    for key in runs[0][0][0]:
        np.testing.assert_allclose(runs[1][0][0][key], runs[0][0][0][key],
                                   rtol=1e-6, err_msg=key)
    for key, g in runs[0][2].items():
        assert _rel(runs[1][2][key], g) < 1e-5, key


def test_bf16_multiframe_step():
    """cfg.dtype bfloat16 with input_frame_num 4: the cast model follows
    the master's constructor (a 12-channel stem), the metrics are finite,
    the masters stay float32 with float32 gradients of their own shapes,
    and they move."""
    _, pcfg = _configs("multiframe", dtype="bfloat16")
    params0 = J_INIT["reconet"](SEED_NET, 4)
    metrics, ours, grads, state = _port_run("multiframe", pcfg,
                                            _batches("multiframe", 2))
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert ours["conv1.conv2d.weight"].shape == (9, 9, 12, 48)
    for k, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and grads[k].shape == p.shape, k
        assert grads[k].dtype == torch.float32
    moved = sum(not np.array_equal(ours[k], params0[k]) for k in params0)
    assert moved >= len(params0) - 3


def test_bf16_sd2_student_shapes():
    """The bf16 cast model of an SD2 student has the student's widths."""
    _, pcfg = _configs("sd2", dtype="bfloat16")
    metrics, *_ = _port_run("sd2", pcfg, _batches("sd2", 1))
    assert np.isfinite(metrics[0]["loss"]) and np.isfinite(metrics[0]["SDL"])
