"""The port's AdaAttN stylizer against the JAX package at a small size:
``stylizing_network`` in both activations, the two goldens, and the
cached-style path against the direct one."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.models import adaattn as ja
from vst_tpu.models import vgg as jv
from vst_tpu_torch.models import adaattn as pa
from vst_tpu_torch.models import vgg as pv

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens", "reference_numerics.npz")


def images(seed, n=2, h=32, w=48):
    rng = np.random.default_rng(seed)
    return [(rng.random((n, h, w, 3)) * 255).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def port():
    return (pv.init_vgg19_adaattn(0, device="cpu"),
            pa.init_stylizing_network(1, device="cpu"))


def _rel(ours, ref):
    return np.abs(np.asarray(ours) - np.asarray(ref)).max() / np.abs(
        np.asarray(ref)).max()


@pytest.mark.parametrize("activation", ["softmax", "cosine"])
def test_stylizing_network(port, activation):
    c, s = images(3)
    vp, ap = jv.init_vgg19_adaattn(0), ja.init_stylizing_network(1)
    ref = ja.stylizing_network(ap, jv.vgg19_adaattn_features(vp, jnp.asarray(c)),
                               jv.vgg19_adaattn_features(vp, jnp.asarray(s)),
                               activation)
    vgg, net = port
    with torch.no_grad():
        ours = pa.stylizing_network(net, vgg(torch.from_numpy(c)),
                                    vgg(torch.from_numpy(s)), activation)
    assert ours.shape == ref.shape == (2, 32, 48, 3)
    assert _rel(ours.numpy(), ref) <= 2e-3


@pytest.mark.parametrize("activation", ["softmax", "cosine"])
def test_goldens(activation):
    """The reference's numerics (functional-torch oracles, seed-7 inits),
    reproduced without JAX, at the JAX test's tolerance."""
    with np.load(GOLDENS) as z:
        x, s, gold = z["input_x"], z["input_s"], z[f"adaattn_{activation}"]
    vgg = pv.init_vgg19_adaattn(7, device="cpu")
    net = pa.init_stylizing_network(7, device="cpu")
    with torch.no_grad():
        out = net(vgg(torch.from_numpy(x)), vgg(torch.from_numpy(s)),
                  activation)
    np.testing.assert_allclose(out.numpy(), gold, rtol=5e-2, atol=5e-2)
    assert _rel(out.numpy(), gold) <= 1e-4


@pytest.mark.parametrize("activation,mode", [("softmax", "auto"),
                                             ("softmax", "pallas"),
                                             ("cosine", "auto"),
                                             ("cosine", "exact")])
def test_cached_equals_direct(port, activation, mode):
    """style_state + stylizing_network_cached give stylizing_network's
    output for a style broadcast over the content batch."""
    vgg, net = port
    c, s = images(4)
    with torch.no_grad():
        fc = vgg(torch.from_numpy(c))
        fs1 = vgg(torch.from_numpy(s[:1]))
        fs = {k: v.expand(2, *v.shape[1:]).contiguous() for k, v in fs1.items()}
        direct = pa.stylizing_network(net, fc, fs, activation, mode)
        state = pa.style_state(net, fs1, activation, mode)
        cached = pa.stylizing_network_cached(net, fc, state, activation, mode)
    assert ("ksum" in state[0]) == (activation == "cosine" and mode != "exact")
    assert _rel(cached.numpy(), direct.numpy()) <= 1e-5


def test_cosine_state_moments_equal_linear_form():
    """At the attention level, where the decoder cannot damp a difference:
    the moments from a style state equal the batched linear form's."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 30, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 40, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 40, 8)).astype(np.float32))
    ref = pa._attention_moments_cosine_linear(q, k.expand(2, 40, 16),
                                              v.expand(2, 40, 8))
    kn = pa._unit_rows(k)
    ours = pa._cosine_moments(
        q, kn.sum(1)[0], torch.einsum("bmd,bmc->bdc", kn, v)[0],
        torch.einsum("bmd,bmc->bdc", kn, v * v)[0], v.sum(1)[0],
        (v * v).sum(1)[0], 40.0)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-5, atol=1e-6)


def test_style_state_matches_jax(port):
    vgg, net = port
    _, s = images(5, n=1)
    vp, ap = jv.init_vgg19_adaattn(0), ja.init_stylizing_network(1)
    ref = ja.style_state(ap, jv.vgg19_adaattn_features(vp, jnp.asarray(s)),
                         "cosine")
    with torch.no_grad():
        ours = pa.style_state(net, vgg(torch.from_numpy(s)), "cosine")
    for r, o in zip(ref, ours):
        assert set(r) == set(o)
        for key in r:
            np.testing.assert_allclose(np.asarray(o[key]), np.asarray(r[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)


def test_no_conv_module_and_guards(port, tmp_path):
    """adaattn_no_conv (the local-loss target) against JAX; a style state
    refuses a batch of styles; a world-1 mesh gives the bits of mesh=None
    and tokens that do not divide by the mesh axis raise; remat gives the
    forward and the gradients of no remat."""
    from tests.torch_dist import mesh_of, world1

    rng = np.random.default_rng(6)
    cx, sx = (rng.standard_normal((1, 6, 8, 16)).astype(np.float32)
              for _ in range(2))
    ref = ja.adaattn_no_conv(jnp.asarray(cx), jnp.asarray(sx), jnp.asarray(cx),
                             jnp.asarray(sx), "softmax")
    ours = pa.adaattn_no_conv(*(torch.from_numpy(a) for a in (cx, sx, cx, sx)),
                              "softmax")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    vgg, net = port
    c, s = images(7)
    with torch.no_grad():
        fc = vgg(torch.from_numpy(c))
        with pytest.raises(ValueError, match="one style"):
            pa.style_state(net, fc)
        with world1(tmp_path) as mesh:
            for act in ("softmax", "cosine"):
                torch.testing.assert_close(
                    pa.stylizing_network(net, fc, fc, act, mesh=mesh),
                    pa.stylizing_network(net, fc, fc, act), rtol=0, atol=0)
        with pytest.raises(ValueError, match="divide by the 5-way"):
            pa.stylizing_network(net, fc, fc, mesh=mesh_of(5))
    grads = []
    for remat in (False, True):
        net.zero_grad()
        out = pa.stylizing_network(net, fc, fc, "softmax", "train",
                                   remat=remat)
        out.square().mean().backward()
        grads.append((out.detach(), {k: p.grad.clone()
                                     for k, p in net.named_parameters()}))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=0, atol=0)
    for key, g in grads[0][1].items():
        torch.testing.assert_close(grads[1][1][key], g, rtol=1e-5, atol=1e-12)
