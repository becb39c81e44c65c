"""The port's kernel modules (vst_tpu_torch/kernels) against the JAX
package's Pallas kernels.

On the CPU the wrappers take their plain PyTorch versions, held here
against the Pallas kernels in interpret mode.  The CUDA kernels themselves
run only on the card: tests/test_torch_cuda.py holds them against the
plain versions there.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.kernels.head_conv import conv3x3_valid_pallas
from vst_tpu.kernels import res_block as jrb
from vst_tpu.models import reconet as jreconet
from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.kernels import _build
from vst_tpu_torch.kernels import res_block, head_conv
from vst_tpu_torch.models import reconet as reconet_m
from vst_tpu_torch.ops import conv as ops_conv


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.fixture(scope="module")
def params():
    return jreconet.init_reconet(0)


def _block_args(params, name, dtype=torch.float32):
    keys = ["conv1.conv2d.weight", "conv1.conv2d.bias", "in1.weight",
            "in1.bias", "conv2.conv2d.weight", "conv2.conv2d.bias",
            "in2.weight", "in2.bias"]
    return [t(params[f"{name}.{k}"], dtype) for k in keys]


class TestResBlockPlain:
    """K1's plain version vs vst_tpu.kernels.res_block (interpret mode)."""

    @pytest.mark.parametrize("prologue", [False, True])
    def test_conv3x3_in_stats(self, rng, params, prologue):
        x = (rng.standard_normal((2, 16, 24, 192)) * 3).astype(np.float32)
        w = params["res1.conv1.conv2d.weight"]
        b = params["res1.conv1.conv2d.bias"]
        kw = {}
        if prologue:
            stats = np.stack([rng.standard_normal((2, 192)),
                              rng.random((2, 192)) + 0.5], 1).astype(np.float32)
            gamma = (rng.random(192) + 0.5).astype(np.float32)
            beta = (rng.standard_normal(192) * 0.1).astype(np.float32)
            kw = dict(stats_in=stats, gamma=gamma, beta=beta)
        yj, sj = jrb.conv3x3_in_stats(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            **{k: jnp.asarray(v) for k, v in kw.items()}, interpret=True)
        yt, st = res_block.conv3x3_in_stats(
            t(x), t(w), t(b), **{k: t(v) for k, v in kw.items()})
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st[:, 0].numpy(), np.asarray(sj[:, 0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(st[:, 1].numpy(), np.asarray(sj[:, 1]),
                                   rtol=1e-3, atol=1e-5)

    @pytest.mark.parametrize("c", [64, 48])
    @pytest.mark.parametrize("prologue", [False, True])
    def test_conv3x3_in_stats_sd_width(self, rng, prologue, c):
        """C = Co = 64, SD1/SD2's residual width (one 64-wide tile of the
        card's kernel), and C = Co = 48, RTNSTV's (one 48-wide tile; a
        partial channel chunk in both of the card's bodies), on a size
        that is not a multiple of its 8 x 16 tile."""
        x = (rng.standard_normal((2, 10, 20, c)) * 3).astype(np.float32)
        w = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
        b = (rng.standard_normal(c) * 0.05).astype(np.float32)
        kw = {}
        if prologue:
            stats = np.stack([rng.standard_normal((2, c)),
                              rng.random((2, c)) + 0.5], 1).astype(np.float32)
            kw = dict(stats_in=stats,
                      gamma=(rng.random(c) + 0.5).astype(np.float32),
                      beta=(rng.standard_normal(c) * 0.1).astype(np.float32))
        yj, sj = jrb.conv3x3_in_stats(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            **{k: jnp.asarray(v) for k, v in kw.items()}, interpret=True)
        yt, st = res_block.conv3x3_in_stats(
            t(x), t(w), t(b), **{k: t(v) for k, v in kw.items()})
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(st[:, 0].numpy(), np.asarray(sj[:, 0]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(st[:, 1].numpy(), np.asarray(sj[:, 1]),
                                   rtol=1e-3, atol=1e-5)

    def test_residual_block_f32(self, rng, params):
        x = (rng.standard_normal((2, 16, 24, 192)) * 3).astype(np.float32)
        ref = jrb.residual_block_fused(params, "res1", jnp.asarray(x),
                                       interpret=True)
        ours = res_block.residual_block_fused(t(x), *_block_args(params, "res1"))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)

    def test_residual_block_bf16(self, rng, params):
        pb = jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), params)
        x = (rng.standard_normal((2, 16, 24, 192)) * 3).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        ref = np.asarray(jrb.residual_block_fused(pb, "res1", xb,
                                                  interpret=True)
                         .astype(jnp.float32))
        xt = t(np.asarray(xb.astype(jnp.float32)), torch.bfloat16)
        ours = res_block.residual_block_fused(
            xt, *_block_args(params, "res1", torch.bfloat16)).float().numpy()
        # bf16 rounding points may differ by an ulp; bound by the output scale
        assert np.abs(ours - ref).max() <= 0.02 * np.abs(ref).max()


class TestHeadConvPlain:
    """K2's plain version on TestHeadConvKernel's shapes vs
    conv3x3_valid_pallas (interpret mode)."""

    @pytest.mark.parametrize("n,ho,wo,c,co,bh", [
        (2, 16, 32, 24, 12, 8),
        (1, 32, 32, 48, 48, 8),
        (2, 8, 16, 16, 4, 8),
        (1, 8, 12, 48, 256, 8),    # a packed stem (SD2's width)
        (1, 8, 12, 256, 48, 8),    # a packed head (SD2's width)
    ])
    def test_matches_pallas(self, rng, n, ho, wo, c, co, bh):
        x = rng.standard_normal((n, ho + 2, wo + 2, c)).astype(np.float32)
        w = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
        ref = conv3x3_valid_pallas(jnp.asarray(x), jnp.asarray(w), bh=bh,
                                   interpret=True)
        ours = head_conv.conv3x3_valid(t(x), t(w))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


@contextlib.contextmanager
def _plain_k1_k2():
    """The model through K1's and K2's plain versions called directly,
    differentiated by torch's own autograd."""
    saved = res_block.conv3x3_in_stats, ops_conv.conv3x3_valid
    res_block.conv3x3_in_stats = res_block.conv3x3_in_stats_plain
    ops_conv.conv3x3_valid = head_conv.conv3x3_valid_plain
    try:
        yield
    finally:
        res_block.conv3x3_in_stats, ops_conv.conv3x3_valid = saved


class TestWrappersOnCPU:
    def test_cpu_tensors_take_plain_version_without_launching(self, rng):
        before = (res_block.conv3x3_in_stats.launches,
                  head_conv.conv3x3_valid.launches)
        x = t(rng.standard_normal((1, 6, 6, 8)))
        res_block.conv3x3_in_stats(x, t(rng.standard_normal((3, 3, 8, 4))),
                                   torch.zeros(4))
        head_conv.conv3x3_valid(x, t(rng.standard_normal((3, 3, 8, 4))))
        assert (res_block.conv3x3_in_stats.launches,
                head_conv.conv3x3_valid.launches) == before == (0, 0)

    @pytest.mark.parametrize("family", ["reconet", "sd1", "sd2"])
    def test_grad_mode_forward_matches_the_plain_route(self, rng, family):
        """A ReCoNet-family forward with grad mode on runs K1 and K2 as
        their autograd Functions (plain forward on the CPU, the explicit
        VJP the card runs too) and gives every parameter the gradient the
        plain versions' own autograd gives, within 1e-9 of the largest
        gradient in float64 (the biases before an instance norm hold
        rounding noise around a true 0 on both routes)."""
        x = torch.from_numpy(rng.random((2, 20, 24, 3)) * 255)
        grads = []
        for plain in (False, True):
            model = reconet_m.FAMILIES[family]()
            model.load_state_dict(params_from_jax(
                reconet_m.init_params(family, 0)))
            model = model.double()
            with (_plain_k1_k2() if plain else contextlib.nullcontext()):
                sum(o.square().mean() for o in model(x)).backward()
            grads.append({k: p.grad for k, p in model.named_parameters()})
        scale = max(g.abs().max().item() for g in grads[1].values())
        assert grads[0].keys() == grads[1].keys()
        for k, g in grads[1].items():
            assert grads[0][k] is not None, k
            assert (grads[0][k] - g).abs().max().item() <= 1e-9 * scale, k

    def test_meta_tensors_raise(self):
        x = torch.empty((1, 6, 6, 8), device="meta")
        w = torch.empty((3, 3, 8, 4), device="meta")
        with pytest.raises(ValueError):
            head_conv.conv3x3_valid(x, w)
        with pytest.raises(ValueError):
            res_block.conv3x3_in_stats(x, w, torch.empty(4, device="meta"))


class TestBuild:
    def test_no_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_all()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load("head_conv")
        assert not list((tmp_path / "build").glob("*.so"))

    def test_every_source_is_a_kernel(self):
        import os

        cu = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                    if f.endswith(".cu"))
        assert cu == sorted(_build.KERNELS)
