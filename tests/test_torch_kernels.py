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
from vst_tpu_torch.kernels import _build
from vst_tpu_torch.kernels import res_block, head_conv
from vst_tpu_torch.kernels._grad import refuse_grad


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

    @pytest.mark.parametrize("prologue", [False, True])
    def test_conv3x3_in_stats_sd_width(self, rng, prologue):
        """C = Co = 64, SD1/SD2's residual width (one 64-wide tile of the
        card's kernel), on a size that is not a multiple of its 8 x 16
        tile."""
        x = (rng.standard_normal((2, 10, 20, 64)) * 3).astype(np.float32)
        w = (rng.standard_normal((3, 3, 64, 64)) * 0.05).astype(np.float32)
        b = (rng.standard_normal(64) * 0.05).astype(np.float32)
        kw = {}
        if prologue:
            stats = np.stack([rng.standard_normal((2, 64)),
                              rng.random((2, 64)) + 0.5], 1).astype(np.float32)
            kw = dict(stats_in=stats,
                      gamma=(rng.random(64) + 0.5).astype(np.float32),
                      beta=(rng.standard_normal(64) * 0.1).astype(np.float32))
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

    @pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode",
                                      "no_requires_grad"])
    def test_refuse_grad(self, mode):
        """The guard of K1/K2's CUDA branch raises only where autograd
        would need a gradient through the kernel: grad mode on and a
        tensor argument that requires one."""
        w = torch.zeros(3, requires_grad=mode != "no_requires_grad")
        ctx = {"no_grad": torch.no_grad,
               "inference_mode": torch.inference_mode}.get(
                   mode, contextlib.nullcontext)
        with ctx():
            if mode == "grad":
                with pytest.raises(RuntimeError,
                                   match="K1 conv3x3_in_stats has no backward"):
                    refuse_grad("K1 conv3x3_in_stats", torch.zeros(3), w, None)
            else:
                refuse_grad("K1 conv3x3_in_stats", torch.zeros(3), w, None)

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
