"""The port's AdaAttN kernel module and attention against the JAX package:
K3's plain version against the Pallas kernel in interpret mode, every
``attention_moments`` mode in both activations, the VGG19 taps, seeded
inits bit for bit, and JAX parameters loaded strictly into the modules."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.kernels import softmax_attention_moments_pallas
from vst_tpu.kernels.adaattn_attention import _forward as j_forward
from vst_tpu.models import adaattn as ja
from vst_tpu.models import vgg as jv
from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.kernels import adaattn_attention as k3
from vst_tpu_torch.models import adaattn as pa
from vst_tpu_torch.models import vgg as pv


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _qkv(rng, b, n, m, d, c, scale=1.0):
    return [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in (((b, n, d), scale), ((b, m, d), scale), ((b, m, c), 1))]


class TestK3Plain:
    @pytest.mark.parametrize("n,m,d,c,bq,bk", [
        (256, 256, 64, 32, 128, 128),     # exact block multiples
        (300, 520, 96, 64, 128, 256),     # padding in both n and m
        (128, 700, 48, 24, 128, 256),     # k padding only
    ])
    def test_matches_pallas(self, rng, n, m, d, c, bq, bk):
        """M1, M2 and L against the Pallas forward (interpret mode)."""
        q, k, v = _qkv(rng, 2, n, m, d, c)
        o1, o2, lse = j_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                bq, bk, True, False)
        m1, m2, lp = k3.softmax_attention_moments(t(q), t(k), t(v))
        assert lp.shape == (2, n, 1)
        for ours, ref in ((m1, o1), (m2, o2), (lp, lse)):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref)[:, :n],
                                       rtol=1e-4, atol=1e-4)

    def test_lse_is_logsumexp_of_f32_scores(self, rng):
        q, k, v = _qkv(rng, 2, 70, 90, 16, 8, scale=2.0)
        s = np.einsum("bnd,bmd->bnm", q.astype(np.float64), k)
        ref = s.max(-1) + np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1))
        _, _, lse = k3.softmax_attention_moments(t(q), t(k), t(v))
        np.testing.assert_allclose(lse[..., 0].numpy(), ref, rtol=1e-5,
                                   atol=1e-5)

    def test_extreme_logits_stable(self, rng):
        q, k, v = _qkv(rng, 1, 128, 256, 32, 16, scale=30.0)
        m1, m2, _ = k3.softmax_attention_moments(t(q), t(k), t(v))
        assert torch.isfinite(m1).all() and torch.isfinite(m2).all()
        r1, _ = softmax_attention_moments_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=128, bk=128,
            interpret=True)
        np.testing.assert_allclose(m1.numpy(), np.asarray(r1), rtol=1e-3,
                                   atol=1e-3)

    def test_bf16_rounds_p_and_v2(self, rng):
        """bf16: within one bf16 ulp of the f32 moments' scale."""
        q, k, v = _qkv(rng, 1, 64, 96, 32, 16)
        qb, kb, vb = (t(a).bfloat16() for a in (q, k, v))
        m1, m2, _ = k3.softmax_attention_moments(qb, kb, vb)
        assert m1.dtype == m2.dtype == torch.bfloat16
        r1, r2 = pa._attention_moments_softmax_exact(qb, kb, vb)
        for ours, ref in ((m1, r1), (m2, r2)):
            err = (ours.float() - ref).abs().max()
            assert err <= 2.0 ** -6 * ref.abs().max()

    def test_cpu_never_counts_launches_and_grad_raises(self, rng):
        """CPU tensors count no launch of K3, K4 or K5, with or without a
        gradient; a gradient flows (L carries none) and equals autograd
        of the exact form."""
        q, k, v = (t(a) for a in _qkv(rng, 1, 8, 8, 8, 8))
        wrappers = (k3.softmax_attention_moments, k3.softmax_attention_dq,
                    k3.softmax_attention_dkv)
        before = [w.launches for w in wrappers]
        m1, m2, lse = k3.softmax_attention_moments(q.requires_grad_(), k, v)
        assert not lse.requires_grad
        (m1.sum() + m2.sum()).backward()
        assert [w.launches for w in wrappers] == before == [0, 0, 0]
        qe = q.detach().clone().requires_grad_()
        e1, e2 = pa._attention_moments_softmax_exact(qe, k, v)
        (e1.sum() + e2.sum()).backward()
        torch.testing.assert_close(q.grad, qe.grad, rtol=1e-4, atol=1e-5)
        with torch.no_grad():
            k3.softmax_attention_moments(q, k, v)


class TestAttentionMoments:
    @pytest.mark.parametrize("activation,mode", [
        ("softmax", "exact"), ("softmax", "auto"), ("softmax", "chunked"),
        ("softmax", "pallas"), ("cosine", "exact"), ("cosine", "auto")])
    @pytest.mark.parametrize("n,m", [(96, 80), (1100, 1000)])
    def test_matches_jax(self, rng, activation, mode, n, m):
        """The port's "auto", "chunked" and "pallas" take K3's plain version
        on the CPU, which splits (1100, 1000) into two query chunks; JAX's
        "pallas" there is the Pallas kernel."""
        q, k, v = _qkv(rng, 2, n, m, 24, 16, scale=0.5)
        if activation == "softmax" and mode == "pallas" and n * m > 1024 ** 2:
            ref = softmax_attention_moments_pallas(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
        else:
            ref = ja.attention_moments(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), activation, mode)
        ours = pa.attention_moments(t(q), t(k), t(v), activation, mode)
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-5)

    def test_train_and_gradients_raise_exact_differentiates(self, rng):
        """Mode "train" and a gradient through "auto" go through the
        Function and match "exact" in value and in gradient."""
        q, k, v = (t(a) for a in _qkv(rng, 1, 16, 16, 8, 8))
        out = {}
        for mode in ("train", "auto", "exact"):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            m1, m2 = pa.attention_moments(*leaves, "softmax", mode)
            (m1.sum() + 2 * m2.sum()).backward()
            out[mode] = [m1.detach(), m2.detach()] + [x.grad for x in leaves]
        for mode in ("train", "auto"):
            for ours, ref in zip(out[mode], out["exact"]):
                assert torch.isfinite(ours).all()
                torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-5)

    def test_mesh_and_unknown_raise(self, rng):
        q, k, v = (t(a) for a in _qkv(rng, 1, 4, 4, 8, 8))
        with pytest.raises(NotImplementedError, match="scale-out"):
            pa.attention_moments(q, k, v, "cosine", mesh=object())
        with pytest.raises(ValueError, match="activation"):
            pa.attention_moments(q, k, v, "relu")
        with pytest.raises(ValueError, match="mode"):
            pa.attention_moments(q, k, v, "softmax", "flash")

    def test_broadcast_kv(self, rng):
        """K, V expanded over the batch (the cached path) equal the copy."""
        q, k, v = _qkv(rng, 3, 40, 50, 16, 8)
        kt, vt = t(k[:1]).expand(3, 50, 16), t(v[:1]).expand(3, 50, 8)
        ours = k3.softmax_attention_moments(t(q), kt, vt)
        ref = k3.softmax_attention_moments(t(q), kt.contiguous(),
                                           vt.contiguous())
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-6,
                                       atol=1e-6)


class TestInitAndWeights:
    def test_init_bit_exact(self):
        for ref, ours in ((ja.init_stylizing_network(3), pa.init_params(3)),
                          (jv.init_vgg19_adaattn(3),
                           pv.init_params(3, pv.VGG19_CFG, 29))):
            assert list(ours) == list(ref)
            for key in ref:
                assert ours[key].dtype == ref[key].dtype
                np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)

    def test_params_from_jax_load_strict(self):
        """Every JAX key (1×1 and 3×3 convs alike, HWIO → OIHW) lands in the
        port's modules with strict=True and equals the JAX array."""
        for jparams, build in ((ja.init_stylizing_network(5), pa.build),
                               (jv.init_vgg19_adaattn(5),
                                pv.build_vgg19_adaattn)):
            state = params_from_jax(jparams)
            model = build(state, device="cpu")
            sd = model.state_dict()
            assert set(sd) == set(jparams)
            for key, arr in jparams.items():
                w = sd[key].numpy()
                if arr.ndim == 4:
                    w = w.transpose(2, 3, 1, 0)
                np.testing.assert_array_equal(w, arr, err_msg=key)

    def test_load_vgg_weights(self, tmp_path):
        """From a JAX .npz, and the seeded init without a path."""
        from vst_tpu.train.checkpoint import save_params
        from vst_tpu_torch.cli.common import load_vgg_weights

        path = str(tmp_path / "vgg.npz")
        save_params(jv.init_vgg19_adaattn(4), path)
        for model, seed in ((load_vgg_weights(path, device="cpu"), 4),
                            (load_vgg_weights(None, device="cpu"), 0)):
            expect = params_from_jax(jv.init_vgg19_adaattn(seed))
            assert all(torch.equal(model.state_dict()[k], v)
                       for k, v in expect.items())

    def test_torchvision_style_extra_keys_dropped(self):
        state = params_from_jax(jv.init_vgg19_adaattn(1))
        state["features.30.weight"] = torch.zeros(3)
        state["classifier.0.weight"] = torch.zeros(3)
        model = pv.build_vgg19_adaattn(state, device="cpu")
        assert "classifier.0.weight" not in model.state_dict()


def test_vgg19_taps(rng):
    x = (rng.random((2, 32, 48, 3)) * 255).astype(np.float32)
    ref = jv.vgg19_adaattn_features(jv.init_vgg19_adaattn(2), jnp.asarray(x))
    vgg = pv.init_vgg19_adaattn(2, device="cpu")
    with torch.no_grad():
        ours = pv.vgg19_adaattn_features(vgg, t(x))
    assert list(ours) == list(ref) == list(pv.VGG19_TAPS_ADAATTN)
    for name in ref:
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
