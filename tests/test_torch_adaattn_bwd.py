"""The backward of the port's softmax attention moments (the plain version
of K4/K5, and the autograd Function that runs K3–K5 on the card) against
the JAX package: ``jax.vjp`` of the Pallas kernel in interpret mode, and
torch autograd of the exact form.  Tolerance 2e-3, as the JAX package's
``TestFusedAttentionVJP``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vst_tpu.kernels import softmax_attention_moments_pallas
from vst_tpu_torch.kernels import adaattn_attention as k3
from vst_tpu_torch.models import adaattn as pa

SHAPES = [(300, 520, 96, 64),    # ragged n and m (not block multiples)
          (64, 64, 448, 256)]    # relu3_1's d and c


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _inputs(rng, b, n, m, d, c, scale=1.0):
    q = rng.standard_normal((b, n, d)) * scale / d ** 0.25
    k = rng.standard_normal((b, m, d)) * scale / d ** 0.25
    v = rng.standard_normal((b, m, c))
    w1 = rng.standard_normal((b, n, c))
    w2 = rng.standard_normal((b, n, c))
    return [a.astype(np.float32) for a in (q, k, v, w1, w2)]


def _jax_vjp(q, k, v, w1, w2):
    _, vjp = jax.vjp(lambda q, k, v: softmax_attention_moments_pallas(
        q, k, v, bq=128, bk=128, interpret=True), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp((jnp.asarray(w1), jnp.asarray(w2)))]


def _torch_grads(fn, q, k, v, w1, w2, need="qkv"):
    leaves = [t(a).requires_grad_(name in need)
              for name, a in zip("qkv", (q, k, v))]
    m1, m2 = fn(*leaves)
    ((m1 * t(w1)).sum() + (m2 * t(w2)).sum()).backward()
    return [x.grad for x in leaves]


def _assert_grads(ours, ref, tol=2e-3):
    for name, o, r in zip("qkv", ours, ref):
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=tol,
                                   atol=tol, err_msg=f"d{name}")


@pytest.mark.parametrize("n,m,d,c", SHAPES)
def test_plain_backward_matches_pallas_vjp(rng, n, m, d, c):
    """softmax_attention_moments_bwd_plain against jax.vjp of the Pallas
    kernel (its two backward kernels in interpret mode)."""
    q, k, v, w1, w2 = _inputs(rng, 2, n, m, d, c)
    m1, m2, lse = k3.softmax_attention_moments_plain(t(q), t(k), t(v))
    ours = k3.softmax_attention_moments_bwd_plain(t(q), t(k), t(v), m1, m2,
                                                  lse, t(w1), t(w2))
    assert [g.shape for g in ours] == [(2, n, d), (2, m, d), (2, m, c)]
    _assert_grads(ours, _jax_vjp(q, k, v, w1, w2))


@pytest.mark.parametrize("n,m,d,c", SHAPES)
def test_function_matches_pallas_and_exact(rng, n, m, d, c):
    """The Function through ``attention_moments(..., "softmax", "train")``
    against jax.vjp of the Pallas kernel and torch autograd of the port's
    exact form; the CPU runs it without counting a kernel launch."""
    q, k, v, w1, w2 = _inputs(rng, 1, n, m, d, c)
    before = (k3.softmax_attention_dq.launches,
              k3.softmax_attention_dkv.launches)
    ours = _torch_grads(lambda q, k, v: pa.attention_moments(
        q, k, v, "softmax", "train"), q, k, v, w1, w2)
    assert (k3.softmax_attention_dq.launches,
            k3.softmax_attention_dkv.launches) == before
    _assert_grads(ours, _jax_vjp(q, k, v, w1, w2))
    _assert_grads(ours, _torch_grads(pa._attention_moments_softmax_exact,
                                     q, k, v, w1, w2))


def test_cotangent_on_m2_only(rng):
    """Only M2 reaches the loss: dM1 arrives as zeros."""
    q, k, v, _, w2 = _inputs(rng, 2, 130, 150, 40, 24, scale=2.0)

    def loss(fn):
        leaves = [t(a).requires_grad_() for a in (q, k, v)]
        (fn(*leaves)[1] * t(w2)).sum().backward()
        return [x.grad for x in leaves]

    ours = loss(lambda q, k, v: pa.attention_moments(q, k, v, "softmax",
                                                     "auto"))
    _assert_grads(ours, loss(pa._attention_moments_softmax_exact))
    _, vjp = jax.vjp(lambda q, k, v: softmax_attention_moments_pallas(
        q, k, v, bq=128, bk=128, interpret=True), *map(jnp.asarray, (q, k, v)))
    _assert_grads(ours, vjp((jnp.zeros(w2.shape), jnp.asarray(w2))))


def test_only_k_and_v_need_a_gradient(rng):
    """q without a gradient (the cached style's query side is the other
    way round): dQ is skipped and dK, dV still match."""
    q, k, v, w1, w2 = _inputs(rng, 2, 96, 80, 32, 16)
    fn = lambda q, k, v: pa.attention_moments(q, k, v, "softmax", "train")
    ours = _torch_grads(fn, q, k, v, w1, w2, need="kv")
    ref = _torch_grads(pa._attention_moments_softmax_exact, q, k, v, w1, w2,
                       need="kv")
    assert ours[0] is None
    _assert_grads(ours[1:], ref[1:])


def test_broadcast_kv_gradient_sums_over_the_batch(rng):
    """K and V expanded over the batch (stride 0): the Function returns
    full-batch dK, dV and autograd sums them through the expand."""
    q, k, v, w1, w2 = _inputs(rng, 3, 50, 60, 16, 8)
    k, v = k[:1], v[:1]

    def grads(fn):
        leaves = [t(a).requires_grad_() for a in (q, k, v)]
        m1, m2 = fn(leaves[0], leaves[1].expand(3, -1, -1),
                    leaves[2].expand(3, -1, -1))
        ((m1 * t(w1)).sum() + (m2 * t(w2)).sum()).backward()
        return [x.grad for x in leaves]

    ours = grads(lambda q, k, v: k3.softmax_attention_moments(q, k, v)[:2])
    assert ours[1].shape == (1, 60, 16) and ours[2].shape == (1, 60, 8)
    _assert_grads(ours, grads(pa._attention_moments_softmax_exact))


def test_bf16_against_f32(rng):
    """bf16 inputs and cotangents: dQ, dK, dV come back in bf16 and lie
    within 2^-5 of each gradient's scale of the f32 run on the same
    (bf16-representable) values: bf16 rounds the output, A, dS, V∘V and
    the cotangents, each a relative 2^-9 step."""
    q, k, v, w1, w2 = _inputs(rng, 2, 128, 192, 64, 32)
    qb, kb, vb, w1b, w2b = (t(a).bfloat16() for a in (q, k, v, w1, w2))
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        x = [a.to(dtype) for a in (qb, kb, vb)]
        m1, m2, lse = k3.softmax_attention_moments_plain(*x)
        out.append(k3.softmax_attention_moments_bwd_plain(
            *x, m1, m2, lse, w1b.to(dtype), w2b.to(dtype)))
    for name, lo, hi in zip("qkv", *out):
        assert lo.dtype == torch.bfloat16, name
        err = (lo.float() - hi).abs().max()
        assert err <= 2.0 ** -5 * hi.abs().max(), name
