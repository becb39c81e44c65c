"""The 3xTF32 split of the port's float32 K3, K4 and K5
(``csrc/adaattn_fwd.cu`` ``attn_fwd_tf32``, ``csrc/adaattn_bwd.cu``
``attn_dq_tf32`` and ``attn_dkv_tf32``) and of the float32 K1 and K2
(``csrc/conv3x3_tf32.cuh``; K1 at C, Co <= 64 in
``csrc/conv3x3_tf32_narrow.cuh``), emulated in torch on the CPU: the
kernels' arithmetic without the card.  Each operand
x of a product is split as the kernels split it, big = tf32(x) and small
= tf32(x − big), both rounded to nearest with ties away from zero
(``cvt.rna.tf32.f32``); a product is a_small·b_big + a_big·b_small +
a_big·b_big with small·small dropped, the small terms of a stage first,
each stage summed into a fresh partial that is added to the running sum in
float32, in the kernel's order.  K5's stages are 32 columns of d or c, and
one 64-query tile in the output products; K4's the same with queries and
keys swapped (one 64-key tile in dS·K); K3's are 32 columns of d for S
and one 64-key tile for P·V and P·W, whose partial is added as M = M·α +
partial after the online softmax's rescale; K1's and K2's one (32-channel
chunk, tap) pair, chunk by chunk and in each the nine taps.  The
emulation lives here, not in the package.

dQ, dK and dV, and K3's M1, M2 and L, are held within 1e-4 of each
output's scale (L within 1e-5 of max|L|) against the Pallas kernels in
interpret mode (float32; ``jax.vjp`` for K4 and K5), as
``test_torch_adaattn_bwd.py`` and
``test_torch_adaattn.py`` hold the plain versions, at scores of std 1 and
10, where JAX and the port's plain float32 agree well within that
tolerance.  At std 100 (the card test's q, k × 10) float32 itself is off
the exact value by nearly the tolerance, and the emulation may lie on the
other side of it, so there the emulation is held against the same
formulas evaluated in float64 (the plain versions on float64 inputs), as
the card tests hold the kernels.  The conv emulation is held within 1e-4
of each output's scale against the Pallas K1 and K2 in interpret mode and
against the float64 evaluation.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vst_tpu.kernels import res_block as jrb
from vst_tpu.kernels import softmax_attention_moments_pallas
from vst_tpu.kernels.adaattn_attention import _forward as j_forward
from vst_tpu.kernels.head_conv import conv3x3_valid_pallas
from vst_tpu_torch.kernels import adaattn_attention as att
from vst_tpu_torch.kernels import head_conv, res_block
from vst_tpu_torch.ops.pad import reflection_pad2d

SHAPES = [(2, 300, 520, 96, 64),    # ragged n and m, d and c under a slice
          (2, 64, 64, 448, 256)]    # relu3_1's d and c
FW = 32    # columns of a stage: one 128-byte row of float32
T = 64     # queries (K5) or keys (K3) of a tile


def tf32(x):
    """cvt.rna.tf32.f32: to nearest, ties away from zero, low 13 bits 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b, stage):
    """a @ b (float32, batched) as the kernel's 3xTF32 products, the
    reduction in stages of ``stage`` columns, each into a fresh partial."""
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], stage):
        k = slice(k0, k0 + stage)
        part = as_[..., k] @ bb[..., k, :] + ab[..., k] @ bs[..., k, :]
        acc = acc + (part + ab[..., k] @ bb[..., k, :])
    return acc


def dkv_tf32x3(q, k, v, lse, dd, dm1, dm2):
    """The f32 K5's dK, dV.  dK role: S^T over all of d, dA^T in stages
    of (V, dM1) and (W, dM2) per 32 columns of c; dV role: S^T over the
    two halves of d's stages, added; then the output products over each
    64-query tile."""
    d = q.shape[-1]
    st = mm3(k, q.transpose(1, 2), FW)
    w = v * v
    da = torch.zeros_like(st)
    for c0 in range(0, v.shape[-1], FW):
        c = slice(c0, c0 + FW)
        da = da + mm3(v[..., c], dm1[..., c].transpose(1, 2), FW)
        da = da + mm3(w[..., c], dm2[..., c].transpose(1, 2), FW)
    half = (-(-d // FW) + 1) // 2 * FW
    st_v = (mm3(k[..., :half], q[..., :half].transpose(1, 2), FW)
            + mm3(k[..., half:], q[..., half:].transpose(1, 2), FW))
    lt, dt = lse.transpose(1, 2), dd.transpose(1, 2)
    a_k = torch.exp(st - lt)
    ds = a_k * (da - dt)
    a_v = torch.exp(st_v - lt)
    dk = mm3(ds, q, T)
    dv = mm3(a_v, dm1, T) + 2.0 * v * mm3(a_v, dm2, T)
    return dk, dv


def _inputs(rng, b, n, m, d, c, std):
    s = std ** 0.5 / d ** 0.25
    q = rng.standard_normal((b, n, d)) * s
    k = rng.standard_normal((b, m, d)) * s
    v = rng.standard_normal((b, m, c))
    w1 = rng.standard_normal((b, n, c))
    w2 = rng.standard_normal((b, n, c))
    return [torch.from_numpy(a.astype(np.float32)) for a in (q, k, v, w1, w2)]


def _jax_vjp(q, k, v, w1, w2):
    _, vjp = jax.vjp(lambda q, k, v: softmax_attention_moments_pallas(
        q, k, v, bq=128, bk=128, interpret=True),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    return [torch.from_numpy(np.asarray(g))
            for g in vjp((jnp.asarray(w1.numpy()), jnp.asarray(w2.numpy())))]


def _rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def test_tf32_rounding():
    """The emulated cvt.rna.tf32.f32 keeps 10 mantissa bits, rounds to
    nearest with ties away from zero, and the split reconstructs x within
    2^-22 of |x|."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, one], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000)
                         .astype(np.float32))
    big, small = split(y)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((big.double() + small.double() - y.double()).abs()
            <= 2.0 ** -22 * y.double().abs()).all()


@pytest.mark.parametrize("b,n,m,d,c", SHAPES)
@pytest.mark.parametrize("std", [1.0, 10.0, 100.0])
def test_split_meets_the_card_tolerance(rng, b, n, m, d, c, std):
    q, k, v, w1, w2 = _inputs(rng, b, n, m, d, c, std)
    m1, m2, lse = att.softmax_attention_moments_plain(q, k, v)
    dd = att.row_term(m1, m2, w1, w2)
    dk, dv = dkv_tf32x3(q, k, v, lse, dd, w1, w2)
    assert dk.shape == (b, m, d) and dv.shape == (b, m, c)
    if std < 100.0:
        ref = _jax_vjp(q, k, v, w1, w2)[1:]
    else:
        ref = att.softmax_attention_dkv_plain(
            q.double(), k.double(), v.double(), lse, dd, w1.double(),
            w2.double())
    for name, ours, r in (("dK", dk, ref[0]), ("dV", dv, ref[1])):
        assert _rel(ours, r) <= 1e-4, (name, _rel(ours, r))


def moments_tf32x3(q, k, v):
    """The f32 K3's M1, M2 and L: per key tile of 64, S over d in stages
    of 32 columns, the online softmax in natural exponentials (running
    max, rescale α), P split from its float32 values, M = M·α + the tile's
    3xTF32 product (W = V∘V in float32), and M·(1/l) at the end."""
    b, n, _ = q.shape
    w = v * v
    mrow = torch.full((b, n, 1), -1e30)
    l = torch.zeros((b, n, 1))
    m1 = torch.zeros((b, n, v.shape[-1]))
    m2 = torch.zeros_like(m1)
    for j0 in range(0, k.shape[1], T):
        keys = slice(j0, j0 + T)
        s = mm3(q, k[:, keys].transpose(1, 2), FW)
        mnew = torch.maximum(mrow, s.amax(-1, keepdim=True))
        alpha = torch.exp(mrow - mnew)
        p = torch.exp(s - mnew)
        l = l * alpha + p.sum(-1, keepdim=True)
        m1 = m1 * alpha + mm3(p, v[:, keys], T)
        m2 = m2 * alpha + mm3(p, w[:, keys], T)
        mrow = mnew
    inv = 1.0 / l
    return m1 * inv, m2 * inv, mrow + torch.log(l)


@pytest.mark.parametrize("b,n,m,d,c", SHAPES)
@pytest.mark.parametrize("std", [1.0, 10.0, 100.0])
def test_k3_split_meets_the_card_tolerance(rng, b, n, m, d, c, std):
    q, k, v = _inputs(rng, b, n, m, d, c, std)[:3]
    m1, m2, lse = moments_tf32x3(q, k, v)
    assert m1.shape == m2.shape == (b, n, c) and lse.shape == (b, n, 1)
    if std < 100.0:
        ref = [torch.from_numpy(np.asarray(r)[:, :n]) for r in j_forward(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)), 128, 128, True,
            False)]
    else:
        ref = att.softmax_attention_moments_plain(q.double(), k.double(),
                                                  v.double())
    for name, ours, r in (("M1", m1, ref[0]), ("M2", m2, ref[1])):
        assert _rel(ours, r) <= 1e-4, (name, _rel(ours, r))
    assert _rel(lse, ref[2]) <= 1e-5, ("L", _rel(lse, ref[2]))


def dq_tf32x3(q, k, v, lse, dd, dm1, dm2):
    """The f32 K4's dQ: S over d in stages of 32 columns, dA in stages of
    (dM1, V) and (dM2, W) per 32 columns of c, dS = A∘(dA − D) with A =
    exp(S − L), then dS·K over each 64-key tile in a fresh partial."""
    s = mm3(q, k.transpose(1, 2), FW)
    w = v * v
    da = torch.zeros_like(s)
    for c0 in range(0, v.shape[-1], FW):
        c = slice(c0, c0 + FW)
        da = da + mm3(dm1[..., c], v[..., c].transpose(1, 2), FW)
        da = da + mm3(dm2[..., c], w[..., c].transpose(1, 2), FW)
    ds = torch.exp(s - lse) * (da - dd)
    return mm3(ds, k, T)


@pytest.mark.parametrize("b,n,m,d,c", SHAPES)
@pytest.mark.parametrize("std", [1.0, 10.0, 100.0])
def test_k4_split_meets_the_card_tolerance(rng, b, n, m, d, c, std):
    q, k, v, w1, w2 = _inputs(rng, b, n, m, d, c, std)
    m1, m2, lse = att.softmax_attention_moments_plain(q, k, v)
    dd = att.row_term(m1, m2, w1, w2)
    dq = dq_tf32x3(q, k, v, lse, dd, w1, w2)
    assert dq.shape == (b, n, d)
    if std < 100.0:
        ref = _jax_vjp(q, k, v, w1, w2)[0]
    else:
        ref = att.softmax_attention_dq_plain(
            q.double(), k.double(), v.double(), lse, dd, w1.double(),
            w2.double())
    assert _rel(dq, ref) <= 1e-4, _rel(dq, ref)


KC = 32    # channels of a conv stage: one 128-byte row of float32


def conv3x3_tf32x3(x, w, b=None, stats_in=None, gamma=None, beta=None):
    """The f32 K2 (``b`` None: VALID over the packed input) or K1 (reflect
    padding, bias, per-image mean and biased variance, with the prologue
    relu((x − mean)·scale + beta) in float32 when ``stats_in`` is given),
    as the card computes it: input and weights split, and per 32-channel
    chunk and, in it, per tap a fresh partial of the 3xTF32 products
    (small terms first) added to the accumulator in float32; then the
    bias, and the statistics from the float32 result."""
    v = x
    if stats_in is not None:
        mean, scale, bt = res_block._prologue(stats_in, gamma, beta)
        v = torch.relu((x - mean[:, None, None, :]) * scale[:, None, None, :]
                       + bt)
    if b is not None:
        v = reflection_pad2d(v, 1)
    n, hp, wp, c = v.shape
    ho, wo = hp - 2, wp - 2
    (vb, vs), (wb, ws) = split(v), split(w)
    acc = torch.zeros((n, ho, wo, w.shape[3]), dtype=torch.float32)
    for c0 in range(0, c, KC):
        k = slice(c0, c0 + KC)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            ab = vb[:, dy:dy + ho, dx:dx + wo, k]
            as_ = vs[:, dy:dy + ho, dx:dx + wo, k]
            part = as_ @ wb[dy, dx, k] + ab @ ws[dy, dx, k]
            acc = acc + (part + ab @ wb[dy, dx, k])
    if b is None:
        return acc
    y = acc + b
    hw = float(ho * wo)
    mean = y.sum(dim=(1, 2)) / hw
    var = (y * y).sum(dim=(1, 2)) / hw - mean * mean
    return y, torch.stack([mean, var], dim=1)


def _conv_inputs(rng, n, h, wd, c, co, scale=1.0):
    x = rng.standard_normal((n, h, wd, c)) * scale
    w = rng.standard_normal((3, 3, c, co)) * 0.05
    b = rng.standard_normal(co) * 0.05
    stats = np.stack([rng.standard_normal((n, c)), rng.random((n, c)) * 9 + 1],
                     1)
    gamma = rng.random(c) + 0.5
    beta = rng.standard_normal(c)
    return [torch.from_numpy(a.astype(np.float32))
            for a in (x, w, b, stats, gamma, beta)]


@pytest.mark.parametrize("n,hp,wp,c,co", [(2, 10, 18, 48, 64),   # a stem's C
                                          (1, 11, 21, 40, 24),   # ragged chunk
                                          (1, 6, 9, 6, 10)])     # C, Co % 4 ≠ 0
def test_k2_split_meets_the_card_tolerance(rng, n, hp, wp, c, co):
    x, w = _conv_inputs(rng, n, hp, wp, c, co)[:2]
    y = conv3x3_tf32x3(x, w)
    assert y.shape == (n, hp - 2, wp - 2, co)
    ref = torch.from_numpy(np.asarray(conv3x3_valid_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        bh=math.gcd(hp - 2, 8), interpret=True)))
    assert _rel(y, ref) <= 1e-4, _rel(y, ref)
    exact = head_conv.conv3x3_valid_plain(x.double(), w.double())
    assert exact.dtype == torch.float64
    assert _rel(y, exact) <= 1e-4, _rel(y, exact)


@pytest.mark.parametrize("n,h,wd,c,co", [(2, 10, 18, 40, 24),
                                         (1, 9, 17, 6, 10),
                                         # the narrow body's widths
                                         (1, 18, 17, 48, 48),
                                         (1, 17, 18, 64, 64)])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_split_meets_the_card_tolerance(rng, n, h, wd, c, co, prologue):
    """The f32 K1's arithmetic: both bodies (conv3x3_tf32.cuh, and
    conv3x3_tf32_narrow.cuh at C, Co <= 64, whose 16 x 16 tiles change no
    pixel's order of stages) sum each (32-channel chunk, tap) stage of a
    pixel in a fresh partial in the same order, so one emulation holds
    both; at 48 and 64 channels it is the narrow body's: a full and a
    ragged chunk, and two full ones."""
    x, w, b, stats, gamma, beta = _conv_inputs(rng, n, h, wd, c, co, 3.0)
    kw = dict(stats_in=stats, gamma=gamma, beta=beta) if prologue else {}
    y, s = conv3x3_tf32x3(x, w, b, **kw)
    assert y.shape == (n, h, wd, co) and s.shape == (n, 2, co)
    yj, sj = jrb.conv3x3_in_stats(
        *(jnp.asarray(t.numpy()) for t in (x, w, b)),
        **{k: jnp.asarray(v.numpy()) for k, v in kw.items()}, interpret=True)
    exact = res_block.conv3x3_in_stats_plain(
        x.double(), w.double(), b.double(),
        **{k: v.double() for k, v in kw.items()})
    assert exact[0].dtype == exact[1].dtype == torch.float64
    for ref in ((torch.from_numpy(np.asarray(yj)),
                 torch.from_numpy(np.asarray(sj))), exact):
        assert _rel(y, ref[0]) <= 1e-4, _rel(y, ref[0])
        assert _rel(s, ref[1]) <= 1e-4, _rel(s, ref[1])
