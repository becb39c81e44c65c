"""The port's CUDA kernels and model on the card, against their plain
PyTorch versions.  Every test here needs a CUDA device and skips without
one.  The file imports neither JAX nor vst_tpu, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from vst_tpu_torch.kernels import adaattn_attention, head_conv, res_block

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(y, ref, tol):
    assert (y.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -7)])
def test_k1_ragged_shapes(cuda, dtype, tol):
    """A pixel count and channel counts that are not multiples of the
    kernel's 64×64 tile, with and without the prologue."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(2, 20, 27, 40, device=cuda, generator=g) * 3).to(dtype)
    w = (torch.randn(3, 3, 40, 80, device=cuda, generator=g) * 0.05).to(dtype)
    b = (torch.randn(80, device=cuda, generator=g) * 0.05).to(dtype)
    before = res_block.conv3x3_in_stats.launches
    y, s = res_block.conv3x3_in_stats(x, w, b)
    yp, sp = res_block.conv3x3_in_stats_plain(x, w, b)
    _close(y, yp, tol)
    torch.testing.assert_close(s, sp, rtol=1e-3, atol=1e-3)
    w2 = (torch.randn(3, 3, 80, 72, device=cuda, generator=g) * 0.05).to(dtype)
    b2 = (torch.randn(72, device=cuda, generator=g) * 0.05).to(dtype)
    gm = torch.rand(80, device=cuda, generator=g) + 0.5
    bt = torch.randn(80, device=cuda, generator=g)
    y2, s2 = res_block.conv3x3_in_stats(y, w2, b2, s, gm, bt)
    y2p, s2p = res_block.conv3x3_in_stats_plain(y, w2, b2, s, gm, bt)
    _close(y2, y2p, tol)
    torch.testing.assert_close(s2, s2p, rtol=1e-3, atol=1e-3)
    assert res_block.conv3x3_in_stats.launches == before + 2


@pytest.mark.parametrize("c,co", [(48, 768), (768, 48), (24, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -7)])
def test_k2(cuda, c, co, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 18, 35, c, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, c, co, device=cuda, generator=g) * 0.05).to(dtype)
    before = head_conv.conv3x3_valid.launches
    _close(head_conv.conv3x3_valid(x, w), head_conv.conv3x3_valid_plain(x, w),
           tol)
    assert head_conv.conv3x3_valid.launches == before + 1


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 6, 6, 8, device=cuda)
    w = torch.zeros(3, 3, 8, 4, device=cuda)
    with pytest.raises(TypeError):
        head_conv.conv3x3_valid(x.half(), w.half())
    with pytest.raises(ValueError):
        head_conv.conv3x3_valid(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        res_block.conv3x3_in_stats(x, w, torch.zeros(5, device=cuda))
    with pytest.raises(ValueError, match="multiples of 8"):
        head_conv.conv3x3_valid(x.bfloat16(), w.bfloat16())


def test_model_routes_through_the_kernels(cuda):
    """A small f32 ReCoNet forward launches K1 ten times and K2 twice, and
    matches the CPU forward of the same weights."""
    from vst_tpu_torch.models.reconet import init_reconet

    x = torch.rand(1, 36, 44, 3, generator=torch.Generator().manual_seed(0)) * 255
    ref = init_reconet(0, device="cpu")(x)
    before = (res_block.conv3x3_in_stats.launches,
              head_conv.conv3x3_valid.launches)
    with torch.inference_mode():
        ours = init_reconet(0, device=cuda)(x.to(cuda))
    after = (res_block.conv3x3_in_stats.launches,
             head_conv.conv3x3_valid.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (10, 2)
    for o, r in zip(ours, ref):
        torch.testing.assert_close(o.cpu(), r.detach(), rtol=2e-3, atol=2e-3)


K3_SHAPES = [(256, 256, 64, 32),    # tile multiples
             (300, 520, 96, 64),    # ragged n and m
             (128, 700, 48, 24),    # ragged m, d and c under one tile
             (200, 330, 448, 256)]  # relu3_1's d and c, two channel slices


def _k3_inputs(cuda, b, n, m, d, c, dtype, broadcast=False):
    g = torch.Generator(device=cuda).manual_seed(n + m)
    q = torch.randn(b, n, d, device=cuda, generator=g) / d ** 0.25
    kb = 1 if broadcast else b
    k = torch.randn(kb, m, d, device=cuda, generator=g) / d ** 0.25
    v = torch.randn(kb, m, c, device=cuda, generator=g)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if broadcast:
        k, v = k.expand(b, m, d), v.expand(b, m, c)
    return q, k, v


@pytest.mark.parametrize("n,m,d,c", K3_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("broadcast", [False, True])
def test_k3(cuda, n, m, d, c, dtype, tol, broadcast):
    """M1, M2 within one bf16 ulp of the output scale plus the f32
    difference of P rounded against a running max (bf16), 1e-4 in f32;
    L to 1e-5 of its scale.  ``broadcast``: one K and V for the batch,
    read through a batch stride of 0."""
    q, k, v = _k3_inputs(cuda, 2, n, m, d, c, dtype, broadcast)
    before = adaattn_attention.softmax_attention_moments.launches
    m1, m2, lse = adaattn_attention.softmax_attention_moments(q, k, v)
    p1, p2, pl = adaattn_attention.softmax_attention_moments_plain(q, k, v)
    torch.cuda.synchronize()
    assert adaattn_attention.softmax_attention_moments.launches == before + 1
    assert m1.dtype == dtype and lse.shape == (2, n, 1)
    _close(m1, p1, tol)
    _close(m2, p2, tol)
    _close(lse, pl, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_extreme_logits(cuda, dtype):
    """Scores in the thousands: the online softmax stays finite and exact.
    bf16 (base-2 running max and rescale, P rounded to bf16) holds to
    2^-6 of the output scale, as in ``test_k3``."""
    q, k, v = _k3_inputs(cuda, 1, 128, 256, 32, 16, dtype)
    q, k = q * 30, k * 30
    m1, m2, _ = adaattn_attention.softmax_attention_moments(q, k, v)
    p1, p2, _ = adaattn_attention.softmax_attention_moments_plain(q, k, v)
    assert torch.isfinite(m1).all() and torch.isfinite(m2).all()
    if dtype == torch.float32:
        torch.testing.assert_close(m1, p1, rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(m2, p2, rtol=1e-3, atol=1e-3)
    else:
        _close(m1, p1, 2.0 ** -6)
        _close(m2, p2, 2.0 ** -6)


def test_k3_rejects_what_it_does_not_take(cuda):
    q, k, v = _k3_inputs(cuda, 1, 16, 16, 32, 16, torch.float32)
    with pytest.raises(ValueError, match="one CUDA device"):
        adaattn_attention.softmax_attention_moments(q, k.cpu(), v)
    with pytest.raises(NotImplementedError, match="no backward"):
        adaattn_attention.softmax_attention_moments(
            q.requires_grad_(), k, v)
    q = q.detach()
    with pytest.raises(ValueError, match="multiples of 8"):
        adaattn_attention.softmax_attention_moments(
            q[..., :30].contiguous().bfloat16(), k[..., :30].contiguous()
            .bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        adaattn_attention.softmax_attention_moments(
            torch.cat([q, q], dim=2)[..., ::2], k, v)


def test_adaattn_routes_through_k3(cuda):
    """A small f32 AdaAttN forward launches K3 once per attention level in
    softmax (direct and cached) and never in cosine, matches the CPU
    forward of the same weights, and refuses a forward that needs a
    gradient."""
    from vst_tpu_torch.infer.image import (adaattn_style_state,
                                           stylize_adaattn,
                                           stylize_adaattn_cached)
    from vst_tpu_torch.models.adaattn import init_stylizing_network
    from vst_tpu_torch.models.vgg import init_vgg19_adaattn

    gen = torch.Generator().manual_seed(0)
    c = torch.rand(2, 64, 96, 3, generator=gen) * 255
    s = torch.rand(1, 64, 96, 3, generator=gen) * 255
    cpu = (init_vgg19_adaattn(0, device="cpu"),
           init_stylizing_network(1, device="cpu"))
    card = (init_vgg19_adaattn(0, device=cuda),
            init_stylizing_network(1, device=cuda))
    count = adaattn_attention.softmax_attention_moments
    for act, per in (("softmax", 3), ("cosine", 0)):
        ref = stylize_adaattn(*cpu, c, s.expand(2, -1, -1, -1), act)
        before = count.launches
        ours = stylize_adaattn(*card, c.to(cuda), s.expand(2, -1, -1, -1), act)
        cached = stylize_adaattn_cached(
            *card, c, adaattn_style_state(*card, s, act), act)
        torch.cuda.synchronize()
        assert count.launches - before == 2 * per
        _close(ours.cpu(), ref, 2e-3)
        _close(cached.cpu(), ref, 2e-3)
    vgg, net = card
    with torch.no_grad():
        feats = vgg(c.to(cuda))
    with pytest.raises(NotImplementedError, match="K4/K5"):
        net(feats, {k: v.requires_grad_() for k, v in feats.items()})
