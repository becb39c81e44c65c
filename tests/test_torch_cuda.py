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


def _k1_inputs(cuda, n, h, wd, c, co, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(n, h, wd, c, device=cuda, generator=g) * 3).to(dtype)
    w = (torch.randn(3, 3, c, co, device=cuda, generator=g) * 0.05).to(dtype)
    b = (torch.randn(co, device=cuda, generator=g) * 0.05).to(dtype)
    stats = torch.stack([torch.randn(n, c, device=cuda, generator=g),
                         torch.rand(n, c, device=cuda, generator=g) * 9 + 1], 1)
    gm = torch.rand(c, device=cuda, generator=g) + 0.5
    bt = torch.randn(c, device=cuda, generator=g)
    return x, w, b, (stats, gm, bt)


@pytest.mark.parametrize("n,h,wd,c,co", [
    (2, 128, 128, 192, 192),   # ReCoNet's residual stack (one 192-wide tile)
    (2, 128, 128, 64, 64),     # SD1/SD2's residual stack
    (1, 90, 160, 192, 192),    # the 640x360 stream
    (1, 2, 37, 64, 64),        # the least height, a ragged width
    (2, 9, 5, 192, 192),       # a width below one tile
])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_bf16_shapes(cuda, n, h, wd, c, co, prologue):
    """The wgmma K1 at the model's widths, the stream's ragged size and
    tiles that overhang the image: y to one bf16 ulp of its scale, the
    float32 stats to 1e-3."""
    x, w, b, pro = _k1_inputs(cuda, n, h, wd, c, co)
    kw = dict(zip(("stats_in", "gamma", "beta"), pro)) if prologue else {}
    y, s = res_block.conv3x3_in_stats(x, w, b, **kw)
    yp, sp = res_block.conv3x3_in_stats_plain(x, w, b, **kw)
    _close(y, yp, 2.0 ** -7)
    torch.testing.assert_close(s, sp, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("c,co", [(48, 768), (48, 512), (48, 256),
                                  (768, 48), (512, 48), (256, 48)])
def test_k2_bf16_packed_stream_shapes(cuda, c, co):
    """The packed stems and heads of ReCoNet, SD1 and SD2 at the 640x360
    stream's packed size (1, 92, 162, C)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1, 92, 162, c, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, c, co, device=cuda, generator=g) * 0.05).bfloat16()
    _close(head_conv.conv3x3_valid(x, w), head_conv.conv3x3_valid_plain(x, w),
           2.0 ** -7)


@pytest.mark.parametrize("hp,wp", [(3, 40), (20, 7)])
def test_k2_bf16_one_row_and_narrow(cuda, hp, wp):
    """One output row, and an output width below one tile."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, hp, wp, 48, device=cuda, generator=g).bfloat16()
    w = (torch.randn(3, 3, 48, 256, device=cuda, generator=g) * 0.05).bfloat16()
    _close(head_conv.conv3x3_valid(x, w), head_conv.conv3x3_valid_plain(x, w),
           2.0 ** -7)


def test_k1_k2_bf16_deterministic(cuda):
    """Two launches on the same inputs give the same bits: y and stats of
    K1 with and without the prologue, and K2."""
    x, w, b, (st, gm, bt) = _k1_inputs(cuda, 2, 40, 56, 192, 192)
    for kw in ({}, dict(stats_in=st, gamma=gm, beta=bt)):
        (y1, s1), (y2, s2) = (res_block.conv3x3_in_stats(x, w, b, **kw)
                              for _ in range(2))
        assert torch.equal(y1, y2) and torch.equal(s1, s2)
    xk = x[:, :, :, :48].contiguous()
    wk = w[:, :, :48, :].contiguous()
    assert torch.equal(head_conv.conv3x3_valid(xk, wk),
                       head_conv.conv3x3_valid(xk, wk))


def test_k1_partial_blocks_follow_the_library(cuda):
    """The scratch for K1's partial sums is sized by the library's own
    count, one per 8 x 16 tile in both dtypes: 4 blocks at 9 x 17, 128 at
    128 x 128."""
    assert res_block.partial_blocks(9, 17) == 4
    assert res_block.partial_blocks(128, 128) == 128
    for dtype, tol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-4)):
        x, w, b, _ = _k1_inputs(cuda, 3, 9, 17, 64, 64, dtype)
        y, s = res_block.conv3x3_in_stats(x, w, b)
        yp, sp = res_block.conv3x3_in_stats_plain(x, w, b)
        _close(y, yp, tol)
        torch.testing.assert_close(s, sp, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n,h,wd,c,co", [
    (2, 128, 128, 192, 192),   # ReCoNet's residual stack (one 192-wide tile)
    (2, 128, 128, 64, 64),     # SD1/SD2's residual stack
    (1, 90, 160, 192, 192),    # the 640x360 stream
    (1, 2, 37, 64, 64),        # the least height, a ragged width
    (2, 9, 5, 192, 192),       # a width below one tile
    (2, 11, 19, 6, 10),        # C and Co not multiples of 4
])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_f32_shapes(cuda, n, h, wd, c, co, prologue):
    """The 3xTF32 K1 at the bf16 shapes and at channel counts the bf16
    body refuses: y and the stats within 1e-4 of their scale; a second
    launch gives the same bits."""
    x, w, b, pro = _k1_inputs(cuda, n, h, wd, c, co, torch.float32)
    kw = dict(zip(("stats_in", "gamma", "beta"), pro)) if prologue else {}
    y, s = res_block.conv3x3_in_stats(x, w, b, **kw)
    yp, sp = res_block.conv3x3_in_stats_plain(x, w, b, **kw)
    _close(y, yp, 1e-4)
    _close(s, sp, 1e-4)
    y2, s2 = res_block.conv3x3_in_stats(x, w, b, **kw)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("n,hp,wp,c,co", [
    (1, 130, 130, 48, 768), (1, 130, 130, 768, 48),   # ReCoNet stem, head
    (1, 130, 130, 48, 512), (1, 130, 130, 512, 48),   # SD1
    (1, 130, 130, 48, 256), (1, 130, 130, 256, 48),   # SD2
    (1, 92, 162, 48, 768), (1, 92, 162, 768, 48),     # the 640x360 stream
    (2, 3, 40, 48, 256), (2, 20, 7, 48, 256),         # one row; narrow
    (2, 12, 21, 6, 10),                               # C, Co not multiples of 4
])
def test_k2_f32_packed_shapes(cuda, n, hp, wp, c, co):
    """The 3xTF32 K2 at the packed stems and heads: within 1e-4 of the
    output's scale, and a second launch gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(n, hp, wp, c, device=cuda, generator=g)
    w = torch.randn(3, 3, c, co, device=cuda, generator=g) * 0.05
    y = head_conv.conv3x3_valid(x, w)
    _close(y, head_conv.conv3x3_valid_plain(x, w), 1e-4)
    assert torch.equal(y, head_conv.conv3x3_valid(x, w))


def test_f32_misaligned_input(cuda):
    """A float32 input that does not start on 16 bytes takes the kernels'
    scalar staging: the same values as the aligned copy."""
    g = torch.Generator(device=cuda).manual_seed(2)
    base = torch.randn(1 * 10 * 12 * 8 + 1, device=cuda, generator=g)
    x = base[1:].view(1, 10, 12, 8)
    w = torch.randn(3, 3, 8, 16, device=cuda, generator=g) * 0.05
    b = torch.randn(16, device=cuda, generator=g) * 0.05
    assert x.data_ptr() % 16
    assert torch.equal(head_conv.conv3x3_valid(x, w),
                       head_conv.conv3x3_valid(x.clone(), w))
    y, s = res_block.conv3x3_in_stats(x, w, b)
    ya, sa = res_block.conv3x3_in_stats(x.clone(), w, b)
    assert torch.equal(y, ya) and torch.equal(s, sa)


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
    off = torch.zeros(6 * 6 * 8 + 1, device=cuda, dtype=torch.bfloat16)
    w8 = torch.zeros(3, 3, 8, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        head_conv.conv3x3_valid(off[1:].view(1, 6, 6, 8), w8)


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


def test_k1_k2_refuse_a_gradient(cuda):
    """K1 and K2 have no backward yet: a ReCoNet forward on the card with
    grad mode on raises instead of returning outputs whose kernel-side
    parameters get no gradient.  The same forward under inference_mode
    still launches K1 ten times and K2 twice, and the CPU forward (plain
    versions) still gives every parameter a gradient."""
    from vst_tpu_torch.models.reconet import init_reconet

    x = torch.rand(1, 36, 44, 3, generator=torch.Generator().manual_seed(0)) * 255
    model = init_reconet(0, device=cuda)
    with pytest.raises(RuntimeError, match="has no backward"):
        model(x.to(cuda))
    before = (res_block.conv3x3_in_stats.launches,
              head_conv.conv3x3_valid.launches)
    with torch.inference_mode():
        model(x.to(cuda))
    assert (res_block.conv3x3_in_stats.launches - before[0],
            head_conv.conv3x3_valid.launches - before[1]) == (10, 2)
    cpu = init_reconet(0, device="cpu")
    sum(o.float().square().mean() for o in cpu(x)).backward()
    missing = [k for k, p in cpu.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
    assert not missing, missing


K3_SHAPES = [(256, 256, 64, 32),     # tile multiples
             (300, 520, 96, 64),     # ragged n and m
             (128, 700, 48, 24),     # ragged m, d and c under one tile
             (200, 330, 448, 256),   # relu3_1's d and c, one value slice
             (130, 200, 1480, 512),  # relu5_1's c, two slices; d past 1472, ragged
             (200, 330, 520, 264)]   # a second value slice of 8 columns


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


def _k3_reference(q, k, v):
    """What K3 is held against: the plain version on the same inputs in
    bf16, the same formulas evaluated in float64 in f32 (the 3xTF32 body;
    with scores of std 100 true float32 is itself off the exact value by
    a good part of the tolerance)."""
    if q.dtype == torch.bfloat16:
        return adaattn_attention.softmax_attention_moments_plain(q, k, v)
    return adaattn_attention.softmax_attention_moments_plain(
        q.double(), k.double(), v.double())


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
    p1, p2, pl = _k3_reference(q, k, v)
    torch.cuda.synchronize()
    assert adaattn_attention.softmax_attention_moments.launches == before + 1
    assert m1.dtype == dtype and lse.shape == (2, n, 1)
    _close(m1, p1, tol)
    _close(m2, p2, tol)
    _close(lse, pl, 1e-5)


@pytest.mark.parametrize("b,n,m,d,c,std,broadcast", [
    (8, 4096, 4096, 448, 256, 1.0, ""),     # the three training levels
    (8, 1024, 1024, 960, 512, 1.0, ""),
    (8, 256, 256, 1472, 512, 1.0, ""),
    (2, 16384, 16384, 448, 256, 1.0, ""),   # serving relu3_1
    (8, 4096, 4096, 448, 256, 10.0, ""),    # sharp scores at relu3_1
    (8, 4096, 4096, 448, 256, 100.0, ""),
    (2, 300, 520, 96, 64, 1.0, ""),         # ragged
    (2, 200, 330, 520, 264, 1.0, ""),       # a second value slice of 8
    (2, 130, 200, 1480, 512, 1.0, ""),      # two slices, d past relu5_1's
    (4, 200, 330, 448, 256, 1.0, "kv"),     # one K and V for the batch
    (4, 200, 330, 448, 256, 1.0, "q")])     # one Q for the batch
def test_k3_f32(cuda, b, n, m, d, c, std, broadcast):
    """The 3xTF32 K3 against the float64 evaluation of the same formulas:
    M1, M2 within 1e-4 of each output's scale, L within 1e-5·max|L|, and a
    second launch with the same bits (no atomics, every sum in a fixed
    order; the pre-pass included).  Scores of std ``std``; a stride-0 K/V
    or Q read in place."""
    g = torch.Generator(device=cuda).manual_seed(n + m + d)
    s = std ** 0.5 / d ** 0.25
    q = torch.randn(b, n, d, device=cuda, generator=g) * s
    k = torch.randn(b, m, d, device=cuda, generator=g) * s
    v = torch.randn(b, m, c, device=cuda, generator=g)
    if "kv" in broadcast:
        k, v = k[:1].expand_as(k), v[:1].expand_as(v)
    if "q" in broadcast:
        q = q[:1].expand_as(q)
    first = adaattn_attention.softmax_attention_moments(q, k, v)
    again = adaattn_attention.softmax_attention_moments(q, k, v)
    for a, r in zip(first, again):
        assert torch.equal(a, r)
    del again
    ref = _k3_reference(q, k, v)
    for ours, r, tol in zip(first, ref, (1e-4, 1e-4, 1e-5)):
        assert ours.shape == r.shape and torch.isfinite(ours).all()
        _close(ours, r, tol)


@pytest.mark.parametrize("n,m,d,c", [(4096, 4096, 448, 256),
                                     (130, 200, 1480, 512)])
@pytest.mark.parametrize("broadcast", [False, True])
def test_k3_bf16_deterministic(cuda, n, m, d, c, broadcast):
    """Two launches of bf16 K3 on the same inputs give the same bits (no
    atomics; every sum in a fixed order)."""
    q, k, v = _k3_inputs(cuda, 2, n, m, d, c, torch.bfloat16, broadcast)
    first = adaattn_attention.softmax_attention_moments(q, k, v)
    second = adaattn_attention.softmax_attention_moments(q, k, v)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_extreme_logits(cuda, dtype):
    """Scores in the thousands: the online softmax stays finite and exact.
    bf16 (base-2 running max and rescale, P rounded to bf16) holds to
    2^-6 of the output scale, as in ``test_k3``; f32 against the float64
    evaluation, as in ``test_k3``."""
    q, k, v = _k3_inputs(cuda, 1, 128, 256, 32, 16, dtype)
    q, k = q * 30, k * 30
    m1, m2, _ = adaattn_attention.softmax_attention_moments(q, k, v)
    p1, p2, _ = _k3_reference(q, k, v)
    assert torch.isfinite(m1).all() and torch.isfinite(m2).all()
    if dtype == torch.float32:
        torch.testing.assert_close(m1, p1, rtol=1e-3, atol=1e-3,
                                   check_dtype=False)
        torch.testing.assert_close(m2, p2, rtol=1e-3, atol=1e-3,
                                   check_dtype=False)
    else:
        _close(m1, p1, 2.0 ** -6)
        _close(m2, p2, 2.0 ** -6)


def test_k3_rejects_what_it_does_not_take(cuda):
    """And K4/K5 reject cotangents and row vectors of another type or
    shape."""
    q, k, v = _k3_inputs(cuda, 1, 16, 16, 32, 16, torch.float32)
    with pytest.raises(ValueError, match="one CUDA device"):
        adaattn_attention.softmax_attention_moments(q, k.cpu(), v)
    lse = torch.zeros(1, 16, 1, device=cuda)
    dm = torch.zeros(1, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="dm1 must be a contiguous"):
        adaattn_attention.softmax_attention_dq(q, k, v, lse, lse, dm.bfloat16(),
                                               dm)
    with pytest.raises(ValueError, match="lse must be a contiguous"):
        adaattn_attention.softmax_attention_dkv(q, k, v, lse[:, :8], lse, dm,
                                                dm)
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
    forward of the same weights, and a forward that needs a gradient
    trains through K4 and K5: once each per level, with the CPU's decoder
    gradients within 5e-2 of their scale and finite attention-conv
    gradients.  (The seeded model's gradients are small differences of
    large float32 terms: JAX's float32 decoder gradients lie up to 4% of
    their scale from its float64 ones.  The attention convs' are not held
    at all: the moments' variance sits at its 1e-6 clamp as a difference
    of near-equal float32 values, so they move by orders of magnitude with
    the summation order.)"""
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
    grads = []
    for vgg, net in (cpu, card):
        dev = next(net.parameters()).device
        with torch.no_grad():
            fc, fs = vgg(c.to(dev)), vgg(s.expand(2, -1, -1, -1).to(dev))
        net.zero_grad()
        net(fc, fs).square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
    before = (adaattn_attention.softmax_attention_dq.launches,
              adaattn_attention.softmax_attention_dkv.launches)
    vgg, net = card
    with torch.no_grad():
        fc = vgg(c.to(cuda))
    net(fc, {k: v.requires_grad_() for k, v in fc.items()}).sum().backward()
    torch.cuda.synchronize()
    assert (adaattn_attention.softmax_attention_dq.launches - before[0],
            adaattn_attention.softmax_attention_dkv.launches - before[1]) == (3, 3)
    for key, ref in grads[0].items():
        assert torch.isfinite(grads[1][key]).all(), key
        if key.startswith("decoder."):
            _close(grads[1][key].cpu(), ref, 5e-2)


# AdaAttN training at 256² (relu3_1, relu4_1, relu5_1): (n = m, d, c)
TRAIN_LEVELS = [(4096, 448, 256), (1024, 960, 512), (256, 1472, 512)]


def _bwd_inputs(cuda, b, n, m, d, c, dtype, scale=1.0, broadcast=""):
    """``broadcast``: "kv" for one K and V for the batch, "q" for one Q,
    each read through a batch stride of 0."""
    q, k, v = _k3_inputs(cuda, b, n, m, d, c, dtype, "kv" in broadcast)
    q, k = (q.float() * scale).to(dtype), (k.float() * scale).to(dtype)
    if "kv" in broadcast:   # the scaled K is a new tensor: broadcast it again
        k = k[:1].expand(b, -1, -1)
    if "q" in broadcast:
        q = q[:1].expand(b, -1, -1)
    m1, m2, lse = adaattn_attention.softmax_attention_moments_plain(q, k, v)
    g = torch.Generator(device=cuda).manual_seed(n * m)
    dm1 = torch.randn(b, n, c, device=cuda, generator=g).to(dtype)
    dm2 = (torch.randn(b, n, c, device=cuda, generator=g) * 0.1).to(dtype)
    return q, k, v, m1, m2, lse, dm1, dm2


@pytest.mark.parametrize("n,m,d,c,scale", [(4096, 4096, 448, 256, 1.0),
                                           (1024, 1024, 960, 512, 1.0),
                                           (256, 256, 1472, 512, 1.0),
                                           (300, 520, 96, 64, 1.0),
                                           (200, 330, 448, 256, 10.0),
                                           (300, 200, 520, 264, 1.0)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
def test_k4_k5(cuda, n, m, d, c, scale, dtype, tol):
    """dQ, dK, dV against the plain backward on the same inputs and
    cotangents: the three trainer level shapes, a ragged one, scores
    sharpened by q, k × 10, and the edges of bf16's output slices (d = 520:
    two dQ/dK slices of 512, the last of 8 columns; c = 264: two dV slices
    of 256, the last of 8; n ≠ m, both off the 64-row tile).  bf16 within
    2^-6 of each output's scale (one bf16 ulp of the output rounding plus
    dS and A rounded to bf16 from f32 values summed in another order); f32
    within 1e-4 of the scale.  The f32 K4 and K5 (3xTF32 on the tensor
    cores) are held against the plain formulas evaluated in float64 on the
    same inputs: with q, k × 10 (scores of std 100) the true-float32 plain
    version is itself 1.7e-4 (dK) and 1.5e-4 (dV) of the scale from that
    exact form, the kernel 3.6e-5 (experiments/k5_f32_variants.py on an
    NVIDIA H100), dQ 1.5e-4 against the kernel's 5.1e-5 at relu3_1's
    shape (experiments/k4_f32_variants.py)."""
    q, k, v, m1, m2, lse, dm1, dm2 = _bwd_inputs(cuda, 2, n, m, d, c, dtype,
                                                 scale)
    dd = adaattn_attention.row_term(m1, m2, dm1, dm2)
    before = (adaattn_attention.softmax_attention_dq.launches,
              adaattn_attention.softmax_attention_dkv.launches)
    dq = adaattn_attention.softmax_attention_dq(q, k, v, lse, dd, dm1, dm2)
    dk, dv = adaattn_attention.softmax_attention_dkv(q, k, v, lse, dd, dm1,
                                                     dm2)
    ref = adaattn_attention.softmax_attention_moments_bwd_plain(
        q, k, v, m1, m2, lse, dm1, dm2)
    if dtype == torch.float32:
        ref = adaattn_attention.softmax_attention_moments_bwd_plain(
            q.double(), k.double(), v.double(), m1, m2, lse, dm1.double(),
            dm2.double())
    torch.cuda.synchronize()
    assert (adaattn_attention.softmax_attention_dq.launches - before[0],
            adaattn_attention.softmax_attention_dkv.launches - before[1]) == (1, 1)
    for ours, r in zip((dq, dk, dv), ref):
        assert ours.dtype == dtype and ours.shape == r.shape
        assert torch.isfinite(ours).all()
        _close(ours, r, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("which", ["kv", "q"])
def test_k4_k5_broadcast(cuda, which, dtype, tol):
    """One K and V (``which`` "kv") or one Q ("q") for the batch, read in
    place through a batch stride of 0, at relu3_1's d = 448 and c = 256:
    the same outputs as the plain backward on the expanded tensors."""
    q, k, v, m1, m2, lse, dm1, dm2 = _bwd_inputs(cuda, 3, 200, 330, 448, 256,
                                                 dtype, broadcast=which)
    assert [t.stride(0) == 0 for t in (q, k, v)] == [
        which == "q", which == "kv", which == "kv"]
    dd = adaattn_attention.row_term(m1, m2, dm1, dm2)
    dq = adaattn_attention.softmax_attention_dq(q, k, v, lse, dd, dm1, dm2)
    dk, dv = adaattn_attention.softmax_attention_dkv(q, k, v, lse, dd, dm1,
                                                     dm2)
    ref = adaattn_attention.softmax_attention_moments_bwd_plain(
        q, k, v, m1, m2, lse, dm1, dm2)
    for ours, r in zip((dq, dk, dv), ref):
        assert ours.shape == r.shape and torch.isfinite(ours).all()
        _close(ours, r, tol)


@pytest.mark.parametrize("n,m,d,c", [(4096, 4096, 448, 256),
                                     (300, 200, 520, 264)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_deterministic(cuda, n, m, d, c, dtype):
    """Two launches of K4 and of K5 on the same inputs give the same bits
    (no atomics; every sum in a fixed order), in bf16 and in f32 (the
    3xTF32 K4 and K5 and their pre-passes included)."""
    q, k, v, m1, m2, lse, dm1, dm2 = _bwd_inputs(cuda, 2, n, m, d, c, dtype)
    args = (q, k, v, lse, adaattn_attention.row_term(m1, m2, dm1, dm2), dm1,
            dm2)
    assert torch.equal(adaattn_attention.softmax_attention_dq(*args),
                       adaattn_attention.softmax_attention_dq(*args))
    for a, b in zip(adaattn_attention.softmax_attention_dkv(*args),
                    adaattn_attention.softmax_attention_dkv(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,m,d,c", [(64, 64, 512, 256),     # one slice each
                                     (65, 129, 513, 257),    # one column past
                                     (130, 200, 1030, 515),  # third slices, off 16 bytes
                                     (20, 37, 13, 7)])       # under one box
def test_k5_f32_slice_edges(cuda, n, m, d, c):
    """The 3xTF32 K5 at the edges of its output slices (512 dK, 256 dV
    columns a block), of its 32-column boxes and of the 16-byte rows its
    pre-pass pads d, c and n to: within 1e-4 of each output's scale
    against the plain version, one launch each."""
    q, k, v, m1, m2, lse, dm1, dm2 = _bwd_inputs(cuda, 2, n, m, d, c,
                                                 torch.float32)
    dd = adaattn_attention.row_term(m1, m2, dm1, dm2)
    before = adaattn_attention.softmax_attention_dkv.launches
    dk, dv = adaattn_attention.softmax_attention_dkv(q, k, v, lse, dd, dm1,
                                                     dm2)
    pk, pv = adaattn_attention.softmax_attention_dkv_plain(q, k, v, lse, dd,
                                                           dm1, dm2)
    torch.cuda.synchronize()
    assert adaattn_attention.softmax_attention_dkv.launches == before + 1
    for ours, r in ((dk, pk), (dv, pv)):
        assert ours.shape == r.shape and torch.isfinite(ours).all()
        _close(ours, r, 1e-4)


@pytest.mark.parametrize("n,m,d,c", [(64, 64, 512, 256),     # one slice
                                     (65, 129, 513, 257),    # one column past
                                     (130, 200, 1030, 515),  # third slice, off 16 bytes
                                     (20, 37, 13, 7)])       # under one box
def test_k4_f32_slice_edges(cuda, n, m, d, c):
    """The 3xTF32 K4 at the edges of its dQ slices (512 columns a block),
    of its 64-row query and key tiles and 32-column boxes, and of the
    16-byte rows its pre-pass pads d, c and m to: within 1e-4 of dQ's
    scale against the plain formulas evaluated in float64, one launch
    each."""
    q, k, v, m1, m2, lse, dm1, dm2 = _bwd_inputs(cuda, 2, n, m, d, c,
                                                 torch.float32)
    dd = adaattn_attention.row_term(m1, m2, dm1, dm2)
    before = adaattn_attention.softmax_attention_dq.launches
    dq = adaattn_attention.softmax_attention_dq(q, k, v, lse, dd, dm1, dm2)
    ref = adaattn_attention.softmax_attention_dq_plain(
        q.double(), k.double(), v.double(), lse, dd, dm1.double(),
        dm2.double())
    torch.cuda.synchronize()
    assert adaattn_attention.softmax_attention_dq.launches == before + 1
    assert dq.shape == ref.shape and torch.isfinite(dq).all()
    _close(dq, ref, 1e-4)


@pytest.mark.parametrize("need", ["qkv", "kv", "q"])
def test_function_grad_matches_exact(cuda, need):
    """``attention_moments(..., "softmax", "train")`` on the card against
    autograd of the exact form, f32, at the tolerance of the JAX package's
    VJP test (2e-3); K4 runs only when q needs a gradient and K5 only when
    k or v does.  K and V broadcast over the batch (stride 0) get the sum
    of the per-image gradients through ``expand``."""
    from vst_tpu_torch.models.adaattn import attention_moments

    q, k, v = _k3_inputs(cuda, 3, 200, 330, 96, 64, torch.float32)
    k, v = k[:1].clone(), v[:1].clone()
    g = torch.Generator(device=cuda).manual_seed(1)
    w1, w2 = (torch.randn(3, 200, 64, device=cuda, generator=g)
              for _ in range(2))
    grads = []
    for mode in ("train", "exact"):
        leaves = [t.clone().requires_grad_(name in need)
                  for name, t in zip("qkv", (q, k, v))]
        qq, kk, vv = leaves
        before = (adaattn_attention.softmax_attention_dq.launches,
                  adaattn_attention.softmax_attention_dkv.launches)
        m1, m2 = attention_moments(qq, kk.expand(3, -1, -1),
                                   vv.expand(3, -1, -1), "softmax", mode)
        ((m1 * w1).sum() + (m2 * w2).sum()).backward()
        torch.cuda.synchronize()
        if mode == "train":
            assert (adaattn_attention.softmax_attention_dq.launches - before[0],
                    adaattn_attention.softmax_attention_dkv.launches - before[1]
                    ) == (int("q" in need), int("k" in need or "v" in need))
        grads.append([t.grad for t in leaves])
    for name, ours, ref in zip("qkv", *grads):
        if name in need:
            torch.testing.assert_close(ours, ref, rtol=2e-3, atol=2e-3)
        else:
            assert ours is None


@pytest.mark.parametrize("dtype,remat,k3_per_step", [("float32", False, 6),
                                                     ("float32", True, 9),
                                                     ("bfloat16", False, 6)])
def test_image_step_launch_counts(cuda, dtype, remat, k3_per_step):
    """One AdaAttN image step at 1×64² softmax launches K3 six times
    (three stylizer levels, three conv-free targets; remat recomputes the
    stylizer's three), K4 and K5 three times each, and moves the masters;
    in bf16 through the wgmma K4 and K5."""
    from vst_tpu_torch.models.adaattn import init_stylizing_network
    from vst_tpu_torch.models.vgg import init_vgg19_adaattn
    from vst_tpu_torch.train.config import AdaAttNImageConfig
    from vst_tpu_torch.train.state import create
    from vst_tpu_torch.train.steps import make_adaattn_image_step

    cfg = AdaAttNImageConfig(batch_size=1, remat=remat, dtype=dtype)
    state = create(init_stylizing_network(1, device=cuda), cfg.lr)
    step = make_adaattn_image_step(cfg, init_vgg19_adaattn(0, device=cuda))
    gen = torch.Generator().manual_seed(0)
    batch = [torch.rand(1, 64, 64, 3, generator=gen) * 255 for _ in range(2)]
    before = [p.detach().clone() for p in state.model.parameters()]
    wrappers = (adaattn_attention.softmax_attention_moments,
                adaattn_attention.softmax_attention_dq,
                adaattn_attention.softmax_attention_dkv)
    counts = [w.launches for w in wrappers]
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert [w.launches - c for w, c in zip(wrappers, counts)] == [
        k3_per_step, 3, 3]
    assert all(torch.isfinite(m) for m in metrics.values())
    assert any(not torch.equal(a, p) for a, p in
               zip(before, state.model.parameters()))
