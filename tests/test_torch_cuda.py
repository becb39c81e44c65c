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
    (2, 20, 27, 128, 48),      # C past one chunk into a narrow Co
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
    count: one per 8 x 16 tile in the wide bodies (4 blocks at 9 x 17, 128
    at 128 x 128; C > 64 into Co <= 64 takes the wide body, and so does
    Co > 64 in float32), one per 16 x 16 tile in the narrow bf16 and
    float32 bodies (C and Co <= 64: 2 and 64)."""
    for c, co, dtype, blocks in ((64, 64, torch.float32, (2, 64)),
                                 (48, 48, torch.float32, (2, 64)),
                                 (6, 10, torch.float32, (2, 64)),
                                 (192, 192, torch.float32, (4, 128)),
                                 (128, 64, torch.float32, (4, 128)),
                                 (64, 72, torch.float32, (4, 128)),
                                 (192, 192, torch.bfloat16, (4, 128)),
                                 (128, 64, torch.bfloat16, (4, 128)),
                                 (64, 64, torch.bfloat16, (2, 64)),
                                 (48, 48, torch.bfloat16, (2, 64))):
        assert (res_block.partial_blocks(9, 17, c, co, dtype),
                res_block.partial_blocks(128, 128, c, co, dtype)) == blocks
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_rtnstv_width(cuda, dtype, tol, prologue):
    """K1 at RTNSTV's residual width, C = Co = 48, at the 640x360 frame's
    quarter size: one 48-wide output tile, with statistics; in bf16 one
    partial 64-channel chunk of three k16 steps, in f32 a full and a
    ragged 32-channel chunk.  y within ``tol`` of its scale, the stats
    within 1e-4 of theirs, and a second launch gives the same bits."""
    x, w, b, pro = _k1_inputs(cuda, 2, 90, 160, 48, 48, dtype)
    kw = dict(zip(("stats_in", "gamma", "beta"), pro)) if prologue else {}
    y, s = res_block.conv3x3_in_stats(x, w, b, **kw)
    yp, sp = res_block.conv3x3_in_stats_plain(x, w, b, **kw)
    _close(y, yp, tol)
    _close(s, sp, 1e-4)
    y2, s2 = res_block.conv3x3_in_stats(x, w, b, **kw)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("n,h,wd", [
    (8, 90, 160),    # RTNSTV's 640x360 batch 8: 6 tile rows, the last of 10
    (1, 17, 37),     # one row past a 16-row tile, a ragged width
    (1, 2, 160),     # the least height
    (8, 2, 37),
])
@pytest.mark.parametrize("c", [48, 64])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("halo", [False, True])
def test_k1_narrow_bf16(cuda, n, h, wd, c, prologue, halo):
    """The narrow bf16 K1 (C = Co = 48, RTNSTV's, and 64, SD1/SD2's; one
    launch of 16 x 16-pixel tiles that finishes the statistics itself) in
    the reflect mode and the halo-rows mode (on the whole reflect-padded
    tensor): y within one bf16 ulp of its scale and the statistics (the
    sums in halo mode) within 1e-4 of theirs against the plain version,
    and a second launch gives the same bits."""
    x, w, b, pro = _k1_inputs(cuda, n, h, wd, c, c)
    kw = dict(zip(("stats_in", "gamma", "beta"), pro)) if prologue else {}
    if halo:
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                    mode="reflect").permute(0, 2, 3, 1)
        x = x.contiguous()
        fn, plain = (res_block.conv3x3_in_stats_halo,
                     res_block.conv3x3_in_stats_halo_plain)
    else:
        fn, plain = (res_block.conv3x3_in_stats,
                     res_block.conv3x3_in_stats_plain)
    y, s = fn(x, w, b, **kw)
    yp, sp = plain(x, w, b, **kw)
    _close(y, yp, 2.0 ** -7)
    _close(s, sp, 1e-4)
    y2, s2 = fn(x, w, b, **kw)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("n,h,wd", [
    (8, 90, 160),    # RTNSTV's 640x360 batch 8: 6 tile rows, the last of 10
    (1, 17, 37),     # one row past a 16-row tile, a ragged width
    (1, 2, 160),     # the least height
    (8, 2, 37),
])
@pytest.mark.parametrize("c", [48, 64])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("halo", [False, True])
def test_k1_narrow_f32(cuda, n, h, wd, c, prologue, halo):
    """The narrow float32 K1 (C = Co = 48, RTNSTV's, and 64, SD1/SD2's;
    3xTF32 on 16 x 16-pixel tiles that derive the prologue's parameters
    themselves) in the reflect mode and the halo-rows mode (on the whole
    reflect-padded tensor): y and the statistics (the sums in halo mode)
    within 1e-4 of their scale against the plain version, and a second
    launch gives the same bits."""
    x, w, b, pro = _k1_inputs(cuda, n, h, wd, c, c, torch.float32)
    kw = dict(zip(("stats_in", "gamma", "beta"), pro)) if prologue else {}
    if halo:
        x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                    mode="reflect").permute(0, 2, 3, 1)
        x = x.contiguous()
        fn, plain = (res_block.conv3x3_in_stats_halo,
                     res_block.conv3x3_in_stats_halo_plain)
    else:
        fn, plain = (res_block.conv3x3_in_stats,
                     res_block.conv3x3_in_stats_plain)
    y, s = fn(x, w, b, **kw)
    yp, sp = plain(x, w, b, **kw)
    _close(y, yp, 1e-4)
    _close(s, sp, 1e-4)
    y2, s2 = fn(x, w, b, **kw)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("prologue", [False, True])
def test_k1_narrow_halo_stitch_equals_reflect(cuda, prologue):
    """RTNSTV's (4, 90, 160, 48) cut into the flow step's uneven row blocks
    (24, 22, 22, 22) that carry their neighbours' rows: the stitched y of
    the halo-rows mode is one reflect-mode launch's bit for bit, and the
    summed statistics give its (mean, var) within 1e-4."""
    x, w, b, pro = _k1_inputs(cuda, 4, 90, 160, 48, 48)
    kw = dict(zip(("stats_in", "gamma", "beta"), pro)) if prologue else {}
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                 mode="reflect").permute(0, 2, 3, 1)
    ys, sums, start = [], 0, 0
    for r in (24, 22, 22, 22):
        y, sm = res_block.conv3x3_in_stats_halo(
            xp[:, start:start + r + 2].contiguous(), w, b, **kw)
        ys.append(y)
        sums, start = sums + sm, start + r
    yr, sr = res_block.conv3x3_in_stats(x, w, b, **kw)
    assert torch.equal(torch.cat(ys, 1), yr)
    mean = sums[:, 0] / (90 * 160)
    _close(torch.stack([mean, sums[:, 1] / (90 * 160) - mean * mean], 1), sr,
           1e-4)


@pytest.mark.parametrize("c", [48, 64])
@pytest.mark.parametrize("prologue", [False, True])
def test_k1_narrow_f32_halo_stitch_equals_reflect(cuda, c, prologue):
    """The narrow float32 K1 over (2, 90, 160, C) cut into uneven row
    blocks (24, 22, 22, 22) that carry their neighbours' rows: the
    stitched y of the halo-rows mode is one reflect-mode launch's bit for
    bit, and the summed statistics give its (mean, var) within 1e-4."""
    x, w, b, pro = _k1_inputs(cuda, 2, 90, 160, c, c, torch.float32)
    kw = dict(zip(("stats_in", "gamma", "beta"), pro)) if prologue else {}
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                 mode="reflect").permute(0, 2, 3, 1)
    ys, sums, start = [], 0, 0
    for r in (24, 22, 22, 22):
        y, sm = res_block.conv3x3_in_stats_halo(
            xp[:, start:start + r + 2].contiguous(), w, b, **kw)
        ys.append(y)
        sums, start = sums + sm, start + r
    yr, sr = res_block.conv3x3_in_stats(x, w, b, **kw)
    assert torch.equal(torch.cat(ys, 1), yr)
    mean = sums[:, 0] / (90 * 160)
    _close(torch.stack([mean, sums[:, 1] / (90 * 160) - mean * mean], 1), sr,
           1e-4)


def _halo_shards(x, parts):
    """x reflect-padded by one pixel a side, cut into ``parts`` row shards
    of R + 2 rows, each holding its neighbours' rows (the exchange's
    output; reflected rows at the frame's edges)."""
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                                 mode="reflect").permute(0, 2, 3, 1)
    r = x.shape[1] // parts
    return [xp[:, i * r:i * r + r + 2].contiguous() for i in range(parts)]


@pytest.mark.parametrize("c,co", [(192, 192), (64, 64), (48, 48), (40, 80)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("parts", [1, 4])
def test_k1_halo_rows_mode(cuda, c, co, dtype, tol, prologue, parts):
    """K1's halo-rows mode over a split into row shards that carry their
    neighbours' rows: the stitched y within ``tol`` of the halo mode's
    plain version and of one reflect-mode launch on the whole tensor,
    the summed statistics within 1e-4 of theirs (after the division), and
    a second launch of each shard gives the same bits."""
    x, w, b, pro = _k1_inputs(cuda, 2, 36, 50, c, co, dtype)
    kw = dict(zip(("stats_in", "gamma", "beta"), pro)) if prologue else {}
    before = res_block.conv3x3_in_stats_halo.launches
    ys, sums, ps, psums = [], 0, [], 0
    for xh in _halo_shards(x, parts):
        y, s = res_block.conv3x3_in_stats_halo(xh, w, b, **kw)
        assert torch.equal(y, res_block.conv3x3_in_stats_halo(xh, w, b, **kw)[0])
        yp, sp = res_block.conv3x3_in_stats_halo_plain(xh, w, b, **kw)
        ys.append(y)
        ps.append(yp)
        sums, psums = sums + s, psums + sp
    assert res_block.conv3x3_in_stats_halo.launches == before + 2 * parts
    y, yp = torch.cat(ys, 1), torch.cat(ps, 1)
    yr, sr = res_block.conv3x3_in_stats(x, w, b, **kw)
    _close(y, yp, tol)
    _close(y, yr, tol)
    _close(sums, psums, 1e-4)
    hw = 36 * 50
    mean = sums[:, 0] / hw
    _close(torch.stack([mean, sums[:, 1] / hw - mean * mean], 1), sr, 1e-4)


def test_sharded_reconet_launches_the_halo_mode(cuda):
    """A world-1 sharded f32 ReCoNet forward on the card (an NCCL group of
    one) launches K1 only in its halo-rows mode, ten times, K2 twice, and
    matches the unsharded forward."""
    import socket

    from vst_tpu_torch.infer.image import (stylize_reconet,
                                           stylize_spatial_sharded)
    from vst_tpu_torch.models.reconet import init_reconet
    from vst_tpu_torch.parallel import make_mesh, multihost

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    x = torch.rand(1, 64, 48, 3, generator=torch.Generator().manual_seed(0)) * 255
    model = init_reconet(0, device=cuda)
    ref = stylize_reconet(model, x)
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(None, ("space",))
        before = (res_block.conv3x3_in_stats.launches,
                  res_block.conv3x3_in_stats_halo.launches,
                  head_conv.conv3x3_valid.launches)
        got = stylize_spatial_sharded(model, x, mesh)
        after = (res_block.conv3x3_in_stats.launches,
                 res_block.conv3x3_in_stats_halo.launches,
                 head_conv.conv3x3_valid.launches)
    finally:
        multihost.shutdown()
    assert tuple(a - b for a, b in zip(after, before)) == (0, 10, 2)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=2e-3)


def test_rtnstv_routes_through_k1(cuda, monkeypatch):
    """An f32 RTNSTV forward launches K1 ten times and matches the same
    forward through K1's plain version on the card and the CPU forward
    (2e-3, the model tolerance)."""
    from vst_tpu_torch.models.rtnstv import init_stylizing_network

    x = torch.rand(2, 48, 64, 3, generator=torch.Generator().manual_seed(0))
    x = x * 255
    ref = init_stylizing_network(0, device="cpu")(x).detach()
    model = init_stylizing_network(0, device=cuda)
    before = res_block.conv3x3_in_stats.launches
    with torch.inference_mode():
        ours = model(x.to(cuda))
        assert res_block.conv3x3_in_stats.launches == before + 10
        monkeypatch.setattr(res_block, "conv3x3_in_stats",
                            res_block.conv3x3_in_stats_plain)
        plain = model(x.to(cuda))
    torch.testing.assert_close(ours, plain, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(ours.cpu(), ref, rtol=2e-3, atol=2e-3)


def test_k1_k2_carry_a_gradient(cuda):
    """A small f32 ReCoNet forward and backward on the card launches K1 ten
    times and K2 twice (the backward launches neither) and gives every
    parameter the CPU route's gradient, within 2e-3 of the key's largest
    (3xTF32 forward against the CPU's float32; the biases before an
    instance norm, whose true gradient is 0, against the model's largest
    gradient)."""
    from vst_tpu_torch.models.reconet import init_reconet

    x = torch.rand(2, 36, 44, 3, generator=torch.Generator().manual_seed(0)) * 255
    cpu = init_reconet(0, device="cpu")
    sum(o.square().mean() for o in cpu(x)).backward()
    model = init_reconet(0, device=cuda)
    before = (res_block.conv3x3_in_stats.launches,
              head_conv.conv3x3_valid.launches)
    out = model(x.to(cuda))
    assert (res_block.conv3x3_in_stats.launches - before[0],
            head_conv.conv3x3_valid.launches - before[1]) == (10, 2)
    sum(o.square().mean() for o in out).backward()
    assert (res_block.conv3x3_in_stats.launches - before[0],
            head_conv.conv3x3_valid.launches - before[1]) == (10, 2)
    ref = dict(cpu.named_parameters())
    top = max(p.grad.abs().max() for p in ref.values())
    for k, p in model.named_parameters():
        g = ref[k].grad
        scale = top if k.endswith("conv2d.bias") else g.abs().max()
        assert (p.grad.cpu() - g).abs().max() <= 2e-3 * scale, k


def _grad_case(cuda, shape, dtype, prologue, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    n, h, wd, c, co = shape
    args = [torch.randn(n, h, wd, c, device=cuda, generator=g) * 2,
            torch.randn(3, 3, c, co, device=cuda, generator=g) / (3 * c ** 0.5),
            torch.randn(co, device=cuda, generator=g) * 0.1]
    if prologue:
        args += [torch.stack([torch.randn(n, c, device=cuda, generator=g),
                              torch.rand(n, c, device=cuda, generator=g) + 0.5],
                             1),
                 torch.rand(c, device=cuda, generator=g) + 0.5,
                 torch.randn(c, device=cuda, generator=g) * 0.1]
    cot = (torch.randn(n, h, wd, co, device=cuda, generator=g),
           torch.randn(n, 2, co, device=cuda, generator=g))
    cast = [a.to(dtype) if i < 3 else a for i, a in enumerate(args)]
    return cast, [a.double() for a in cast], cot


def _grads(fn, args, cot):
    leaves = [a.detach().requires_grad_() for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, tuple(c.to(o.dtype)
                                        for c, o in zip(cot, outs)))
    return [leaf.grad.double() for leaf in leaves]


@pytest.mark.parametrize("shape", [(2, 9, 13, 24, 40), (3, 17, 6, 64, 64),
                                   (1, 2, 2, 8, 16)])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_k1_function_grad_ragged(cuda, shape, prologue, dtype, tol):
    """K1's Function on the card (kernel forward, library backward) against
    its plain route in float64 on the same (rounded) inputs, at ragged
    shapes: each input's gradient within ``tol`` of its largest (bf16: the
    rounded forward, saved y and input gradient, 2⁻⁹ relative each)."""
    args, args64, cot = _grad_case(cuda, shape, dtype, prologue)
    ours = _grads(res_block.conv3x3_in_stats, args, cot)
    ref = _grads(lambda *a: res_block.Conv3x3InStats.apply(
        *a, *([None] * (6 - len(a))), res_block.conv3x3_in_stats_plain),
        args64, cot)
    for i, (a, r) in enumerate(zip(ours, ref)):
        assert (a - r).abs().max() <= tol * r.abs().max(), i


@pytest.mark.parametrize("n,hp,wp,c,co", [(2, 11, 14, 48, 768),
                                          (1, 7, 9, 768, 48),
                                          (2, 5, 19, 24, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_k2_function_grad_ragged(cuda, n, hp, wp, c, co, dtype, tol):
    """K2's Function on the card against its plain route in float64."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n, hp, wp, c, device=cuda, generator=g)
    w = torch.randn(3, 3, c, co, device=cuda, generator=g) / (3 * c ** 0.5)
    cot = torch.randn(n, hp - 2, wp - 2, co, device=cuda, generator=g)
    x, w = x.to(dtype), w.to(dtype)
    ours = _grads(head_conv.conv3x3_valid, [x, w], (cot,))
    ref = _grads(lambda a, b: head_conv.Conv3x3Valid.apply(
        a, b, head_conv.conv3x3_valid_plain), [x.double(), w.double()],
        (cot,))
    for i, (a, r) in enumerate(zip(ours, ref)):
        assert (a - r).abs().max() <= tol * r.abs().max(), i


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


def test_device_prefetch_bitwise_under_a_concurrent_kernel(cuda):
    """Batches prefetched on the side stream reach the consumer bit for bit
    while the consumer's stream is busy: each batch is read only behind a
    long matmul and released at once, so a missing wait on the copy, or a
    missing record_stream letting the next copy reuse its memory, shows as
    a wrong sum."""
    import numpy as np

    from vst_tpu_torch.data.pipeline import device_prefetch

    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 256, (4, 128, 128, 3)).astype(np.float32),
             rng.integers(0, 256, (4, 64)).astype(np.float32))
            for _ in range(12)]
    a = torch.randn(4096, 4096, device=cuda)
    sums = []
    for batch in device_prefetch(iter(host), size=2, device=cuda):
        busy = a @ a @ a                      # the consumer's stream is busy
        sums.append([(busy[0, 0] * 0 + t.double().sum()) for t in batch])
        del batch
    torch.cuda.synchronize()
    for got, (x, y) in zip(sums, host, strict=True):
        assert [float(s) for s in got] == [float(x.astype(np.float64).sum()),
                                           float(y.astype(np.float64).sum())]
    copies = list(device_prefetch(iter(host[:3]), size=2, device=cuda))
    for (x, y), (dx, dy) in zip(host, copies):
        assert dx.device.type == "cuda"
        assert np.array_equal(dx.cpu().numpy(), x)
        assert np.array_equal(dy.cpu().numpy(), y)


def test_run_training_two_steps_on_the_card(cuda, tmp_path):
    """Two f32 image steps at 64² (batch 1) through the loop: K3 6, K4 3 and
    K5 3 launches a step, no K1/K2, finite logged metrics, and a
    ``_last_state`` that reloads to the live state bit for bit."""
    import numpy as np

    from vst_tpu_torch.models.adaattn import init_stylizing_network
    from vst_tpu_torch.models.vgg import init_vgg19_adaattn
    from vst_tpu_torch.train.checkpoint import load_state
    from vst_tpu_torch.train.config import AdaAttNImageConfig
    from vst_tpu_torch.train.loop import run_training
    from vst_tpu_torch.train.state import create
    from vst_tpu_torch.train.steps import make_adaattn_image_step

    class Pairs:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            rng = np.random.default_rng(i)
            return tuple(rng.integers(0, 256, (64, 64, 3)).astype(np.float32)
                         for _ in range(2))

    cfg = AdaAttNImageConfig(batch_size=1)
    state = create(init_stylizing_network(1, device=cuda), cfg.lr)
    step = make_adaattn_image_step(cfg, init_vgg19_adaattn(0, device=cuda))
    wrappers = (res_block.conv3x3_in_stats, head_conv.conv3x3_valid,
                adaattn_attention.softmax_attention_moments,
                adaattn_attention.softmax_attention_dq,
                adaattn_attention.softmax_attention_dkv)
    before = [w.launches for w in wrappers]
    logs = []
    state = run_training(step, state, Pairs(), batch_size=1, epochs=1,
                         out_dir=str(tmp_path), model_name="ada",
                         log_every=1, num_workers=0, log_fn=logs.append)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [
        0, 0, 12, 6, 6]
    assert len(logs) == 2 and "nan" not in " ".join(logs)
    assert state.step == 2
    again = load_state(str(tmp_path / "ada_last_state"), like=create(
        init_stylizing_network(2, device=cuda), cfg.lr))
    assert again.step == 2
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), again.optimizer.state_dict()
    for i, st in sa["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], sb["state"][i][key]), (i, key)


@pytest.mark.parametrize("metric", ["raft", "ssim", "lpips_vgg"])
def test_eval_on_the_card_against_the_cpu(cuda, metric):
    """Evaluation on the card against the same code on the CPU, in
    float32 with TF32 off: RAFT at 1×128×160 (3 iterations, rtol 1e-3,
    atol 2e-4, the RAFT parity tolerance), SSIM and LPIPS-vgg of a 64²
    pair (1e-4 relative)."""
    import numpy as np

    from vst_tpu_torch.compat import params_from_jax

    rng = np.random.default_rng(0)
    if metric == "raft":
        from vst_tpu_torch.models.raft import init_raft, raft_flow

        a, b = (rng.random((2, 1, 128, 160, 3)) * 2 - 1).astype(np.float32)
        ours = raft_flow(init_raft(0, device=cuda), a, b, iters=3).cpu()
        ref = raft_flow(init_raft(0, device="cpu"), a, b, iters=3)
        torch.testing.assert_close(ours, ref, rtol=1e-3, atol=2e-4)
        return
    a, b = (rng.random((2, 1, 64, 64, 3)) * 255).astype(np.float32)
    if metric == "ssim":
        from vst_tpu_torch.eval import ssim

        ours = ssim(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
        ref = ssim(torch.from_numpy(a), torch.from_numpy(b))
    else:
        from vst_tpu_torch.eval.lpips import (image_to_lpips_input, lpips_vgg,
                                              random_lpips_params)

        params = params_from_jax(random_lpips_params(0))
        x, y = image_to_lpips_input(a[0]), image_to_lpips_input(b[0])
        ours = lpips_vgg({k: v.to(cuda) for k, v in params.items()}, x, y)
        ref = lpips_vgg(params, x, y)
    _close(ours.cpu(), ref, 1e-4)


def _sync_sites(fn):
    """The (file, line) of every call inside ``fn`` that synchronizes the
    stream, paths relative to the repository, from
    ``torch.cuda.set_sync_debug_mode("warn")``: a sync warns from the
    Python line that called the op (one in a backward from the line that
    called ``backward``).  Warn, not error, so that one sync does not hide
    the ones after it.  (The mode's own warning that it is a prototype is
    not a sync.)"""
    import os
    import warnings

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sorted({(os.path.relpath(w.filename, root), w.lineno)
                   for w in seen
                   if "called a synchronizing CUDA operation" in str(w.message)})


def _reconet_serve(cuda):
    """The stream's batch call: bf16 ReCoNet on 8 uint8 640×360 frames
    already on the card, styled to uint8."""
    from vst_tpu_torch.infer.image import stylize_reconet
    from vst_tpu_torch.models.reconet import init_reconet

    model = init_reconet(0, device=cuda, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(0, 256, (8, 360, 640, 3), generator=g, device=cuda,
                      dtype=torch.uint8)
    return lambda: stylize_reconet(model, x, uint8_out=True)


def _rtnstv_serve(cuda):
    """The stream's batch call for RTNSTV: bf16, 8 uint8 640×360 frames
    already on the card, styled to uint8 (the narrow K1, the transposed
    convs)."""
    from vst_tpu_torch.infer.image import stylize_rtnstv
    from vst_tpu_torch.models.rtnstv import init_stylizing_network

    model = init_stylizing_network(0, device=cuda, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(0, 256, (8, 360, 640, 3), generator=g, device=cuda,
                      dtype=torch.uint8)
    return lambda: stylize_rtnstv(model, x, uint8_out=True)


def _reconet_flow_step(cuda):
    """One f32 ReCoNet flow step (forward, backward, Adam) on a batch of
    2 frame pairs already on the card."""
    from vst_tpu_torch.models.reconet import init_reconet
    from vst_tpu_torch.models.vgg import init_vgg16_reconet
    from vst_tpu_torch.train import config, state, steps

    cfg = config.ReCoNetFlowConfig(img_size=(96, 160))
    vgg = init_vgg16_reconet(0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    style = torch.rand(1, 96, 160, 3, generator=g, device=cuda) * 255
    step = steps.make_reconet_flow_step(
        cfg, vgg, steps.reconet_style_grams(vgg, style))
    held = [state.create(init_reconet(1, device=cuda), cfg.lr)]
    batch = (torch.rand(2, 96, 160, 3, generator=g, device=cuda) * 255,
             torch.rand(2, 96, 160, 3, generator=g, device=cuda) * 255,
             torch.randn(2, 96, 160, 2, generator=g, device=cuda) * 2,
             (torch.rand(2, 96, 160, generator=g, device=cuda) > 0.2).float())

    def run():
        held[0], _ = step(held[0], batch)
    return run


def _adaattn_serve(cuda):
    """bf16 AdaAttN on 8 content/style pairs of 512² on the card."""
    from vst_tpu_torch.infer.image import stylize_adaattn
    from vst_tpu_torch.models.adaattn import init_stylizing_network
    from vst_tpu_torch.models.vgg import init_vgg19_adaattn

    vgg = init_vgg19_adaattn(0, device=cuda, dtype=torch.bfloat16)
    net = init_stylizing_network(1, device=cuda, dtype=torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    c, s = (torch.rand(8, 512, 512, 3, generator=g, device=cuda) * 255
            for _ in range(2))
    return lambda: stylize_adaattn(vgg, net, c, s)


@pytest.mark.parametrize("make,where", [
    (_reconet_serve, ""), (_reconet_flow_step, "vst_tpu_torch/ops/"),
    (_adaattn_serve, ""), (_rtnstv_serve, "")],
    ids=["reconet_serve_bf16", "reconet_flow_step_f32", "adaattn_serve_bf16",
         "rtnstv_serve_bf16"])
def test_ops_do_not_synchronize_the_stream(cuda, make, where):
    """Warmed, the served ReCoNet, AdaAttN and RTNSTV forwards wait for
    the card nowhere, and a ReCoNet flow step nowhere in
    ``vst_tpu_torch/ops/``: the ops' constants stay on the device
    (``ops/constants.py``).  The
    step's syncs outside the ops (the train step layer's) are printed,
    not failed."""
    fn = make(cuda)
    fn()
    fn()
    sites = _sync_sites(fn)
    print(f"{make.__name__}: synchronizing calls {sites}")
    assert not [s for s in sites if s[0].startswith(where)]


@pytest.mark.parametrize("input_frame_num", [1, 2])
def test_stream_hands_out_whole_frames_through_reused_pinned_buffers(
        cuda, input_frame_num):
    """``StreamingStylizer`` on the card: each batch's windows stacked into
    a pinned buffer that a later batch reuses, results copied back into
    another; every frame handed out stays its own after the stream has
    reused both (10 frames, batch 4, depth 2, the tail padded)."""
    import numpy as np

    from vst_tpu_torch.infer.video import StreamingStylizer

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
              for _ in range(10)]

    def model_fn(batch):
        assert batch.is_pinned() and batch.shape[-1] == 3 * input_frame_num
        return batch.to(cuda, non_blocking=True)[..., -3:] ^ 255

    out = list(StreamingStylizer(model_fn, frames,
                                 input_frame_num=input_frame_num,
                                 batch_size=4, pipeline_depth=2,
                                 device=cuda))
    assert len(out) == 10 - (input_frame_num - 1)
    for got, want in zip(out, frames[input_frame_num - 1:]):
        assert got.dtype == np.uint8 and np.array_equal(got, want ^ 255)
