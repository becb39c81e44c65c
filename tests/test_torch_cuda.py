"""The port's CUDA kernels and model on the card, against their plain
PyTorch versions.  Every test here needs a CUDA device and skips without
one.  The file imports neither JAX nor vst_tpu, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from vst_tpu_torch.kernels import head_conv, res_block

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
