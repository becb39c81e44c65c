"""K1: 3×3 reflect-pad conv with instance-norm statistics in its epilogue
and an optional normalize+relu prologue — hand-written CUDA kernel + its
plain PyTorch version.

Counterpart of ``vst_tpu/kernels/res_block.py`` (``conv3x3_in_stats``,
``residual_block_fused``).  One ReCoNet residual block is two launches
plus an elementwise tail in torch; the port's models run every residual
block this way.  The kernel source is ``csrc/res_block.cu``.

``conv3x3_in_stats`` launches the kernel for CUDA tensors (or raises) and
takes the plain version only for CPU tensors.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from vst_tpu_torch.kernels import _build
from vst_tpu_torch.ops.pad import reflection_pad2d

EPS = 1e-5   # torch InstanceNorm2d default
_TM = 64     # output pixels per block (csrc/conv3x3_tile.cuh)


@functools.cache
def _kernel():
    fn = _build.load("res_block").vst_k1_conv3x3_in_stats
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _prologue(stats_in, gamma, beta):
    """Per-image (mean, scale) and beta of relu((v − mean)·scale + beta),
    scale = γ·rsqrt(var + eps), all float32."""
    mean = stats_in[:, 0].float().contiguous()
    scale = (gamma.float() * torch.rsqrt(stats_in[:, 1].float() + EPS))
    return mean, scale.contiguous(), beta.float().contiguous()


def conv3x3_in_stats_plain(x, w, b, stats_in=None, gamma=None, beta=None):
    """Plain version, same rounding points as the kernel and the JAX one:
    the prologue output is rounded to x.dtype; the conv runs in float32;
    the stats come from the float32 result before it is rounded."""
    n, h, wd, _ = x.shape
    v = x
    if stats_in is not None:
        mean, scale, bt = _prologue(stats_in, gamma, beta)
        vf = (x.float() - mean[:, None, None, :]) * scale[:, None, None, :]
        v = torch.relu(vf + bt).to(x.dtype)
    vp = reflection_pad2d(v, 1)
    acc = F.conv2d(vp.permute(0, 3, 1, 2).float(),
                   w.permute(3, 2, 0, 1).float(), b.float())
    acc = acc.permute(0, 2, 3, 1)
    hw = float(h * wd)
    mean = acc.sum(dim=(1, 2)) / hw
    var = (acc * acc).sum(dim=(1, 2)) / hw - mean * mean
    return acc.to(x.dtype).contiguous(), torch.stack([mean, var], dim=1)


def _check(x, w, b, stats_in, gamma, beta):
    n, h, wd, c = x.shape
    if x.device.type != "cuda" or any(
            t is not None and t.device != x.device
            for t in (w, b, stats_in, gamma, beta)):
        raise ValueError("conv3x3_in_stats: every tensor must be on one "
                         f"CUDA device (x on {x.device})")
    if x.dtype not in (torch.float32, torch.bfloat16) or (
            w.dtype, b.dtype) != (x.dtype, x.dtype):
        raise TypeError(f"conv3x3_in_stats: dtypes x {x.dtype}, w {w.dtype}, "
                        f"b {b.dtype}")
    co = w.shape[3] if w.dim() == 4 else -1
    if (tuple(w.shape[:3]) != (3, 3, c) or tuple(b.shape) != (co,)
            or h < 2 or wd < 2):
        raise ValueError(f"conv3x3_in_stats: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if stats_in is not None and (
            tuple(stats_in.shape) != (n, 2, c)
            or tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,)):
        raise ValueError("conv3x3_in_stats: stats_in must be (N, 2, C) and "
                         "gamma, beta (C,)")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3x3_in_stats: x, w and b must be contiguous")
    if x.dtype == torch.bfloat16 and (c % 8 or co % 8):
        raise ValueError(f"conv3x3_in_stats: bf16 needs C and Co multiples "
                         f"of 8, got {c}, {co}")


def conv3x3_in_stats(x, w, b, stats_in=None, gamma=None, beta=None):
    """(B, H, W, C) → (conv output (B, H, W, Co) in x.dtype, per-image
    channel (mean, biased var) (B, 2, Co) float32).

    3×3 conv of the reflect-padded input with HWIO weights w (3, 3, C, Co)
    and bias b (Co,), all float32 (CUDA cores) or all bfloat16 (tensor
    cores; C and Co multiples of 8).  With ``stats_in``/``gamma``/``beta`` the input is
    first normalized with those per-image statistics and relu'd (the res
    block's middle normalize+relu, fused into the second conv)."""
    if x.device.type == "cpu":
        return conv3x3_in_stats_plain(x, w, b, stats_in, gamma, beta)
    _check(x, w, b, stats_in, gamma, beta)
    n, h, wd, c = x.shape
    co = w.shape[3]
    nblk = -(-(h * wd) // _TM)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    partial = torch.empty((n, nblk, 2, co), **f32)
    stats = torch.empty((n, 2, co), **f32)
    pro = (None, None, None)
    if stats_in is not None:
        pro = _prologue(stats_in, gamma, beta)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            *(None if t is None else t.data_ptr() for t in pro),
            y.data_ptr(), partial.data_ptr(), stats.data_ptr(),
            n, h, wd, c, co, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"K1 conv3x3_in_stats launch failed: CUDA error {rc}")
    conv3x3_in_stats.launches += 1
    return y, stats


conv3x3_in_stats.launches = 0


def residual_block_fused(x, w1, b1, g1, bt1, w2, b2, g2, bt2):
    """One ReCoNet residual block (conv→IN→relu→conv→IN, + x) as two K1
    launches and a float32 elementwise tail (normalize₂ + residual add).
    Weights HWIO; g/bt are the two instance norms' weight and bias."""
    y1, s1 = conv3x3_in_stats(x, w1, b1)
    y2, s2 = conv3x3_in_stats(y1, w2, b2, stats_in=s1, gamma=g1, beta=bt1)
    mean = s2[:, 0][:, None, None, :]
    var = s2[:, 1][:, None, None, :]
    out = (y2.float() - mean) * torch.rsqrt(var + EPS)
    out = out * g2.float() + bt2.float() + x.float()
    return out.to(x.dtype)
