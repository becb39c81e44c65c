"""K1: 3×3 reflect-pad conv with instance-norm statistics in its epilogue
and an optional normalize+relu prologue — hand-written CUDA kernel + its
plain PyTorch version.

Counterpart of ``vst_tpu/kernels/res_block.py`` (``conv3x3_in_stats``,
``residual_block_fused``).  One ReCoNet residual block is two launches
plus an elementwise tail in torch; the port's models run every residual
block this way.  The kernel source is ``csrc/res_block.cu``.

``conv3x3_in_stats`` launches the kernel for CUDA tensors (or raises) and
takes the plain version only for CPU tensors.  The kernel has no backward
yet: on the card a forward that needs a gradient raises (``_grad.py``).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from vst_tpu_torch.kernels import _build
from vst_tpu_torch.kernels._grad import refuse_grad
from vst_tpu_torch.ops.pad import reflection_pad2d

EPS = 1e-5   # torch InstanceNorm2d default


@functools.cache
def _kernel():
    fn = _build.load("res_block").vst_k1_conv3x3_in_stats
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def partial_blocks(h: int, wd: int) -> int:
    """Blocks per image whose partial statistics K1 writes for an (h, wd)
    image, from the kernel library itself (the tile lives in csrc/)."""
    fn = _build.load("res_block").vst_k1_partial_blocks
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(h, wd)


@functools.cache
def weight_floats(c: int, co: int) -> int:
    """Floats of the scratch that the float32 launch splits the weights
    into (their tf32 parts, transposed), from the kernel library."""
    fn = _build.load("res_block").vst_k1_weight_floats
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    return fn(c, co)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _prologue(stats_in, gamma, beta, dtype=torch.float32):
    """Per-image (mean, scale) and beta of relu((v − mean)·scale + beta),
    scale = γ·rsqrt(var + eps), all in ``dtype``."""
    mean = stats_in[:, 0].to(dtype).contiguous()
    scale = gamma.to(dtype) * torch.rsqrt(stats_in[:, 1].to(dtype) + EPS)
    return mean, scale.contiguous(), beta.to(dtype).contiguous()


def conv3x3_in_stats_plain(x, w, b, stats_in=None, gamma=None, beta=None):
    """Plain version, same rounding points as the kernel and the JAX one:
    the prologue output is rounded to x.dtype; the conv runs in float32;
    the stats come from the float32 result before it is rounded.  Float64
    inputs run in float64 throughout (the exact evaluation a card check
    may hold the float32 kernel against)."""
    n, h, wd, _ = x.shape
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    v = x
    if stats_in is not None:
        mean, scale, bt = _prologue(stats_in, gamma, beta, acc_t)
        vf = (x.to(acc_t) - mean[:, None, None, :]) * scale[:, None, None, :]
        v = torch.relu(vf + bt).to(x.dtype)
    vp = reflection_pad2d(v, 1)
    acc = F.conv2d(vp.permute(0, 3, 1, 2).to(acc_t),
                   w.permute(3, 2, 0, 1).to(acc_t), b.to(acc_t))
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
    if stats_in is not None and (
            gamma.dtype not in (torch.float32, torch.bfloat16)
            or beta.dtype != gamma.dtype):
        raise TypeError(f"conv3x3_in_stats: gamma {gamma.dtype} and beta "
                        f"{beta.dtype} must both be float32 or bfloat16")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3x3_in_stats: x, w and b must be contiguous")
    if x.dtype == torch.bfloat16 and (c % 8 or co % 8):
        raise ValueError(f"conv3x3_in_stats: bf16 needs C and Co multiples "
                         f"of 8, got {c}, {co}")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("conv3x3_in_stats: bf16 x and w must start on 16 "
                         "bytes (the kernel reads them as 16-byte vectors)")


def conv3x3_in_stats(x, w, b, stats_in=None, gamma=None, beta=None):
    """(B, H, W, C) → (conv output (B, H, W, Co) in x.dtype, per-image
    channel (mean, biased var) (B, 2, Co) float32).

    3×3 conv of the reflect-padded input with HWIO weights w (3, 3, C, Co)
    and bias b (Co,), all float32 (3xTF32 on the tensor cores; any C and
    Co) or all bfloat16 (C and Co multiples of 8).  With ``stats_in`` (B,
    2, C) and ``gamma``, ``beta`` (C,) (float32 or bfloat16) the input is
    first normalized with those per-image statistics and relu'd (the res
    block's middle normalize+relu, fused into the second conv); the
    library derives the scale = γ·rsqrt(var + eps) itself, in one
    launch."""
    if x.device.type == "cpu":
        return conv3x3_in_stats_plain(x, w, b, stats_in, gamma, beta)
    _check(x, w, b, stats_in, gamma, beta)
    refuse_grad("K1 conv3x3_in_stats", x, w, b, stats_in, gamma, beta)
    n, h, wd, c = x.shape
    co = w.shape[3]
    bf16 = x.dtype == torch.bfloat16
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    partial = torch.empty((n, partial_blocks(h, wd), 2, co), **f32)
    wsplit = None if bf16 else torch.empty(weight_floats(c, co), **f32)
    stats = torch.empty((n, 2, co), **f32)
    pro = [None] * 4   # stats_in, gamma, beta and the prologue's scratch
    if stats_in is not None:
        pro = [stats_in.float().contiguous(), gamma.contiguous(),
               beta.contiguous(), torch.empty(2 * n * c + c, **f32)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            *(_ptr(t) for t in pro[:3]),
            int(stats_in is not None and gamma.dtype == torch.bfloat16),
            _ptr(pro[3]), _ptr(wsplit), y.data_ptr(), partial.data_ptr(),
            stats.data_ptr(), n, h, wd, c, co, int(bf16), stream)
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
