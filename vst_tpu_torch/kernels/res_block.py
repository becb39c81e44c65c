"""K1: 3×3 reflect-pad conv with instance-norm statistics in its epilogue
and an optional normalize+relu prologue — hand-written CUDA kernel + its
plain PyTorch version.

Counterpart of ``vst_tpu/kernels/res_block.py`` (``conv3x3_in_stats``,
``residual_block_fused``).  One residual block (ReCoNet's at 192 or 64
channels, RTNSTV's at 48) is two launches plus an elementwise tail in
torch; the port's models run every residual block this way.  The kernel
source is ``csrc/res_block.cu``.

Halo-rows mode (``conv3x3_in_stats_halo``, ``csrc/res_block_halo.cu``):
the same conv over one row shard of an H-sharded frame, whose input
carries its neighbours' rows (``parallel/spatial.py::exchange_rows``) and
a reflect-padded W border, and whose statistics come back as the shard's
sums Σy, Σy² for the caller to all-reduce.  ``residual_block_fused(...,
spatial=ctx)`` runs every launch in this mode, world 1 included.  It is
the autograd Function ``Conv3x3InStatsHalo``, whose backward
(``conv3x3_in_stats_halo_vjp``) shares the reflect mode's VJP, so the
sharded residual block differentiates end to end (data × space
training).

``conv3x3_in_stats`` is the autograd Function ``Conv3x3InStats``: its
forward launches the kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors; its backward is one explicit VJP on
both devices (``conv3x3_in_stats_vjp``), whose convolutions are library
calls (``torch.nn.grad.conv2d_input`` / ``conv2d_weight``), as the JAX
package's backward of this conv is XLA's conv transpose: the TPU has no
backward kernel here to port.  Where no gradient can flow (serving), the
wrappers call the forward without the Function.

A call costs the host about as much as the narrow kernels cost the card
(RTNSTV's 48 channels, SD1/SD2's 64: a few hundredths of a ms), so the
launch path is kept short: one check of plain comparisons, two
allocations (y and the statistics; the partial sums and the other
scratch live in a workspace kept per device and stream), one ctypes call
that makes two launches (the conv, whose prologue derives its own
parameters, and the statistics' reduction; three in the other bodies),
and the kernel's attributes asked of the runtime once
(``experiments/k1_narrow_variants.py`` times each part).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vst_tpu_torch.device import apply_precision
from vst_tpu_torch.kernels import _build
from vst_tpu_torch.ops.pad import reflection_pad2d

EPS = 1e-5   # torch InstanceNorm2d default


def _bind(lib, entry):
    fn = getattr(_build.load(lib), entry)
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    return _bind("res_block", "vst_k1_conv3x3_in_stats")


@functools.cache
def _kernel_halo():
    return _bind("res_block_halo", "vst_k1_conv3x3_in_stats_halo")


@functools.cache
def partial_blocks(h: int, wd: int, c: int, co: int,
                   dtype: torch.dtype) -> int:
    """Blocks per image whose partial statistics K1 writes for an (h, wd)
    image from C to Co channels in ``dtype``, from the kernel library
    itself (the tile lives in csrc/: 16 x 16 pixels in the narrow bf16
    body, C and Co <= 64; else 8 x 16)."""
    fn = _build.load("res_block").vst_k1_partial_blocks
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return fn(h, wd, c, co, int(dtype == torch.bfloat16))


@functools.cache
def work_floats(n: int, h: int, wd: int, c: int, co: int, bf16: bool,
                prologue: bool) -> int:
    """Floats of the workspace one call needs, from the kernel library:
    the partial sums, with a prologue room for its parameters (which only
    the wider bodies' prologue_params writes), the float32 body's split
    weights."""
    fn = _build.load("res_block").vst_k1_work_floats
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return fn(n, h, wd, c, co, int(bf16), int(prologue))


# (device, stream) -> the float32 workspace of the calls on that stream:
# one stream's launches run in order, so each call reuses it (grown as
# needed) where it would allocate; a launch on another stream never
# shares it.
_workspaces: dict = {}


def _workspace(x, dev, stream, floats):
    work = _workspaces.get((dev, stream))
    if work is None or work.numel() < floats:
        work = _workspaces[(dev, stream)] = x.new_empty(floats,
                                                        dtype=torch.float32)
    return work


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev):
    """The raw handle of the device's current stream."""
    return (_RAW_STREAM(dev) if _RAW_STREAM is not None
            else torch.cuda.current_stream(dev).cuda_stream)


def _prologue(stats_in, gamma, beta, dtype=torch.float32):
    """Per-image (mean, scale) and beta of relu((v − mean)·scale + beta),
    scale = γ·rsqrt(var + eps), all in ``dtype``."""
    mean = stats_in[:, 0].to(dtype).contiguous()
    scale = gamma.to(dtype) * torch.rsqrt(stats_in[:, 1].to(dtype) + EPS)
    return mean, scale.contiguous(), beta.to(dtype).contiguous()


def _plain_conv(x, w, b, stats_in, gamma, beta, pad):
    """relu(IN(x))-prologue (optional), then the 3×3 conv of x
    reflect-padded by ``pad`` (0: x is padded already) in the
    accumulation dtype: float32, float64 for float64 inputs.  The
    prologue output is rounded to x.dtype first, as the kernel does."""
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    v = x
    if stats_in is not None:
        mean, scale, bt = _prologue(stats_in, gamma, beta, acc_t)
        vf = (x.to(acc_t) - mean[:, None, None, :]) * scale[:, None, None, :]
        v = torch.relu(vf + bt).to(x.dtype)
    vp = reflection_pad2d(v, pad)
    acc = F.conv2d(vp.permute(0, 3, 1, 2).to(acc_t),
                   w.permute(3, 2, 0, 1).to(acc_t), b.to(acc_t))
    return acc.permute(0, 2, 3, 1)


def conv3x3_in_stats_plain(x, w, b, stats_in=None, gamma=None, beta=None):
    """Plain version, same rounding points as the kernel and the JAX one:
    the prologue output is rounded to x.dtype; the conv runs in float32;
    the stats come from the float32 result before it is rounded.  Float64
    inputs run in float64 throughout (the exact evaluation a card check
    may hold the float32 kernel against)."""
    n, h, wd, _ = x.shape
    acc = _plain_conv(x, w, b, stats_in, gamma, beta, 1)
    hw = float(h * wd)
    mean = acc.sum(dim=(1, 2)) / hw
    var = (acc * acc).sum(dim=(1, 2)) / hw - mean * mean
    return acc.to(x.dtype).contiguous(), torch.stack([mean, var], dim=1)


def conv3x3_in_stats_halo_plain(xh, w, b, stats_in=None, gamma=None,
                                beta=None):
    """Plain version of the halo-rows mode: the prologue and a VALID conv
    over xh (N, R+2, W+2, C), whose border rows and columns are already
    there → (y (N, R, W, Co) in xh.dtype, this shard's per-image sums
    Σy, Σy² (N, 2, Co), float32 or float64 for float64 input)."""
    acc = _plain_conv(xh, w, b, stats_in, gamma, beta, 0)
    sums = torch.stack([acc.sum(dim=(1, 2)), (acc * acc).sum(dim=(1, 2))],
                       dim=1)
    return acc.to(xh.dtype).contiguous(), sums


def _check(x, w, b, stats_in, gamma, beta):
    """Raises on what the kernel does not take; returns (N, H, W, C, Co)
    of x and w.  Kept to plain comparisons: it runs on every call."""
    dev = x.get_device()
    pro = stats_in is not None
    if dev < 0 or w.get_device() != dev or b.get_device() != dev or pro and (
            gamma is None or beta is None or stats_in.get_device() != dev
            or gamma.get_device() != dev or beta.get_device() != dev):
        raise ValueError("conv3x3_in_stats: every tensor must be on one "
                         f"CUDA device (x on {x.device})")
    dt = x.dtype
    if (dt is not torch.float32 and dt is not torch.bfloat16
            or w.dtype is not dt or b.dtype is not dt):
        raise TypeError(f"conv3x3_in_stats: dtypes x {x.dtype}, w {w.dtype}, "
                        f"b {b.dtype}")
    shape, ws = x.shape, w.shape
    if (len(shape) != 4 or len(ws) != 4 or ws[0] != 3 or ws[1] != 3
            or ws[2] != shape[3] or b.shape != ws[3:] or shape[1] < 2
            or shape[2] < 2):
        raise ValueError(f"conv3x3_in_stats: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    n, _, _, c = shape
    co = ws[3]
    if pro and (stats_in.shape != (n, 2, c) or gamma.shape != (c,)
                or beta.shape != (c,)):
        raise ValueError("conv3x3_in_stats: stats_in must be (N, 2, C) and "
                         "gamma, beta (C,)")
    if pro and (gamma.dtype is not torch.float32
                and gamma.dtype is not torch.bfloat16
                or beta.dtype is not gamma.dtype):
        raise TypeError(f"conv3x3_in_stats: gamma {gamma.dtype} and beta "
                        f"{beta.dtype} must both be float32 or bfloat16")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3x3_in_stats: x, w and b must be contiguous")
    if dt is torch.bfloat16 and (c % 8 or co % 8):
        raise ValueError(f"conv3x3_in_stats: bf16 needs C and Co multiples "
                         f"of 8, got {c}, {co}")
    if dt is torch.bfloat16 and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("conv3x3_in_stats: bf16 x and w must start on 16 "
                         "bytes (the kernel reads them as 16-byte vectors)")
    return n, shape[1], shape[2], c, co


def _run(entry, x, w, b, stats_in, gamma, beta, halo):
    """One call of the library's entry ``entry()`` on CUDA tensors: y, the
    statistics (mean, var) or, with ``halo`` 2, the sums, and the CUDA
    error code."""
    n, h, wd, c, co = _check(x, w, b, stats_in, gamma, beta)
    dev = x.get_device()
    h, wd = h - halo, wd - halo
    bf16 = x.dtype is torch.bfloat16
    pro = stats_in is not None
    y = x.new_empty((n, h, wd, co))
    stats = x.new_empty((n, 2, co), dtype=torch.float32)
    ptrs, gb_bf16 = (None, None, None), 0
    if pro:
        if stats_in.dtype is not torch.float32 or not stats_in.is_contiguous():
            stats_in = stats_in.float().contiguous()
        gamma, beta = gamma.contiguous(), beta.contiguous()
        ptrs = (stats_in.data_ptr(), gamma.data_ptr(), beta.data_ptr())
        gb_bf16 = int(gamma.dtype is torch.bfloat16)
    stream = _stream(dev)
    work = _workspace(x, dev, stream, work_floats(n, h, wd, c, co, bf16, pro))
    rc = entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), *ptrs, gb_bf16,
                 y.data_ptr(), stats.data_ptr(), work.data_ptr(), n, h, wd,
                 c, co, int(bf16), dev, stream)
    return y, stats, rc


def _launch(x, w, b, stats_in=None, gamma=None, beta=None):
    """The kernel on CUDA tensors (the forward of ``Conv3x3InStats``)."""
    y, stats, rc = _run(_kernel, x, w, b, stats_in, gamma, beta, 0)
    if rc != 0:
        raise RuntimeError(f"K1 conv3x3_in_stats launch failed: CUDA error {rc}")
    conv3x3_in_stats.launches += 1
    return y, stats


def _launch_halo(xh, w, b, stats_in=None, gamma=None, beta=None):
    """The halo-rows kernel on CUDA tensors: xh (N, R+2, W+2, C) →
    (y (N, R, W, Co), sums (N, 2, Co) float32)."""
    y, sums, rc = _run(_kernel_halo, xh, w, b, stats_in, gamma, beta, 2)
    if rc != 0:
        raise RuntimeError(f"K1 conv3x3_in_stats_halo launch failed: CUDA "
                           f"error {rc}")
    conv3x3_in_stats_halo.launches += 1
    return y, sums


def _apply(function, fwd, x, w, b, stats_in, gamma, beta):
    """``function.apply`` where a gradient can flow; else ``fwd`` alone,
    which gives the same outputs without the autograd Function's host
    cost (serving calls K1 ten times a forward)."""
    if torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad or b.requires_grad
            or stats_in is not None and (stats_in.requires_grad
                                         or gamma.requires_grad
                                         or beta.requires_grad)):
        return function.apply(x, w, b, stats_in, gamma, beta, fwd)
    return fwd(x, w, b, stats_in, gamma, beta)


def conv3x3_in_stats_halo(xh, w, b, stats_in=None, gamma=None, beta=None):
    """K1's halo-rows mode: xh (B, R+2, W+2, C), a row shard with its
    neighbours' (or a global edge's reflected) rows above and below and
    its W border reflect-padded → (y (B, R, W, Co) in xh.dtype, the
    shard's per-image sums Σy, Σy² (B, 2, Co) float32), with the optional
    normalize+relu prologue of ``conv3x3_in_stats``, differentiable in
    every tensor argument (``Conv3x3InStatsHalo``).  CUDA tensors launch
    the kernel (or raise), CPU tensors take the plain version."""
    fwd = conv3x3_in_stats_halo_plain if xh.is_cpu else _launch_halo
    return _apply(Conv3x3InStatsHalo, fwd, xh, w, b, stats_in, gamma, beta)


conv3x3_in_stats_halo.launches = 0


def _conv_vjp(x, w, b, stats_in, gamma, beta, g, pad, need):
    """The part of K1's VJP that both modes share: from ``g``, the conv
    output's gradient (B, Co, H, W) in the accumulation dtype, the
    gradients of (x, w, b, stats_in, gamma, beta), each None where
    ``need`` says it is not wanted.  ``pad``: 1 for the reflect mode (x is
    reflect-padded after the prologue), 0 for the halo-rows mode (x has
    its border rows and columns already: a VALID conv).

    dw and db come from g and the recomputed padded prologue output,
    dv_pad from g and w, all in float32 (float64 for float64 inputs; TF32
    off for float32 inputs, as JAX differentiates at HIGHEST precision)
    through library convolutions; dv_pad goes back through the recomputed
    pad and prologue (elementwise) by autograd, which gives x, stats_in,
    gamma and beta theirs."""
    need_x, need_w, need_b, need_s, need_g, need_bt = need
    apply_precision(x.dtype)   # float32: the library convs without TF32
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    prologue = stats_in is not None
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(nd) if t is not None else None
                  for t, nd in ((x, need_x), (stats_in, need_s),
                                (gamma, need_g), (beta, need_bt))]
        v = leaves[0]
        if prologue:
            m_in, scale, bt = _prologue(*leaves[1:], acc_t)
            v = torch.relu((v.to(acc_t) - m_in[:, None, None, :])
                           * scale[:, None, None, :] + bt).to(x.dtype)
        vp = reflection_pad2d(v, pad)
    vp_nchw = vp.detach().permute(0, 3, 1, 2).to(acc_t)
    w_oihw = w.detach().permute(3, 2, 0, 1).to(acc_t)
    dw = db = None
    if need_w:
        dw = torch.nn.grad.conv2d_weight(vp_nchw, w_oihw.shape, g)
        dw = dw.permute(2, 3, 1, 0).to(w.dtype).contiguous()
    if need_b:
        db = g.sum(dim=(0, 2, 3)).to(b.dtype)
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    found = {}
    if wanted:
        dvp = torch.nn.grad.conv2d_input(vp_nchw.shape, w_oihw, g)
        found = dict(zip(map(id, wanted), torch.autograd.grad(
            vp, wanted, dvp.permute(0, 2, 3, 1).to(vp.dtype))))
    dx, ds, dg, dbt = (None if t is None else found.get(id(t))
                       for t in leaves)
    return dx, dw, db, ds, dg, dbt


def conv3x3_in_stats_vjp(x, w, b, stats_in, gamma, beta, y, stats, gy,
                         gstats, need=(True,) * 6):
    """Gradients of ``conv3x3_in_stats`` for (x, w, b, stats_in, gamma,
    beta), each None where ``need`` says it is not wanted, from the saved
    inputs and outputs (y, stats) and the output gradients gy (B, H, W, Co)
    and gstats (B, 2, Co).

    The statistics fold into the conv output's gradient,
    g = gy + gmean/HW + gvar·2(y − mean)/HW, with y the saved output: in
    bfloat16 it is rounded (relative 2⁻⁹) while the kernel's statistics
    come from its float32 accumulator, so the gvar term carries that
    rounding, an error of about 2⁻⁸·|gvar|·|y − mean|/HW per element
    beside the bf16 forward's own.  The rest is ``_conv_vjp`` on the
    reflect-padded input."""
    _, h, wd, _ = x.shape
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    hw = float(h * wd)
    mean = stats[:, 0].to(acc_t)[:, None, None, :]
    g = (gy.to(acc_t) + gstats[:, 0].to(acc_t)[:, None, None, :] / hw
         + gstats[:, 1].to(acc_t)[:, None, None, :] * (2.0 / hw)
         * (y.to(acc_t) - mean)).permute(0, 3, 1, 2)
    return _conv_vjp(x, w, b, stats_in, gamma, beta, g, 1, need)


def conv3x3_in_stats_halo_vjp(xh, w, b, stats_in, gamma, beta, y, gy,
                              gsums, need=(True,) * 6):
    """Gradients of ``conv3x3_in_stats_halo`` for (xh, w, b, stats_in,
    gamma, beta), as ``conv3x3_in_stats_vjp``, from the saved y and the
    output gradients gy (B, R, W, Co) and gsums (B, 2, Co).

    The sums fold into the conv output's gradient, g = gy + gΣy +
    2·y·gΣy² (no division: the caller divides the all-reduced sums by the
    global H·W), and ``_conv_vjp`` runs a VALID conv on xh, whose halo
    rows and W border are the exchange's (its own backward takes their
    gradients back to their sources).  The bf16 caveat of
    ``conv3x3_in_stats_vjp`` holds here too: y is the rounded output, the
    sums came from the float32 accumulator, so the gΣy² term carries y's
    rounding, about 2⁻⁸·|gΣy²|·|y| per element."""
    acc_t = torch.float64 if xh.dtype == torch.float64 else torch.float32
    g = (gy.to(acc_t) + gsums[:, 0].to(acc_t)[:, None, None, :]
         + 2.0 * gsums[:, 1].to(acc_t)[:, None, None, :]
         * y.to(acc_t)).permute(0, 3, 1, 2)
    return _conv_vjp(xh, w, b, stats_in, gamma, beta, g, 0, need)


class Conv3x3InStats(torch.autograd.Function):
    """K1 with a gradient.  ``fwd`` computes the forward: ``_launch`` (the
    kernel) on the card, ``conv3x3_in_stats_plain`` on the CPU or as the
    plain route a card check compares against.  The backward is
    ``conv3x3_in_stats_vjp`` whatever the forward."""

    @staticmethod
    def forward(ctx, x, w, b, stats_in, gamma, beta, fwd):
        y, stats = fwd(x, w, b, stats_in, gamma, beta)
        ctx.save_for_backward(x, w, b, stats_in, gamma, beta, y, stats)
        return y, stats

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gstats):
        grads = conv3x3_in_stats_vjp(*ctx.saved_tensors, gy, gstats,
                                     ctx.needs_input_grad[:6])
        return (*grads, None)


class Conv3x3InStatsHalo(torch.autograd.Function):
    """K1's halo-rows mode with a gradient.  ``fwd`` computes the forward:
    ``_launch_halo`` (the kernel) on the card, ``conv3x3_in_stats_halo_
    plain`` on the CPU or as the plain route a card check compares
    against.  The backward is ``conv3x3_in_stats_halo_vjp`` whatever the
    forward."""

    @staticmethod
    def forward(ctx, xh, w, b, stats_in, gamma, beta, fwd):
        y, sums = fwd(xh, w, b, stats_in, gamma, beta)
        ctx.save_for_backward(xh, w, b, stats_in, gamma, beta, y)
        return y, sums

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, gsums):
        grads = conv3x3_in_stats_halo_vjp(*ctx.saved_tensors, gy, gsums,
                                          ctx.needs_input_grad[:6])
        return (*grads, None)


def conv3x3_in_stats(x, w, b, stats_in=None, gamma=None, beta=None):
    """(B, H, W, C) → (conv output (B, H, W, Co) in x.dtype, per-image
    channel (mean, biased var) (B, 2, Co) float32), differentiable in every
    tensor argument.

    3×3 conv of the reflect-padded input with HWIO weights w (3, 3, C, Co)
    and bias b (Co,), all float32 (3xTF32 on the tensor cores; any C and
    Co) or all bfloat16 (C and Co multiples of 8).  With ``stats_in`` (B,
    2, C) and ``gamma``, ``beta`` (C,) (float32 or bfloat16) the input is
    first normalized with those per-image statistics and relu'd (the res
    block's middle normalize+relu, fused into the second conv); the
    library derives the scale = γ·rsqrt(var + eps) itself.  CPU tensors
    (float64 too) take the plain version."""
    fwd = conv3x3_in_stats_plain if x.is_cpu else _launch
    return _apply(Conv3x3InStats, fwd, x, w, b, stats_in, gamma, beta)


conv3x3_in_stats.launches = 0


def residual_block_fused(x, w1, b1, g1, bt1, w2, b2, g2, bt2, spatial=None):
    """One residual block (conv→IN→relu→conv→IN, + x) of ReCoNet or RTNSTV
    as two K1 launches and a float32 (float64 for float64 input)
    elementwise tail (normalize₂ + residual add).  Where the block widens
    the channels, x is zero-padded to them (RTNSTV/network.py:40-43).
    Weights HWIO; g/bt are the two instance norms' weight and bias.

    With a ``spatial`` context (``parallel/spatial.py``) x is this rank's
    row shard and both launches run in the halo-rows mode: conv1 on the
    exchanged rows, its sums all-reduced into the frame's statistics, y1's
    edge rows exchanged raw, conv2 with those statistics in its prologue,
    its sums all-reduced, then the same tail.  Every step of it carries
    its gradient (the halo Functions, the exchange's adjoint, the
    all-reduce's all-reduce)."""
    if spatial is None:
        y1, s1 = conv3x3_in_stats(x, w1, b1)
        y2, s2 = conv3x3_in_stats(y1, w2, b2, stats_in=s1, gamma=g1,
                                  beta=bt1)
    else:
        from vst_tpu_torch.parallel import spatial as sp

        count = x.shape[1] * x.shape[2]   # the block's; the frame's below
        # each launch's input: one row a side from the exchange (reflected
        # at a frame edge) and the W border reflected, (N, R+2, W+2, C)
        y1, sums = conv3x3_in_stats_halo(
            sp.exchange_rows(spatial, x, 1, 1, "reflect", 1), w1, b1)
        s1 = sp.sharded_in_stats(spatial, sums, count)
        y2, sums = conv3x3_in_stats_halo(
            sp.exchange_rows(spatial, y1, 1, 1, "reflect", 1), w2, b2, s1,
            g1, bt1)
        s2 = sp.sharded_in_stats(spatial, sums, count)
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    mean = s2[:, 0][:, None, None, :]
    var = s2[:, 1][:, None, None, :]
    out = (y2.to(acc_t) - mean) * torch.rsqrt(var + EPS)
    residual = x.to(acc_t)
    if x.shape[-1] != y2.shape[-1]:
        residual = F.pad(residual, (0, y2.shape[-1] - x.shape[-1]))
    out = out * g2.to(acc_t) + bt2.to(acc_t) + residual
    return out.to(x.dtype)
