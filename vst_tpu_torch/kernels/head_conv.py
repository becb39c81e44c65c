"""K2: packed 3×3 VALID convolution — hand-written CUDA kernel + its plain
PyTorch version.

Counterpart of ``vst_tpu/kernels/head_conv.py::conv3x3_valid_pallas``.
In the port it carries the 9×9 stem and 9×9 ConvTanh head of every
ReCoNet forward after f=4 polyphase packing
(``ops/conv.py::conv2d_polyphase_reflect``).  The kernel source is
``csrc/head_conv.cu``.

``conv3x3_valid`` is the autograd Function ``Conv3x3Valid``: its forward
launches the kernel for CUDA tensors (or raises) and takes the plain
version only for CPU tensors; its backward is the same on both devices,
the library's conv gradients (``torch.nn.grad.conv2d_input`` /
``conv2d_weight``) in float32, as the JAX package's backward of this conv
is XLA's: the TPU has no backward kernel here to port.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vst_tpu_torch.device import apply_precision
from vst_tpu_torch.kernels import _build


@functools.cache
def _kernel():
    fn = _build.load("head_conv").vst_k2_conv3x3_valid
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def weight_floats(c: int, co: int) -> int:
    """Floats of the scratch that the float32 launch splits the weights
    into (their tf32 parts, transposed), from the kernel library."""
    fn = _build.load("head_conv").vst_k2_weight_floats
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    return fn(c, co)


def conv3x3_valid_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: one float32 conv over the packed input (the JAX kernel
    casts both operands to f32), output in x.dtype; float64 inputs run in
    float64 (the exact evaluation)."""
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    out = F.conv2d(x.permute(0, 3, 1, 2).to(acc_t),
                   w.permute(3, 2, 0, 1).to(acc_t))
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors (the forward of ``Conv3x3Valid``)."""
    n, hp, wp, c = x.shape
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv3x3_valid: x on {x.device}, w on {w.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"conv3x3_valid: dtypes {x.dtype}, {w.dtype}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c) or hp < 3 or wp < 3:
        raise ValueError(f"conv3x3_valid: shapes {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_valid: x and w must be contiguous")
    co = w.shape[3]
    if x.dtype == torch.bfloat16 and (c % 8 or co % 8):
        raise ValueError(f"conv3x3_valid: bf16 needs C and Co multiples of "
                         f"8, got {c}, {co}")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("conv3x3_valid: bf16 x and w must start on 16 bytes "
                         "(the kernel reads them as 16-byte vectors)")
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty((n, hp - 2, wp - 2, co), dtype=x.dtype, device=x.device)
    wsplit = None if bf16 else torch.empty(
        weight_floats(c, co), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            x.data_ptr(), w.data_ptr(),
            None if wsplit is None else wsplit.data_ptr(), y.data_ptr(), n,
            hp, wp, c, co, int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"K2 conv3x3_valid launch failed: CUDA error {rc}")
    conv3x3_valid.launches += 1
    return y


def conv3x3_valid_vjp(x, w, gy, need=(True, True)):
    """(dx, dw) of the 3×3 VALID conv from its inputs and the output
    gradient gy, each None where ``need`` says it is not wanted: library
    convolutions in float32 (float64 for float64 inputs), cast back to the
    inputs' dtypes.  TF32 is off for float32 inputs (JAX differentiates
    at HIGHEST precision)."""
    apply_precision(x.dtype)
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    g = gy.to(acc_t).permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).to(acc_t)
    dx = dw = None
    if need[0]:
        dx = torch.nn.grad.conv2d_input(
            (x.shape[0], x.shape[3], x.shape[1], x.shape[2]), w_oihw, g)
        dx = dx.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    if need[1]:
        dw = torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2).to(acc_t),
                                         w_oihw.shape, g)
        dw = dw.permute(2, 3, 1, 0).to(w.dtype).contiguous()
    return dx, dw


class Conv3x3Valid(torch.autograd.Function):
    """K2 with a gradient.  ``fwd`` computes the forward: ``_launch`` (the
    kernel) on the card, ``conv3x3_valid_plain`` on the CPU or as the plain
    route a card check compares against.  The backward is
    ``conv3x3_valid_vjp`` whatever the forward."""

    @staticmethod
    def forward(ctx, x, w, fwd):
        ctx.save_for_backward(x, w)
        return fwd(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        return (*conv3x3_valid_vjp(*ctx.saved_tensors, gy,
                                   ctx.needs_input_grad[:2]), None)


def conv3x3_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 VALID convolution, NHWC × HWIO → NHWC, float32 accumulation,
    differentiable in x and w.

    x: (N, Ho+2, Wo+2, C); w: (3, 3, C, Co), same dtype (float32 as 3xTF32
    on the tensor cores, any C and Co; or bfloat16 with C and Co multiples
    of 8); output (N, Ho, Wo, Co) in x.dtype.  CPU tensors (float64 too)
    take the plain version."""
    fwd = conv3x3_valid_plain if x.device.type == "cpu" else _launch
    return Conv3x3Valid.apply(x, w, fwd)


conv3x3_valid.launches = 0
