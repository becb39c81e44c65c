"""K2: packed 3×3 VALID convolution — hand-written CUDA kernel + its plain
PyTorch version.

Counterpart of ``vst_tpu/kernels/head_conv.py::conv3x3_valid_pallas``.
In the port it carries the 9×9 stem and 9×9 ConvTanh head of every
ReCoNet forward after f=4 polyphase packing
(``ops/conv.py::conv2d_polyphase_reflect``).  The kernel source is
``csrc/head_conv.cu``.

``conv3x3_valid`` launches the kernel for CUDA tensors (or raises) and
takes the plain version only for CPU tensors.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from vst_tpu_torch.kernels import _build

@functools.cache
def _kernel():
    fn = _build.load("head_conv").vst_k2_conv3x3_valid
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3x3_valid_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: one float32 conv over the packed input (the JAX kernel
    casts both operands to f32), output in x.dtype."""
    out = F.conv2d(x.permute(0, 3, 1, 2).float(),
                   w.permute(3, 2, 0, 1).float())
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv3x3_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 VALID convolution, NHWC × HWIO → NHWC, float32 accumulation.

    x: (N, Ho+2, Wo+2, C); w: (3, 3, C, Co), same dtype (float32 on the
    CUDA cores, or bfloat16 on the tensor cores with C and Co multiples of
    8); output (N, Ho, Wo, Co) in x.dtype."""
    if x.device.type == "cpu":
        return conv3x3_valid_plain(x, w)
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
    y = torch.empty((n, hp - 2, wp - 2, co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), n, hp, wp, c, co,
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"K2 conv3x3_valid launch failed: CUDA error {rc}")
    conv3x3_valid.launches += 1
    return y


conv3x3_valid.launches = 0
