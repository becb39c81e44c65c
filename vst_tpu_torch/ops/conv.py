"""Convolutions and pooling (NHWC activations, OIHW weights as the
reference's ``state_dict`` stores them).

Counterpart of ``vst_tpu/ops/conv.py``.  The JAX forms there
(``conv2d_reflect1_k3s1``, ``conv2d_reflect1_k3s2``,
``conv2d_nearest_up2``) are XLA layout rewrites of "reflect-pad, then
convolve"; the port computes the same function directly.  The 9×9
layers keep the JAX package's f=4 polyphase packing, because the packed
3×3 VALID conv is what kernel K2 (``kernels/head_conv.py``) computes.
"""

import torch
import torch.nn.functional as F

from vst_tpu_torch.kernels.head_conv import conv3x3_valid
from vst_tpu_torch.ops.pad import reflection_pad2d
from vst_tpu_torch.ops.resize import upsample_nearest


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch Conv2d semantics (symmetric zero ``padding``) on NHWC input
    with OIHW weights → NHWC: the VGG convs and AdaAttN's 1×1 convs."""
    return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride, padding=padding))


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """``torch.nn.MaxPool2d(window, stride)`` (VALID) on NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def conv2d_reflect(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None,
                   stride: int = 1) -> torch.Tensor:
    """Reflect-pad k//2, then a k×k conv: ReCoNet's ConvLayer and AdaAttN's
    ``Conv`` (AdaAttN/network.py:11-21).  x NHWC, w OIHW → NHWC."""
    xp = reflection_pad2d(x, w.shape[-1] // 2)
    return _nhwc(F.conv2d(_nchw(xp), w, b, stride=stride))


def conv2d_nearest_up2(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor | None = None) -> torch.Tensor:
    """ReCoNet's UpsampleConvLayer body: nearest ×2, reflect-pad 1, 3×3."""
    return conv2d_reflect(upsample_nearest(x, 2), w, b)


def polyphase_weights(w: torch.Tensor, f: int) -> torch.Tensor:
    """OIHW k×k weights → the packed HWIO (t, t, f²·Cin, f²·Cout) form:
    W2[di, dj, (p, q, cin), (a, b, cout)] = w[f·di+p−a, f·dj+q−b], zero
    outside [0, k).  Channel order is (row phase, column phase, c), c
    fastest, as ``vst_tpu/ops/conv.py::_polyphase_weights``."""
    cout, cin, k, _ = w.shape
    t = (k + f - 2) // f + 1
    pad = f - 1
    hwio = w.permute(2, 3, 1, 0).float()
    w_pad = F.pad(hwio, (0, 0, 0, 0, pad, pad, pad, pad))
    di = torch.arange(t)[:, None, None]
    p = torch.arange(f)[None, :, None]
    a = torch.arange(f)[None, None, :]
    idx = (f * di + p - a + pad).reshape(-1).to(w.device)
    g = w_pad[idx].reshape(t, f, f, k + 2 * pad, cin, cout)
    g = g[:, :, :, idx].reshape(t, f, f, t, f, f, cin, cout)
    # [di, p, a, dj, q, b, c, o] → [di, dj, (p, q, c), (a, b, o)]
    return g.permute(0, 3, 1, 4, 6, 2, 5, 7).reshape(
        t, t, f * f * cin, f * f * cout).to(w.dtype).contiguous()


def conv2d_polyphase_reflect(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor | None = None,
                             factor: int = 4) -> torch.Tensor:
    """Reflect-pad k//2 then a k×k stride-1 conv (k = 2f+1), computed as a
    3×3 VALID conv over the f×-space-to-depth packed input (K2).

    With pad = k//2 = f, reflect-padding by f and packing f×f pixels per
    channel group gives exactly the packed tensor the JAX form builds by
    phase shuffling (``vst_tpu/ops/conv.py:202-226``).  An H or W that is
    not a multiple of f gets zero rows/columns below and right of the
    padded input; the outputs they feed lie outside (H, W) and are cut
    off, so every size goes through the same kernel."""
    f = factor
    cout, cin, k, _ = w.shape
    if k != 2 * f + 1:
        raise ValueError(f"polyphase reflect conv needs k == 2f+1, got "
                         f"k={k}, f={f}")
    n, h, wd, _ = x.shape
    hq, wq = -(-h // f), -(-wd // f)
    xp = reflection_pad2d(x, f)
    if (hq * f, wq * f) != (h, wd):
        xp = F.pad(xp, (0, 0, 0, wq * f - wd, 0, hq * f - h))
    packed = xp.reshape(n, hq + 2, f, wq + 2, f, cin).permute(
        0, 1, 3, 2, 4, 5).reshape(n, hq + 2, wq + 2, f * f * cin)
    out = conv3x3_valid(packed.contiguous(), polyphase_weights(w, f))
    out = out.reshape(n, hq, wq, f, f, cout).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, hq * f, wq * f, cout)[:, :h, :wd]
    if b is not None:
        out = out + b.to(out.dtype)
    return out.contiguous()
