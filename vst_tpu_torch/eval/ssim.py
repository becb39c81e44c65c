"""SSIM metric (parity: AdaAttN/eval.py:167-223 ``SSIMMetric``).

Counterpart of ``vst_tpu/eval/ssim.py``: a Gaussian window (size 11,
σ 1.5) depthwise convolution with zero padding, C1=0.01², C2=0.03².  The
reference evaluates on 0–255 tensors with [0,1]-range constants
(eval.py:224-236); whatever range the caller supplies is accepted,
mirroring that.  Computed in float32 with TF32 off, on the inputs'
device.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from vst_tpu_torch.device import apply_precision


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(window_size: int, sigma: float) -> np.ndarray:
    g1 = np.linspace(-(window_size // 2), window_size // 2, window_size)
    g = np.exp(-(g1 ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_blur(x, kernel, pad):
    """x: (N, C, H, W) float32; one ``kernel`` per channel, zero padding."""
    c = x.shape[1]
    k = torch.from_numpy(kernel).to(x.device)
    return F.conv2d(x, k.expand(c, 1, *kernel.shape), padding=pad, groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, reduction: str = "mean") -> torch.Tensor:
    """img1/img2: (N, H, W, C).  Returns a scalar (mean) or a per-image
    vector."""
    if img1.shape != img2.shape or img1.dim() != 4:
        raise ValueError(f"ssim needs two NHWC tensors of one shape, got "
                         f"{tuple(img1.shape)} and {tuple(img2.shape)}")
    apply_precision(torch.float32)
    pad = window_size // 2
    kern = _gaussian_kernel(window_size, sigma)
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2

    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    mu1 = _depthwise_blur(x, kern, pad)
    mu2 = _depthwise_blur(y, kern, pad)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(x * x, kern, pad) - mu1_sq
    sigma2_sq = _depthwise_blur(y * y, kern, pad) - mu2_sq
    sigma12 = _depthwise_blur(x * y, kern, pad) - mu1_mu2

    num = (2 * mu1_mu2 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    per_image = (num / den).mean(dim=(1, 2, 3))
    return per_image.mean() if reduction == "mean" else per_image
