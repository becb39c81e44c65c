"""Resampling (NHWC).  Counterpart of ``vst_tpu/ops/resize.py``.

- ``resize_bilinear``: torch's ``F.interpolate(mode="bilinear",
  align_corners=False)`` without antialiasing (AdaAttN feature pyramids
  and decoder upsampling).
- ``upsample_nearest``: ``F.interpolate(scale_factor=k)``, mode "nearest",
  integer factors (ReCoNet's UpsampleConvLayer).
"""

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Resize an NHWC tensor to (out_h, out_w), bilinear with
    align_corners=False and no antialiasing, in x's dtype."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Each pixel of an NHWC tensor repeats ``scale``× along H and W."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
