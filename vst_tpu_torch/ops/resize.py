"""Nearest-neighbour upsampling (NHWC).  Counterpart of
``vst_tpu/ops/resize.py::upsample_nearest`` (torch
``F.interpolate(scale_factor=k)``, mode "nearest", integer factors)."""

import torch


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Each pixel of an NHWC tensor repeats ``scale``× along H and W."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
