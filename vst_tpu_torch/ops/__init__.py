"""NHWC image ops of the ReCoNet serving path (counterparts of
``vst_tpu/ops``)."""

from vst_tpu_torch.ops.conv import (
    conv2d_nearest_up2,
    conv2d_polyphase_reflect,
    conv2d_reflect,
    polyphase_weights,
)
from vst_tpu_torch.ops.norm import instance_norm
from vst_tpu_torch.ops.pad import reflection_pad2d
from vst_tpu_torch.ops.resize import upsample_nearest
from vst_tpu_torch.ops.yuv import i420_to_rgb, rgb_to_i420

__all__ = [
    "conv2d_nearest_up2",
    "conv2d_polyphase_reflect",
    "conv2d_reflect",
    "i420_to_rgb",
    "instance_norm",
    "polyphase_weights",
    "reflection_pad2d",
    "rgb_to_i420",
    "upsample_nearest",
]
