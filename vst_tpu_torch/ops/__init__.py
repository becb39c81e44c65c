"""NHWC image ops of the port (counterparts of ``vst_tpu/ops``)."""

from vst_tpu_torch.ops.conv import (
    conv2d,
    conv2d_nearest_up2,
    conv2d_polyphase_reflect,
    conv2d_reflect,
    max_pool2d,
    polyphase_weights,
)
from vst_tpu_torch.ops.features import feature_down_sample
from vst_tpu_torch.ops.image import vgg_normalize
from vst_tpu_torch.ops.norm import instance_norm
from vst_tpu_torch.ops.pad import reflection_pad2d
from vst_tpu_torch.ops.resize import resize_bilinear, upsample_nearest
from vst_tpu_torch.ops.yuv import i420_to_rgb, rgb_to_i420

__all__ = [
    "conv2d",
    "conv2d_nearest_up2",
    "conv2d_polyphase_reflect",
    "conv2d_reflect",
    "feature_down_sample",
    "i420_to_rgb",
    "instance_norm",
    "max_pool2d",
    "polyphase_weights",
    "reflection_pad2d",
    "resize_bilinear",
    "rgb_to_i420",
    "upsample_nearest",
    "vgg_normalize",
]
