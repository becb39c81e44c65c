"""Reflection padding (NHWC).  Counterpart of ``vst_tpu/ops/pad.py``."""

import torch
import torch.nn.functional as F

from vst_tpu_torch.utils.profiling import span


def reflection_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad H and W of an NHWC tensor by ``pad`` pixels (edge pixel
    not repeated, as torch's ReflectionPad2d).  Returns a channels-last
    NHWC tensor.  Runs in the span "vst::reflection_pad2d"
    (``utils/profiling.py::span``)."""
    if pad == 0:
        return x
    with span("vst::reflection_pad2d"):
        y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
        return y.permute(0, 2, 3, 1).contiguous()
