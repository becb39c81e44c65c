"""Batch stylization with ReCoNet-family models.

Counterpart of ``vst_tpu/infer/image.py`` (``stylize_reconet``,
``_finish``; parity: ReCoNet/inference/infer.py).
"""

import numpy as np
import torch

from vst_tpu_torch.ops.yuv import rgb_to_i420


def _finish(styled, uint8_out, wire="rgb"):
    """Clamp to 0–255, then optionally the truncating uint8 cast (the
    reference's numpy conversion, ReCoNet/utilities.py:217-219) or, with
    ``wire="i420"``, YUV 4:2:0 packing on the device (1.5 B/px)."""
    styled = torch.clamp(styled, 0, 255)
    if wire == "i420":
        return rgb_to_i420(styled)
    return styled.to(torch.uint8) if uint8_out else styled


@torch.inference_mode()
def stylize_reconet(model, x, uint8_out: bool = False, wire: str = "rgb"):
    """x: (N, H, W, 3·frames) 0–255, uint8 or float, numpy or tensor →
    clamped styled frames on the model's device.

    The input is copied to the model's device (without blocking when it
    is pinned host memory) and cast there to the parameters' dtype, so a
    host can ship raw uint8 frames."""
    if wire not in ("rgb", "i420"):
        raise ValueError(f"wire must be 'rgb' or 'i420', got {wire!r}")
    p = next(model.parameters())
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    x = x.to(p.device, non_blocking=True).to(p.dtype)
    return _finish(model(x)[-1], uint8_out, wire)
