"""On-device RGB → I420 (YUV 4:2:0) packing for the streaming wire.

Counterpart of ``vst_tpu/ops/yuv.py``: int32 fixed-point studio-swing
BT.601 with OpenCV's constants and rounding, top-left 2×2 chroma
sampling, so the packed frame is bit-exact with cv2's
``COLOR_RGB2YUV_I420`` and the host rebuilds RGB with one cvtColor.
The device→host copy carries 1.5 B/px instead of 3.
"""

import numpy as np
import torch

# OpenCV ITU-R BT.601 fixed-point constants (imgproc color_yuv), shift 20.
_S = 20
_HALF = 1 << (_S - 1)
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448  # CRV == CBU


def rgb_to_i420(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB (uint8, or float in [0, 256), truncated like the
    uint8 wire cast) → (B, H·3/2, W) uint8 in cv2's I420 plane layout.
    H and W must be even."""
    b, h, w, _ = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even H, W; got {(h, w)}")
    rgb = x.to(torch.int32)
    r, g, bl = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (_CRY * r + _CGY * g + _CBY * bl + _HALF + (16 << _S)) >> _S
    rs, gs, bs = r[:, ::2, ::2], g[:, ::2, ::2], bl[:, ::2, ::2]
    off = _HALF + (128 << _S)
    u = (_CRU * rs + _CGU * gs + _CBU * bs + off) >> _S
    v = (_CBU * rs + _CGV * gs + _CBV * bs + off) >> _S
    flat = torch.cat(
        [y.reshape(b, -1), u.reshape(b, -1), v.reshape(b, -1)], dim=1)
    return flat.reshape(b, h * 3 // 2, w).to(torch.uint8)


def i420_to_rgb(frame: np.ndarray, order: str = "rgb") -> np.ndarray:
    """Host-side inverse for one packed (H·3/2, W) uint8 frame via cv2."""
    import cv2

    code = cv2.COLOR_YUV2RGB_I420 if order == "rgb" else cv2.COLOR_YUV2BGR_I420
    return cv2.cvtColor(np.ascontiguousarray(frame), code)
