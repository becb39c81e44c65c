"""Host-side (numpy) flow transforms with torch-parity numerics.
Counterpart of ``vst_tpu/data/flow_np.py``.

Used by the datasets, which prepare masks and resizes on the host (the
reference computes them inside DataLoader workers); the device
equivalents live in ``vst_tpu_torch/ops/warp.py``.
"""

import functools

import numpy as np


@functools.lru_cache(maxsize=256)
def _linear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix of torch's
    ``F.interpolate(align_corners=False)``: half-pixel centers, clamped
    (src = max(0, (d + 0.5)·in/out − 0.5)).  A numpy copy of
    ``vst_tpu/ops/resize.py::_linear_matrix``."""
    scale = in_size / out_size
    d = np.arange(out_size, dtype=np.float64)
    src = (d + 0.5) * scale - 0.5
    src = np.maximum(src, 0.0)
    x0 = np.floor(src).astype(np.int64)
    x0 = np.minimum(x0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    w1 = src - x0
    w0 = 1.0 - w1
    m = np.zeros((out_size, in_size), dtype=np.float32)
    np.add.at(m, (d.astype(np.int64), x0), w0)
    np.add.at(m, (d.astype(np.int64), x1), w1)
    return m


def resize_bilinear_np(x: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """HWC (or HW) float array → torch F.interpolate(bilinear,
    align_corners=False) parity resize via the separable weight matrices."""
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    h, w = x.shape[:2]
    oh, ow = size
    if (h, w) != (oh, ow):
        mh = _linear_matrix(h, oh)
        mw = _linear_matrix(w, ow)
        x = np.einsum("ph,hwc->pwc", mh, x.astype(np.float32))
        x = np.einsum("qw,pwc->pqc", mw, x)
    out = x.astype(np.float32)
    return out[..., 0] if squeeze else out


def resize_flow_np(flow: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Resize an (H, W, 2) flow field and rescale displacement magnitudes.

    x displacements scale by W_new/W_old, y by H_new/H_old.  (The reference
    multiplies channel 0 by the H-ratio and channel 1 by the W-ratio —
    ReCoNet/datasets.py:130-134, a swap that is invisible at its standard
    960×540→640×360 uniform ratio; we use the correct per-axis scaling.)
    """
    h, w = flow.shape[:2]
    oh, ow = size
    out = resize_bilinear_np(flow, size)
    out[..., 0] *= ow / w
    out[..., 1] *= oh / h
    return out


def _grid_sample_bilinear_np(x: np.ndarray, fx: np.ndarray,
                             fy: np.ndarray) -> np.ndarray:
    """Sample HWC array at source pixel coords (zeros padding)."""
    h, w = x.shape[:2]
    x0 = np.floor(fx)
    y0 = np.floor(fy)
    wx = fx - x0
    wy = fy - y0
    out = np.zeros(fx.shape + (x.shape[2],), np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0.astype(np.int64) + dx
            yi = y0.astype(np.int64) + dy
            wgt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xc = np.clip(xi, 0, w - 1)
            yc = np.clip(yi, 0, h - 1)
            out += x[yc, xc] * (wgt * valid)[..., None]
    return out


def warp_np(x: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp HWC array by (H, W, 2) flow — reference ``warp``
    numerics (grid + flow, (dim-1) normalization, align_corners=False)."""
    h, w = x.shape[:2]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    nx = 2.0 * (gx + flow[..., 0]) / max(w - 1, 1) - 1.0
    ny = 2.0 * (gy + flow[..., 1]) / max(h - 1, 1) - 1.0
    fx = ((nx + 1) * w - 1) / 2
    fy = ((ny + 1) * h - 1) / 2
    return _grid_sample_bilinear_np(x, fx, fy)


def flow_warp_mask_np(flow01: np.ndarray, flow10: np.ndarray,
                      threshold: float = 2.0) -> np.ndarray:
    """(H, W) float mask — forward/backward consistency
    (RTNSTV/utilities.py:80-110 numerics)."""
    h, w = flow01.shape[:2]
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    grid = np.stack([gx, gy], axis=-1)
    target = grid + flow01.astype(np.float32)
    nx = 2.0 * (gx + flow10[..., 0]) / max(w - 1, 1) - 1.0
    ny = 2.0 * (gy + flow10[..., 1]) / max(h - 1, 1) - 1.0
    fx = ((nx + 1) * w - 1) / 2
    fy = ((ny + 1) * h - 1) / 2
    warped = _grid_sample_bilinear_np(target, fx, fy)
    err = np.abs(warped - grid).sum(axis=-1)
    return (err < threshold).astype(np.float32)


def visualize_flow(flow: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR flow visualization: angle → hue, magnitude →
    value over full saturation (ReCoNet/utilities.py:28-36, identical in
    RTNSTV).  ``flow``: (H, W, 2) with channels (fx, fy).  Requires cv2."""
    import cv2

    hsv = np.zeros((flow.shape[0], flow.shape[1], 3), dtype=np.uint8)
    hsv[..., 1] = 255
    mag, ang = cv2.cartToPolar(flow[..., 0].astype(np.float32),
                               flow[..., 1].astype(np.float32))
    hsv[..., 0] = ang * 180 / np.pi / 2
    hsv[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
