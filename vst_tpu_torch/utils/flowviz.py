"""Optical-flow visualization (parity: ``visualize_flow``,
ReCoNet/utilities.py:28-37 — HSV wheel: hue=direction, value=magnitude).

Counterpart of ``vst_tpu/utils/flowviz.py``, a numpy copy giving RGB
(``data/flow_np.py::visualize_flow`` is the BGR, cv2-based one): angle→
hue, min-max-normalized magnitude→value, saturation=1.
"""

import numpy as np


def _hsv_to_rgb(h, s, v):
    """h in [0, 1), s/v in [0, 1], arrays → uint8 RGB."""
    i = np.floor(h * 6.0).astype(np.int32) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    r = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [v, q, p, p, t, v])
    g = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [t, v, v, q, p, p])
    b = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [p, p, t, v, v, q])
    return (np.stack([r, g, b], axis=-1) * 255.0).astype(np.uint8)


def visualize_flow(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 RGB visualization."""
    fx = np.asarray(flow[..., 0], np.float32)
    fy = np.asarray(flow[..., 1], np.float32)
    mag = np.sqrt(fx * fx + fy * fy)
    ang = np.arctan2(fy, fx)            # [-pi, pi]
    hue = (ang % (2 * np.pi)) / (2 * np.pi)
    rng = mag.max() - mag.min()
    val = (mag - mag.min()) / rng if rng > 0 else np.zeros_like(mag)
    return _hsv_to_rgb(hue, np.ones_like(hue), val)
