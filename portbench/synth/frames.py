"""Seeded uint8 frames, as ``chip_smoke.py`` [5] draws its clips
(``rng.integers(0, 256, (n, H, W, 3)).astype(np.uint8)``): a pool made in
set-up and cycled by the source."""

import numpy as np


def clip(seed, n, hw):
    """(n, H, W, 3) uint8 frames from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
