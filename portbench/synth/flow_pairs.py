"""The SceneFlow datasets' protocol on seeded data (copied from
``chip_smoke.py``'s ``SyntheticFlowPairs``): (img1, img2, flow, mask) per
item, two 0-255 integer frames, a flow of std 2 pixels and a mask of ones
at 80% of the pixels, from ``default_rng((seed, epoch, idx))`` (the epoch
added here, so that every epoch gives rows of its own)."""

import numpy as np


class SyntheticFlowPairs:
    def __init__(self, n, size, seed):
        self.n, self.size, self.seed = n, tuple(size), seed
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, self._epoch, int(idx)))
        h, w = self.size
        return (rng.integers(0, 256, (h, w, 3)).astype(np.float32),
                rng.integers(0, 256, (h, w, 3)).astype(np.float32),
                (rng.standard_normal((h, w, 2)) * 2).astype(np.float32),
                (rng.random((h, w)) > 0.2).astype(np.float32))
