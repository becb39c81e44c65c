"""The AdaAttN datasets' protocol on seeded data (copied from
``chip_smoke.py``'s ``SyntheticPairs``): ``count`` HWC float32 0-255 arrays
of integers per item, drawn from ``default_rng((seed, epoch, idx))`` as
``CocoWikiArt`` draws its crops, and ``set_epoch``, so that every epoch
gives rows of its own."""

import numpy as np


class SyntheticPairs:
    def __init__(self, n, size, seed, count=2):
        self.n, self.size, self.seed, self.count = n, tuple(size), seed, count
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, self._epoch, int(idx)))
        return tuple(rng.integers(0, 256, (*self.size, 3)).astype(np.float32)
                     for _ in range(self.count))
