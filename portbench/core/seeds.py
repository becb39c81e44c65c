"""Seeds of the independent streams of one run, derived from ``--seed``."""

import numpy as np

STREAMS = ("weights", "vgg", "traffic", "style", "sample", "loader")


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream``; any whole ``seed`` (negative or past
    64 bits too) gives its own."""
    key = [int(seed) % (1 << 64), STREAMS.index(stream)]
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
               >> np.uint64(1))
