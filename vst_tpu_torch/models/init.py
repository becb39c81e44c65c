"""Parameter initialization matching torch layer defaults, drawn with numpy.

Counterpart of ``vst_tpu/models/init.py``: the same numpy draws in the
same order, so a seed gives the JAX package's parameters bit for bit.
torch.nn.Conv2d's kaiming_uniform_(a=√5) reduces to U(−1/√fan_in,
1/√fan_in) for weights and biases; InstanceNorm2d's affine parameters
start at weight 1, bias 0.  Conv weights come out HWIO, as in JAX.
"""

import math

import numpy as np


def as_rng(key) -> np.random.Generator:
    """A numpy Generator from an int seed or a Generator."""
    if isinstance(key, np.random.Generator):
        return key
    if isinstance(key, (int, np.integer)):
        return np.random.default_rng(int(key))
    raise TypeError(f"seed must be an int or a numpy Generator, got {key!r}")


def conv_init(key, k: int, in_ch: int, out_ch: int, dtype=np.float32):
    """HWIO conv weight + bias with torch Conv2d default init."""
    rng = as_rng(key)
    bound = 1.0 / math.sqrt(in_ch * k * k)
    w = rng.uniform(-bound, bound, (k, k, in_ch, out_ch)).astype(dtype)
    b = rng.uniform(-bound, bound, (out_ch,)).astype(dtype)
    return w, b


def conv_transpose_init(key, k: int, in_ch: int, out_ch: int,
                        dtype=np.float32):
    """HWIO (flipped) transposed-conv weight + bias with torch
    ConvTranspose2d's default init, whose fan_in comes from dim 1 of its
    (in, out, kh, kw) weight: out_ch·k·k."""
    rng = as_rng(key)
    bound = 1.0 / math.sqrt(out_ch * k * k)
    w = rng.uniform(-bound, bound, (k, k, in_ch, out_ch)).astype(dtype)
    b = rng.uniform(-bound, bound, (out_ch,)).astype(dtype)
    return w, b


def instance_norm_init(ch: int, dtype=np.float32):
    return np.ones((ch,), dtype), np.zeros((ch,), dtype)
