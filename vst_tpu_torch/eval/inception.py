"""InceptionV3 feature-block extractor for SIFID.

Counterpart of ``vst_tpu/eval/inception.py`` (parity:
AdaAttN/SIFID/inception.py:6-148, which slices torchvision's inception_v3
into 4 blocks):

- block 0 (64 ch):   Conv2d_1a_3x3, Conv2d_2a_3x3, Conv2d_2b_3x3
- block 1 (192 ch):  maxpool3s2, Conv2d_3b_1x1, Conv2d_4a_3x3
- block 2 (768 ch):  maxpool3s2, Mixed_5b..5d (InceptionA),
                     Mixed_6a (InceptionB), Mixed_6b..6e (InceptionC)
- block 3 (2048 ch): Mixed_7a (InceptionD), Mixed_7b/7c (InceptionE)

Input: (N, H, W, 3) RGB in [0, 1], scaled to [-1, 1] inside
(normalize_input, SIFID/inception.py:139-140).

Parameters: a dict of tensors keyed by the torchvision state_dict names
("Mixed_5b.branch5x5_1.conv.weight", "...bn.running_mean", …), conv
weights OIHW: a torchvision/pytorch-fid checkpoint as it is, or the JAX
package's through ``compat.params_from_jax``.  BatchNorm runs in
inference mode with eps=1e-3.  The average pool of the branch_pool
branches counts the zero padding (``count_include_pad=True``, a sum over
the 3×3 window / 9) as the JAX package computes it, in every block;
pytorch-fid's own FID blocks (FIDInceptionA/C/E) exclude the padding
instead, and the port follows the JAX package.  Runs in float32 with
TF32 off on the parameters' device.
"""

import numpy as np
import torch
import torch.nn.functional as F

from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.device import apply_precision, resolve_device
from vst_tpu_torch.models.init import as_rng

BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}

# (name, in_ch, out_ch, (kh, kw), stride, (ph, pw)) for every BasicConv2d.
_STEM = [
    ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
    ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
]


def _basic_conv(params, name, x, stride=1, padding=(0, 0)):
    """BasicConv2d: conv (no bias) + BatchNorm(eps=1e-3) + ReLU, NCHW."""
    out = F.conv2d(x, params[f"{name}.conv.weight"], None, stride=stride,
                   padding=padding)
    shape = (1, -1, 1, 1)
    mean = params[f"{name}.bn.running_mean"].float().reshape(shape)
    var = params[f"{name}.bn.running_var"].float().reshape(shape)
    scale = params[f"{name}.bn.weight"].float().reshape(shape)
    bias = params[f"{name}.bn.bias"].float().reshape(shape)
    out = (out - mean) * (scale * torch.rsqrt(var + 1e-3)) + bias
    return torch.relu(out)


def _avg_pool3(x):
    """F.avg_pool2d(x, 3, stride=1, padding=1), count_include_pad=True."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool3s2(x):
    return F.max_pool2d(x, 3, 2)


def _inception_a(params, p, x):
    b1 = _basic_conv(params, f"{p}.branch1x1", x)
    b5 = _basic_conv(params, f"{p}.branch5x5_1", x)
    b5 = _basic_conv(params, f"{p}.branch5x5_2", b5, padding=(2, 2))
    b3 = _basic_conv(params, f"{p}.branch3x3dbl_1", x)
    b3 = _basic_conv(params, f"{p}.branch3x3dbl_2", b3, padding=(1, 1))
    b3 = _basic_conv(params, f"{p}.branch3x3dbl_3", b3, padding=(1, 1))
    bp = _basic_conv(params, f"{p}.branch_pool", _avg_pool3(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(params, p, x):
    b3 = _basic_conv(params, f"{p}.branch3x3", x, stride=2)
    bd = _basic_conv(params, f"{p}.branch3x3dbl_1", x)
    bd = _basic_conv(params, f"{p}.branch3x3dbl_2", bd, padding=(1, 1))
    bd = _basic_conv(params, f"{p}.branch3x3dbl_3", bd, stride=2)
    return torch.cat([b3, bd, _max_pool3s2(x)], dim=1)


def _inception_c(params, p, x):
    b1 = _basic_conv(params, f"{p}.branch1x1", x)
    b7 = _basic_conv(params, f"{p}.branch7x7_1", x)
    b7 = _basic_conv(params, f"{p}.branch7x7_2", b7, padding=(0, 3))
    b7 = _basic_conv(params, f"{p}.branch7x7_3", b7, padding=(3, 0))
    bd = _basic_conv(params, f"{p}.branch7x7dbl_1", x)
    bd = _basic_conv(params, f"{p}.branch7x7dbl_2", bd, padding=(3, 0))
    bd = _basic_conv(params, f"{p}.branch7x7dbl_3", bd, padding=(0, 3))
    bd = _basic_conv(params, f"{p}.branch7x7dbl_4", bd, padding=(3, 0))
    bd = _basic_conv(params, f"{p}.branch7x7dbl_5", bd, padding=(0, 3))
    bp = _basic_conv(params, f"{p}.branch_pool", _avg_pool3(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(params, p, x):
    b3 = _basic_conv(params, f"{p}.branch3x3_1", x)
    b3 = _basic_conv(params, f"{p}.branch3x3_2", b3, stride=2)
    b7 = _basic_conv(params, f"{p}.branch7x7x3_1", x)
    b7 = _basic_conv(params, f"{p}.branch7x7x3_2", b7, padding=(0, 3))
    b7 = _basic_conv(params, f"{p}.branch7x7x3_3", b7, padding=(3, 0))
    b7 = _basic_conv(params, f"{p}.branch7x7x3_4", b7, stride=2)
    return torch.cat([b3, b7, _max_pool3s2(x)], dim=1)


def _inception_e(params, p, x):
    b1 = _basic_conv(params, f"{p}.branch1x1", x)
    b3 = _basic_conv(params, f"{p}.branch3x3_1", x)
    b3 = torch.cat([
        _basic_conv(params, f"{p}.branch3x3_2a", b3, padding=(0, 1)),
        _basic_conv(params, f"{p}.branch3x3_2b", b3, padding=(1, 0)),
    ], dim=1)
    bd = _basic_conv(params, f"{p}.branch3x3dbl_1", x)
    bd = _basic_conv(params, f"{p}.branch3x3dbl_2", bd, padding=(1, 1))
    bd = torch.cat([
        _basic_conv(params, f"{p}.branch3x3dbl_3a", bd, padding=(0, 1)),
        _basic_conv(params, f"{p}.branch3x3dbl_3b", bd, padding=(1, 0)),
    ], dim=1)
    bp = _basic_conv(params, f"{p}.branch_pool", _avg_pool3(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


@torch.inference_mode()
def inception_blocks(params, x, last_block: int = 3):
    """Run blocks 0..last_block; returns the list of block outputs (NHWC).

    x: (N, H, W, 3) in [0, 1], numpy or a tensor, taken to the
    parameters' device.
    """
    apply_precision(torch.float32)
    dev = next(iter(params.values())).device
    x = torch.as_tensor(x).to(dev, torch.float32)
    x = (2.0 * x - 1.0).permute(0, 3, 1, 2)
    outs = []
    x = _basic_conv(params, "Conv2d_1a_3x3", x, stride=2)
    x = _basic_conv(params, "Conv2d_2a_3x3", x)
    x = _basic_conv(params, "Conv2d_2b_3x3", x, padding=(1, 1))
    outs.append(x)
    if last_block >= 1:
        x = _max_pool3s2(x)
        x = _basic_conv(params, "Conv2d_3b_1x1", x)
        x = _basic_conv(params, "Conv2d_4a_3x3", x)
        outs.append(x)
    if last_block >= 2:
        x = _max_pool3s2(x)
        for p in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = _inception_a(params, p, x)
        x = _inception_b(params, "Mixed_6a", x)
        for p in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = _inception_c(params, p, x)
        outs.append(x)
    if last_block >= 3:
        x = _inception_d(params, "Mixed_7a", x)
        x = _inception_e(params, "Mixed_7b", x)
        x = _inception_e(params, "Mixed_7c", x)
        outs.append(x)
    return [o.permute(0, 2, 3, 1) for o in outs]


# -------------------------------------------------------------- structure

def _basic_conv_specs():
    """All (name, in, out, (kh, kw)) BasicConv2d layers of the network."""
    specs = [(n, i, o, k) for n, i, o, k, _, _ in _STEM]

    def a(p, cin, pool):
        return [
            (f"{p}.branch1x1", cin, 64, (1, 1)),
            (f"{p}.branch5x5_1", cin, 48, (1, 1)),
            (f"{p}.branch5x5_2", 48, 64, (5, 5)),
            (f"{p}.branch3x3dbl_1", cin, 64, (1, 1)),
            (f"{p}.branch3x3dbl_2", 64, 96, (3, 3)),
            (f"{p}.branch3x3dbl_3", 96, 96, (3, 3)),
            (f"{p}.branch_pool", cin, pool, (1, 1)),
        ]

    def b(p, cin):
        return [
            (f"{p}.branch3x3", cin, 384, (3, 3)),
            (f"{p}.branch3x3dbl_1", cin, 64, (1, 1)),
            (f"{p}.branch3x3dbl_2", 64, 96, (3, 3)),
            (f"{p}.branch3x3dbl_3", 96, 96, (3, 3)),
        ]

    def c(p, cin, c7):
        return [
            (f"{p}.branch1x1", cin, 192, (1, 1)),
            (f"{p}.branch7x7_1", cin, c7, (1, 1)),
            (f"{p}.branch7x7_2", c7, c7, (1, 7)),
            (f"{p}.branch7x7_3", c7, 192, (7, 1)),
            (f"{p}.branch7x7dbl_1", cin, c7, (1, 1)),
            (f"{p}.branch7x7dbl_2", c7, c7, (7, 1)),
            (f"{p}.branch7x7dbl_3", c7, c7, (1, 7)),
            (f"{p}.branch7x7dbl_4", c7, c7, (7, 1)),
            (f"{p}.branch7x7dbl_5", c7, 192, (1, 7)),
            (f"{p}.branch_pool", cin, 192, (1, 1)),
        ]

    def d(p, cin):
        return [
            (f"{p}.branch3x3_1", cin, 192, (1, 1)),
            (f"{p}.branch3x3_2", 192, 320, (3, 3)),
            (f"{p}.branch7x7x3_1", cin, 192, (1, 1)),
            (f"{p}.branch7x7x3_2", 192, 192, (1, 7)),
            (f"{p}.branch7x7x3_3", 192, 192, (7, 1)),
            (f"{p}.branch7x7x3_4", 192, 192, (3, 3)),
        ]

    def e(p, cin):
        return [
            (f"{p}.branch1x1", cin, 320, (1, 1)),
            (f"{p}.branch3x3_1", cin, 384, (1, 1)),
            (f"{p}.branch3x3_2a", 384, 384, (1, 3)),
            (f"{p}.branch3x3_2b", 384, 384, (3, 1)),
            (f"{p}.branch3x3dbl_1", cin, 448, (1, 1)),
            (f"{p}.branch3x3dbl_2", 448, 384, (3, 3)),
            (f"{p}.branch3x3dbl_3a", 384, 384, (1, 3)),
            (f"{p}.branch3x3dbl_3b", 384, 384, (3, 1)),
            (f"{p}.branch_pool", cin, 192, (1, 1)),
        ]

    specs += a("Mixed_5b", 192, 32) + a("Mixed_5c", 256, 64) + a("Mixed_5d", 288, 64)
    specs += b("Mixed_6a", 288)
    for p, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                  ("Mixed_6e", 192)):
        specs += c(p, 768, c7)
    specs += d("Mixed_7a", 768)
    specs += e("Mixed_7b", 1280) + e("Mixed_7c", 2048)
    return specs


def init_inception_numpy(seed=0) -> dict:
    """The JAX package's ``init_inception(seed)``: numpy, HWIO, the same
    draws in the same order."""
    rng = as_rng(seed)
    params = {}
    for name, cin, cout, (kh, kw) in _basic_conv_specs():
        fan_in = cin * kh * kw
        bound = 1.0 / np.sqrt(fan_in)
        params[f"{name}.conv.weight"] = rng.uniform(
            -bound, bound, (kh, kw, cin, cout)).astype(np.float32)
        params[f"{name}.bn.weight"] = np.abs(
            rng.standard_normal(cout)).astype(np.float32) + 0.5
        params[f"{name}.bn.bias"] = (rng.standard_normal(cout) * 0.1).astype(np.float32)
        params[f"{name}.bn.running_mean"] = (
            rng.standard_normal(cout) * 0.1).astype(np.float32)
        params[f"{name}.bn.running_var"] = np.abs(
            rng.standard_normal(cout)).astype(np.float32) + 0.5
    return params


def init_inception(seed=0, device="cuda") -> dict:
    """Random-init full parameter dict (tests / smoke runs; real use loads
    the torchvision checkpoint): the JAX package's ``init_inception(seed)``
    in torch layout, on ``device``."""
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in
            params_from_jax(init_inception_numpy(seed)).items()}
