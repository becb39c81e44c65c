"""ReCoNet stylization family as ``nn.Module``s: ReCoNet, ReCoNetSD1,
ReCoNetSD2.

Counterpart of ``vst_tpu/models/reconet.py`` (parity targets
ReCoNet/network.py:63-279).  ``state_dict`` keys equal the reference's
names (``conv1.conv2d.weight``, ``res1.in1.bias``, …) with OIHW conv
weights, so a reference ``.pth`` loads with ``strict=True``.  Forwards
take NHWC 0–255 input with 3·input_frame_num channels and return the
reference's tap tuples:

- ReCoNet:    (sd1_tap, res5_features, styled)
- ReCoNetSD1: (sd2_tap, sd_tap, features, styled)
- ReCoNetSD2: (sd_tap, features, styled)

Routing: every residual block runs as two K1 launches
(``kernels/res_block.py``) and both 9×9 layers as K2 launches over the
polyphase-packed input (``ops/conv.py::conv2d_polyphase_reflect``), on
the card always.  On CPU tensors the kernels' plain versions run.  The
stride-2 encoder convs and the upsample convs are ``F.conv2d``, as the
JAX package leaves them to XLA.
"""

import torch
import torch.nn as nn

from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.device import apply_precision, resolve_device
from vst_tpu_torch.kernels.res_block import residual_block_fused
from vst_tpu_torch.models.init import as_rng, conv_init, instance_norm_init
from vst_tpu_torch.ops.conv import (conv2d_nearest_up2,
                                    conv2d_polyphase_reflect, conv2d_reflect)
from vst_tpu_torch.ops.norm import instance_norm


def _hwio(w):
    return w.permute(2, 3, 1, 0).contiguous()


class ConvLayer(nn.Module):
    """Reflect-pad k//2 + conv (ReCoNet/network.py:63-75)."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, k, stride)

    def forward(self, x):
        c = self.conv2d
        if c.kernel_size[0] == 9 and c.stride[0] == 1:
            return conv2d_polyphase_reflect(x, c.weight, c.bias, factor=4)
        return conv2d_reflect(x, c.weight, c.bias, c.stride[0])


class ConvTanh(ConvLayer):
    """ConvLayer, then tanh(x/255)·150 + 127.5 (:78-85)."""

    def forward(self, x):
        return torch.tanh(super().forward(x) / 255.0) * 150.0 + 255.0 / 2.0


class ConvInstRelu(ConvLayer):
    """ConvLayer + InstanceNorm(affine) + ReLU (:88-98)."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__(cin, cout, k, stride)
        self.instance = nn.InstanceNorm2d(cout, affine=True)

    def _norm_relu(self, x):
        return torch.relu(instance_norm(x, self.instance.weight,
                                        self.instance.bias))

    def forward(self, x):
        return self._norm_relu(super().forward(x))


class UpsampleConvInstRelu(ConvInstRelu):
    """Nearest ×2 upsample + ConvLayer + IN + ReLU (:101-133)."""

    def forward(self, x):
        c = self.conv2d
        return self._norm_relu(conv2d_nearest_up2(x, c.weight, c.bias))


class ResidualBlock(nn.Module):
    """2×(conv+IN), ReLU after the first, additive skip (:136-150); two K1
    launches and a float32 tail."""

    def __init__(self, ch):
        super().__init__()
        self.conv1 = ConvLayer(ch, ch, 3)
        self.in1 = nn.InstanceNorm2d(ch, affine=True)
        self.conv2 = ConvLayer(ch, ch, 3)
        self.in2 = nn.InstanceNorm2d(ch, affine=True)

    def forward(self, x):
        c1, c2 = self.conv1.conv2d, self.conv2.conv2d
        return residual_block_fused(
            x, _hwio(c1.weight), c1.bias, self.in1.weight, self.in1.bias,
            _hwio(c2.weight), c2.bias, self.in2.weight, self.in2.bias)


_LAYER = {"conv": ConvInstRelu, "up": UpsampleConvInstRelu,
          "tanh": ConvTanh}


class _ReCoNetFamily(nn.Module):
    """Layers built from ``spec`` in order; ``TAPS`` names the layers whose
    outputs precede the styled frame in the returned tuple."""

    TAPS: tuple = ()

    @staticmethod
    def spec(input_frame_num):
        raise NotImplementedError

    def __init__(self, input_frame_num: int = 1):
        super().__init__()
        self.input_frame_num = input_frame_num
        for kind, name, cin, cout, k, stride in self.spec(input_frame_num):
            if kind == "res":
                self.add_module(name, ResidualBlock(cout))
            else:
                self.add_module(name, _LAYER[kind](cin, cout, k, stride))

    def forward(self, x):
        """x: (N, H, W, 3·input_frame_num) 0–255 in the parameters' dtype."""
        apply_precision(x.dtype)
        taps = {}
        for name, layer in self.named_children():
            x = layer(x)
            if name in self.TAPS:
                taps[name] = x
        return tuple(taps[t] for t in self.TAPS) + (x,)


def _res(names, ch):
    return [("res", n, ch, ch, 3, 1) for n in names]


class ReCoNet(_ReCoNetFamily):
    TAPS = ("deconv1", "res5")

    @staticmethod
    def spec(input_frame_num):
        return [("conv", "conv1", 3 * input_frame_num, 48, 9, 1),
                ("conv", "conv2", 48, 96, 3, 2),
                ("conv", "conv3", 96, 192, 3, 2),
                *_res([f"res{i}" for i in range(1, 6)], 192),
                ("up", "deconv1", 192, 96, 3, 1),
                ("up", "deconv2", 96, 48, 3, 1),
                ("tanh", "deconv3", 48, 3, 9, 1)]


class ReCoNetSD1(_ReCoNetFamily):
    TAPS = ("conv3_sd", "deconv1_sd", "res5_sd")

    @staticmethod
    def spec(input_frame_num):
        return [("conv", "conv1", 3 * input_frame_num, 32, 9, 1),
                ("conv", "conv2", 32, 64, 3, 2),
                ("conv", "conv3_sd", 64, 64, 3, 2),
                *_res([f"res{i}_sd" for i in range(1, 6)], 64),
                ("up", "deconv1_sd", 64, 64, 3, 1),
                ("up", "deconv2", 64, 32, 3, 1),
                ("tanh", "deconv3", 32, 3, 9, 1)]


class ReCoNetSD2(_ReCoNetFamily):
    TAPS = ("conv3_sd2", "res5_sd")

    @staticmethod
    def spec(input_frame_num):
        return [("conv", "conv1_sd2", 3 * input_frame_num, 16, 9, 1),
                ("conv", "conv2_sd2", 16, 32, 3, 2),
                ("conv", "conv3_sd2", 32, 64, 3, 2),
                *_res([f"res{i}_sd" for i in range(1, 6)], 64),
                ("up", "deconv1_sd2", 64, 32, 3, 1),
                ("up", "deconv2_sd2", 32, 16, 3, 1),
                ("tanh", "deconv3_sd2", 16, 3, 9, 1)]


FAMILIES = {"reconet": ReCoNet, "sd1": ReCoNetSD1, "sd2": ReCoNetSD2}


def init_params(family: str, seed, input_frame_num: int = 1) -> dict:
    """numpy HWIO parameters drawn exactly as the JAX package's
    ``init_reconet`` / ``_sd1`` / ``_sd2`` draw them (same order, same keys)."""
    rng = as_rng(seed)
    params = {}
    for kind, name, cin, cout, k, _ in FAMILIES[family].spec(input_frame_num):
        if kind == "res":
            w1, b1 = conv_init(rng, k, cout, cout)
            w2, b2 = conv_init(rng, k, cout, cout)
            s1, sb1 = instance_norm_init(cout)
            s2, sb2 = instance_norm_init(cout)
            params.update({
                f"{name}.conv1.conv2d.weight": w1,
                f"{name}.conv1.conv2d.bias": b1,
                f"{name}.in1.weight": s1, f"{name}.in1.bias": sb1,
                f"{name}.conv2.conv2d.weight": w2,
                f"{name}.conv2.conv2d.bias": b2,
                f"{name}.in2.weight": s2, f"{name}.in2.bias": sb2})
            continue
        w, b = conv_init(rng, k, cin, cout)
        params[f"{name}.conv2d.weight"] = w
        params[f"{name}.conv2d.bias"] = b
        if kind != "tanh":
            s, sb = instance_norm_init(cout)
            params[f"{name}.instance.weight"] = s
            params[f"{name}.instance.bias"] = sb
    return params


def build(family: str, state: dict, input_frame_num: int = 1,
          device="cuda", dtype: torch.dtype = torch.float32) -> nn.Module:
    """A ``family`` model holding ``state`` (reference ``state_dict`` layout,
    loaded strictly), on ``device`` at ``dtype``."""
    dev = resolve_device(device)
    model = FAMILIES[family](input_frame_num)
    model.load_state_dict(state, strict=True)
    return model.to(device=dev, dtype=dtype).eval()


def init_reconet(seed, input_frame_num: int = 1, device="cuda",
                 dtype: torch.dtype = torch.float32) -> ReCoNet:
    """A ReCoNet holding the JAX package's ``init_reconet(seed)``."""
    return _seeded("reconet", seed, input_frame_num, device, dtype)


def init_reconet_sd1(seed, input_frame_num: int = 1, device="cuda",
                     dtype: torch.dtype = torch.float32) -> ReCoNetSD1:
    """A ReCoNetSD1 holding the JAX package's ``init_reconet_sd1(seed)``."""
    return _seeded("sd1", seed, input_frame_num, device, dtype)


def init_reconet_sd2(seed, input_frame_num: int = 1, device="cuda",
                     dtype: torch.dtype = torch.float32) -> ReCoNetSD2:
    """A ReCoNetSD2 holding the JAX package's ``init_reconet_sd2(seed)``."""
    return _seeded("sd2", seed, input_frame_num, device, dtype)


def _seeded(family, seed, input_frame_num, device, dtype):
    dev = resolve_device(device)
    state = params_from_jax(init_params(family, seed, input_frame_num))
    return build(family, state, input_frame_num, dev, dtype)
