"""Plain RTNSTV (Huang et al., CVPR 2017; the reference's
RTNSTV/network.py:10-91, ``StylizingNetwork``), float32, NCHW, over a flat
state dict in the reference's key layout (``conv1.conv.weight``,
``res1.conv2.norm.bias``, ``deconv1.deconv.weight`` in (I, O, kh, kw),
``conv4.conv.weight``).

Each layer is ``F.pad(..., mode="reflect")`` of k // 2, the conv, an affine
``F.instance_norm`` (eps 1e-5) and the activation; a residual block adds
its input; a decoder layer is ``F.conv_transpose2d`` (stride 2, padding 1,
output_padding 1), the norm and relu; the head is tanh, then
(x + 1) / 2 · 255.

Departures from the reference code: the input is 0-255 NCHW here and
NHWC uint8 in ``serve`` (the stream's frames); the residual blocks' zero
padding of the input to wider outputs (network.py:40-43) is left out,
since every block of this network is 48 → 48; ``serve`` clamps to 0-255
and truncates to uint8, the served path's conversion."""

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import Exact, make_weights

RES = [f"res{i}" for i in range(1, 6)]


def _encoder(cfg):
    e = cfg["encoder"]
    cin = [3] + e["widths"][:-1]
    return [(f"conv{i + 1}", ci, co, s) for i, (ci, co, s) in enumerate(
        zip(cin, e["widths"], e["strides"]))]


def _decoder(cfg):
    d = cfg["decoder"]["widths"]
    return [(f"deconv{i + 1}", ci, co) for i, (ci, co) in enumerate(
        zip(d[:-1], d[1:]))]


def stylizer_specs(cfg):
    """(key, shape, std, mean) of the seeded stylizer: convs and transposed
    convs N(0, 2/fan_in) with fan_in = Cin·k² (an instance norm follows
    each), biases N(0, 1/fan_in), instance norms γ ~ 1 ± 0.1, β ~ ±0.1.
    No head gain: the head's instance norm feeds tanh."""
    k, wd = 3, cfg["residual_width"]
    layers = [(name, "conv", ci, co) for name, ci, co, _ in _encoder(cfg)]
    layers += [(f"{r}.{c}", "conv", wd, wd) for r in RES[:cfg[
        "residual_blocks"]] for c in ("conv1", "conv2")]
    layers += [(name, "deconv", ci, co) for name, ci, co in _decoder(cfg)]
    h = cfg["head"]
    layers.append(("conv4", "conv", h["in"], h["out"]))
    specs = []
    for name, kind, cin, cout in layers:
        fan = cin * k * k
        shape = (cout, cin, k, k) if kind == "conv" else (cin, cout, k, k)
        specs += [(f"{name}.{kind}.weight", shape, math.sqrt(2 / fan), 0.0),
                  (f"{name}.{kind}.bias", (cout,), 1 / math.sqrt(fan), 0.0),
                  (f"{name}.norm.weight", (cout,), 0.1, 1.0),
                  (f"{name}.norm.bias", (cout,), 0.1, 0.0)]
    return specs


def stylizer_weights(cfg, seed, device):
    return make_weights(stylizer_specs(cfg), seed, device)


# ------------------------------------------------------------ forward

def _inorm(s, pre, x):
    return F.instance_norm(x, weight=s[pre + ".norm.weight"],
                           bias=s[pre + ".norm.bias"], eps=1e-5)


def _conv_block(s, pre, x, stride, act, q):
    x = F.pad(x, [1] * 4, mode="reflect")
    x = F.conv2d(q(x), q(s[pre + ".conv.weight"]), s[pre + ".conv.bias"],
                 stride=stride)
    x = _inorm(s, pre, x)
    return act(x) if act is not None else x


def _res_block(s, pre, x, q):
    out = _conv_block(s, pre + ".conv1", x, 1, F.relu, q)
    return _conv_block(s, pre + ".conv2", out, 1, None, q) + x


def _deconv_block(s, pre, x, q):
    x = F.conv_transpose2d(q(x), q(s[pre + ".deconv.weight"]),
                           s[pre + ".deconv.bias"], stride=2, padding=1,
                           output_padding=1)
    return F.relu(_inorm(s, pre, x))


def forward(s, x, q=Exact()):
    """x (N, 3, H, W) 0-255 -> styled (N, 3, H, W), 0-255 up to tanh's
    range."""
    for name, stride in (("conv1", 1), ("conv2", 2), ("conv3", 2)):
        x = _conv_block(s, name, x, stride, F.relu, q)
    for r in RES:
        x = _res_block(s, r, x, q)
    for name in ("deconv1", "deconv2"):
        x = _deconv_block(s, name, x, q)
    x = _conv_block(s, "conv4", x, 1, torch.tanh, q)
    return (x + 1.0) / 2.0 * 255.0


def serve(s, x_u8_nhwc, q=Exact()):
    """The served frames: uint8 NHWC in, clamped and truncated uint8 NHWC
    out, float32 inside."""
    x = x_u8_nhwc.permute(0, 3, 1, 2).float()
    y = forward(s, x, q).clamp(0, 255)
    return y.to(torch.uint8).permute(0, 2, 3, 1)

