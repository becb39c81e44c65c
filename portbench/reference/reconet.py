"""Plain ReCoNet (Gao et al., ACCV 2018; the reference's ReCoNet/network.py)
and its flow trainer's loss (ReCoNet/train_single/train_candy.py:63-152),
float32, NCHW, over a flat state dict in the reference's key layout.
Frozen from the port's test oracles (tests/torch_refs.py,
tests/torch_train_refs.py)."""

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import (VGG16_CFG, VGG16_TAPS_RECONET,
                                        Exact, he, make_weights,
                                        vgg_features, vgg_normalize,
                                        vgg_specs)

RES = [f"res{i}" for i in range(1, 6)]


def stylizer_specs(cfg):
    """(key, OIHW shape, std, mean) of the seeded stylizer: convs
    N(0, 2/fan_in) (an instance norm follows each), instance norms γ ~ 1 ±
    0.1, β ~ ±0.1, and the head scaled so that its pre-tanh output has the
    spread of a trained model's (``assumed.head_gain``)."""
    w = cfg["widths"]
    c1, c2, c3 = w["conv1"], w["conv2"], w["conv3"]
    layers = [("conv1", 3 * cfg["input_frame_num"], c1, 9, "instance"),
              ("conv2", c1, c2, 3, "instance"),
              ("conv3", c2, c3, 3, "instance")]
    for r in RES[:cfg["residual_blocks"]]:
        layers += [(f"{r}.conv1", c3, c3, 3, f"{r}.in1"),
                   (f"{r}.conv2", c3, c3, 3, f"{r}.in2")]
    layers += [("deconv1", c3, c2, 3, "instance"),
               ("deconv2", c2, c1, 3, "instance"),
               ("deconv3", c1, 3, 9, None)]
    specs = []
    for name, cin, cout, k, norm in layers:
        fan = cin * k * k
        std = (cfg["assumed"]["head_gain"] if norm is None else math.sqrt(2)
               ) / math.sqrt(fan)
        specs += [(f"{name}.conv2d.weight", (cout, cin, k, k), std, 0.0),
                  (f"{name}.conv2d.bias", (cout,), 1 / math.sqrt(fan), 0.0)]
        if norm is not None:
            key = norm if norm.startswith("res") else f"{name}.instance"
            specs += [(f"{key}.weight", (cout,), 0.1, 1.0),
                      (f"{key}.bias", (cout,), 0.1, 0.0)]
    return specs


def stylizer_weights(cfg, seed, device):
    return make_weights(stylizer_specs(cfg), seed, device)


def vgg_weights(seed, device):
    return make_weights(he(vgg_specs(VGG16_CFG, VGG16_TAPS_RECONET)), seed,
                        device)


# ------------------------------------------------------------ forward

def _conv(s, pre, x, k, stride, q):
    x = F.pad(x, [k // 2] * 4, mode="reflect")
    return F.conv2d(q(x), q(s[pre + ".conv2d.weight"]),
                    s[pre + ".conv2d.bias"], stride=stride)


def _inorm(s, pre, x):
    return F.instance_norm(x, weight=s[pre + ".weight"],
                           bias=s[pre + ".bias"])


def _conv_in_relu(s, pre, x, k, stride, q):
    return F.relu(_inorm(s, pre + ".instance", _conv(s, pre, x, k, stride,
                                                      q)))


def _up_conv_in_relu(s, pre, x, q):
    return _conv_in_relu(s, pre, F.interpolate(x, scale_factor=2), 3, 1, q)


def _res(s, pre, x, q):
    out = F.relu(_inorm(s, pre + ".in1", _conv(s, pre + ".conv1", x, 3, 1,
                                               q)))
    return _inorm(s, pre + ".in2", _conv(s, pre + ".conv2", out, 3, 1, q)) + x


def forward(s, x, q=Exact()):
    """x (N, 3, H, W) 0-255 -> (deconv1 tap, res5 features, styled)."""
    x = _conv_in_relu(s, "conv1", x, 9, 1, q)
    x = _conv_in_relu(s, "conv2", x, 3, 2, q)
    x = _conv_in_relu(s, "conv3", x, 3, 2, q)
    for r in RES:
        x = _res(s, r, x, q)
    features = x
    x = _up_conv_in_relu(s, "deconv1", x, q)
    sd1 = x
    x = _up_conv_in_relu(s, "deconv2", x, q)
    x = torch.tanh(_conv(s, "deconv3", x, 9, 1, q) / 255) * 150 + 255 / 2
    return sd1, features, x


def serve(s, x_u8_nhwc, q=Exact()):
    """The served frames: uint8 NHWC in, clamped and truncated uint8 NHWC
    out (the reference's numpy conversion), float32 inside."""
    x = x_u8_nhwc.permute(0, 3, 1, 2).float()
    y = forward(s, x, q)[-1].clamp(0, 255)
    return y.to(torch.uint8).permute(0, 2, 3, 1)


# ------------------------------------------------------------ flow loss

def _warp(x, flo):
    """ReCoNet/utilities.py:39-57 backward warp (NCHW, flow NCHW)."""
    b, _, h, w = x.size()
    xx = torch.arange(0, w, dtype=x.dtype, device=x.device).view(1, -1)
    yy = torch.arange(0, h, dtype=x.dtype, device=x.device).view(-1, 1)
    grid = torch.stack([xx.expand(h, w), yy.expand(h, w)])[None]
    vgrid = grid + flo
    vx = 2.0 * vgrid[:, 0] / max(w - 1, 1) - 1.0
    vy = 2.0 * vgrid[:, 1] / max(h - 1, 1) - 1.0
    return F.grid_sample(x, torch.stack([vx, vy], dim=3), mode="bilinear",
                         padding_mode="zeros", align_corners=False)


def gram_chw(f):
    """Gram / (C·H·W): ReCoNet/utilities.py:93-98."""
    b, ch, h, w = f.shape
    fl = f.reshape(b, ch, h * w)
    return fl.bmm(fl.transpose(1, 2)) / (ch * h * w)


def _ftl(f1, f2, flow, mask):
    """Feature temporal loss (train_candy.py:91-106)."""
    ff = F.interpolate(flow, size=f1.shape[2:], mode="bilinear")
    ff = ff * torch.tensor([f1.shape[3] / flow.shape[3],
                            f1.shape[2] / flow.shape[2]], dtype=f1.dtype,
                           device=f1.device).view(1, 2, 1, 1)
    warped = _warp(f1, ff)
    fmask = F.interpolate(mask.unsqueeze(1), size=f1.shape[2:],
                          mode="bilinear").squeeze(1)
    fmask = (fmask > 0).to(f1.dtype).unsqueeze(1).expand(-1, f1.shape[1],
                                                         -1, -1)
    return torch.sum(fmask * torch.square(f2 - warped)) / torch.count_nonzero(
        fmask)


def _otl(i1n, i2n, s1n, s2n, flow, mask):
    """Output temporal loss, Rec.709 luma input term (train_candy.py:
    108-123)."""
    out_term = s2n - _warp(s1n, flow)
    in_term = i2n - _warp(i1n, flow)
    luma = (0.2126 * in_term[:, 0] + 0.7152 * in_term[:, 1]
            + 0.0722 * in_term[:, 2])
    in_term = luma.unsqueeze(1).expand(-1, 3, -1, -1)
    cmask = mask.unsqueeze(1).expand(-1, 3, -1, -1)
    return torch.sum(cmask * torch.square(out_term - in_term)
                     ) / torch.count_nonzero(cmask)


def _tv_sum(x):
    reg1 = torch.square(x[:, :, :-1, 1:] - x[:, :, :-1, :-1])
    reg2 = torch.square(x[:, :, 1:, :-1] - x[:, :, :-1, :-1])
    return torch.sum(reg1 + reg2)


def _taps(vgg, x):
    return list(vgg_features(vgg, x, VGG16_CFG, VGG16_TAPS_RECONET).values())


@torch.no_grad()
def style_grams(vgg, style_nhwc):
    """Per-tap Grams of the style image (1, H, W, 3) 0-255."""
    return [gram_chw(f) for f in _taps(vgg, vgg_normalize(
        style_nhwc.permute(0, 3, 1, 2).float()))]


def flow_loss(train, params, frozen, batch):
    """The candy flow trainer's total loss; batch NHWC (img1, img2, flow,
    mask) as the loader yields it."""
    img1, img2, flow, mask = batch
    img1, img2, flow = (x.permute(0, 3, 1, 2) for x in (img1, img2, flow))
    _, fmap1, s1 = forward(params, img1)
    _, fmap2, s2 = forward(params, img2)
    s1n, s2n = vgg_normalize(s1), vgg_normalize(s2)
    i1n, i2n = vgg_normalize(img1), vgg_normalize(img2)
    vgg = frozen["vgg"]
    sf1, sf2, cf1, cf2 = (_taps(vgg, x) for x in (s1n, s2n, i1n, i2n))
    total = 0.0
    if train["use_ftl"]:
        total = _ftl(fmap1, fmap2, flow, mask) * train["lambda_f"]
    total = total + _otl(i1n, i2n, s1n, s2n, flow, mask) * train["lambda_o"]
    content = (F.mse_loss(sf1[2], cf1[2]) + F.mse_loss(sf2[2], cf2[2])
               ) * train["alpha"]
    style = 0.0
    for f1, f2, gs in zip(sf1, sf2, frozen["grams"]):
        style = style + F.mse_loss(gram_chw(f1),
                                   gs.expand(f1.shape[0], -1, -1))
        style = style + F.mse_loss(gram_chw(f2),
                                   gs.expand(f2.shape[0], -1, -1))
    reg = (_tv_sum(s1n) + _tv_sum(s2n)) * train["gamma"]
    return total + content + style * train["beta"] + reg
