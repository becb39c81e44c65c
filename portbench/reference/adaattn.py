"""Plain AdaAttN (Liu et al., ICCV 2021; the reference's AdaAttN/network.py
and vgg19.py) and its image trainer's loss (AdaAttN/train_image.py:70-110),
float32, NCHW, over flat state dicts in the reference's key layout, the
softmax attention materialized.  Frozen from the port's test oracles
(tests/torch_refs.py, tests/torch_train_refs.py)."""

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import (VGG19_CFG, VGG19_TAPS_ADAATTN, Exact,
                                        he, make_weights, vgg_features,
                                        vgg_normalize, vgg_specs)

DECODER = [("decoder.conv1.conv.conv", 512, 512),
           ("decoder.conv2.conv.conv", 512, 256),
           ("decoder.conv3.0.conv.conv", 512, 256),
           ("decoder.conv3.1.conv.conv", 256, 256),
           ("decoder.conv3.2.conv.conv", 256, 256),
           ("decoder.conv4.conv.conv", 256, 128),
           ("decoder.conv5.conv.conv", 128, 128),
           ("decoder.conv6.conv.conv", 128, 64),
           ("decoder.conv7.conv.conv", 64, 64),
           ("decoder.conv8.conv", 64, 3)]


def stylizer_specs(cfg):
    """(key, OIHW shape, std, mean) of the seeded stylizer.  The query and
    key convs are scaled so that the attention scores have the spread
    ``assumed.attention_score_std`` (q and k come from instance-normed
    features); the value convs keep their input's scale; the decoder is
    N(0, 2/fan_in) (ReLUs follow), its last conv scaled by
    ``assumed.decoder_head_gain`` around ``assumed.decoder_head_bias``, so
    that the styled image spreads over 0-255 as a trained one does."""
    a = cfg["assumed"]
    specs = []
    for i, (qk, v) in enumerate(zip(cfg["qk_dims"], cfg["v_dims"])):
        sq = math.sqrt(a["attention_score_std"] / qk ** 1.5)
        for tag, ch, std in (("f", qk, sq), ("g", qk, sq),
                             ("h", v, 1 / math.sqrt(v))):
            specs += [(f"adaattn.{i}.{tag}.weight", (ch, ch, 1, 1), std, 0.0),
                      (f"adaattn.{i}.{tag}.bias", (ch,), 0.0, 0.0)]
    for name, cin, cout in DECODER:
        fan = cin * 9
        last = name == DECODER[-1][0]
        std = (a["decoder_head_gain"] if last else math.sqrt(2)
               ) / math.sqrt(fan)
        specs += [(f"{name}.weight", (cout, cin, 3, 3), std, 0.0),
                  (f"{name}.bias", (cout,), 0.0,
                   a["decoder_head_bias"] if last else 0.0)]
    return specs


def stylizer_weights(cfg, seed, device):
    return make_weights(stylizer_specs(cfg), seed, device)


def vgg_weights(seed, device):
    return make_weights(he(vgg_specs(VGG19_CFG, VGG19_TAPS_ADAATTN)), seed,
                        device)


def features(vgg, x255, q=Exact()):
    """VGG19 relu*_1 taps of a 0-255 NCHW batch (normalized inside)."""
    return vgg_features(vgg, vgg_normalize(x255), VGG19_CFG,
                        VGG19_TAPS_ADAATTN, q)


def down_sample(feats, last):
    size = feats[last].shape[-2:]
    parts = [F.interpolate(feats[i], size=size, mode="bilinear",
                           align_corners=False) for i in range(last)]
    return torch.cat(parts + [feats[last]], dim=1)


def module(s, pre, c_x, s_x, c_1x, s_1x, q=Exact()):
    """One attention module, softmax; ``pre=None`` is the conv-free
    target (AdaAttnNoConv)."""
    qmap, kmap = F.instance_norm(c_1x), F.instance_norm(s_1x)
    if pre is not None:
        qmap = F.conv2d(q(qmap), q(s[pre + ".f.weight"]), s[pre + ".f.bias"])
        kmap = F.conv2d(q(kmap), q(s[pre + ".g.weight"]), s[pre + ".g.bias"])
        vmap = F.conv2d(q(s_x), q(s[pre + ".h.weight"]), s[pre + ".h.bias"])
    else:
        vmap = s_x
    b, _, h, w = qmap.shape
    qq = qmap.reshape(b, -1, h * w).permute(0, 2, 1)
    kk = kmap.reshape(b, -1, kmap.shape[2] * kmap.shape[3])
    vv = vmap.reshape(b, -1, kmap.shape[2] * kmap.shape[3]).permute(0, 2, 1)
    a = torch.softmax(torch.bmm(q(qq), q(kk)), dim=-1)
    m = torch.bmm(q(a), q(vv))
    var = torch.bmm(q(a), q(vv ** 2)) - m ** 2
    sd = torch.sqrt(var.clamp(min=1e-6))
    m = m.reshape(b, h, w, -1).permute(0, 3, 1, 2)
    sd = sd.reshape(b, h, w, -1).permute(0, 3, 1, 2)
    return sd * F.instance_norm(c_x) + m


def _conv(s, pre, x, q):
    x = F.pad(x, [1] * 4, mode="reflect")
    return F.conv2d(q(x), q(s[pre + ".weight"]), s[pre + ".bias"])


def decoder(s, x5, x4, x3, q=Exact()):
    def up(z):
        return F.interpolate(z, scale_factor=2, mode="bilinear",
                             align_corners=False)

    def cr(pre, x):
        return F.relu(_conv(s, f"decoder.{pre}.conv.conv", x, q))

    x = cr("conv2", cr("conv1", up(x5) + x4))
    x = torch.cat([up(x), x3], dim=1)
    for i in range(3):
        x = cr(f"conv3.{i}", x)
    x = cr("conv5", up(cr("conv4", x)))
    x = cr("conv7", up(cr("conv6", x)))
    return _conv(s, "decoder.conv8.conv", x, q)


def stylize(s, fc, fs, q=Exact()):
    fcl, fsl = list(fc.values()), list(fs.values())
    outs = [module(s, f"adaattn.{i}", fcl[i + 2], fsl[i + 2],
                   down_sample(fcl, i + 2), down_sample(fsl, i + 2), q)
            for i in range(3)]
    return decoder(s, outs[2], outs[1], outs[0], q)


def serve(s, vgg, content_nhwc, style_nhwc, q=Exact()):
    """Styled images clamped to 0-255 (float32, NHWC) of uint8 or 0-255
    NHWC contents and styles."""
    c = content_nhwc.permute(0, 3, 1, 2).float()
    st = style_nhwc.permute(0, 3, 1, 2).float()
    y = stylize(s, features(vgg, c, q), features(vgg, st, q), q)
    return y.clamp(0, 255).permute(0, 2, 3, 1)


def image_loss(train, params, frozen, batch):
    """The image trainer's total loss (global stylized + local feature);
    batch NHWC (content, style) 0-255."""
    content, style = (x.permute(0, 3, 1, 2) for x in batch)
    vgg = frozen["vgg"]
    fc, fs = features(vgg, content), features(vgg, style)
    fcs = features(vgg, stylize(params, fc, fs))
    loss_gs = 0.0
    for tap in ("relu2_1", "relu3_1", "relu4_1", "relu5_1"):
        a, b = fcs[tap], fs[tap]
        loss_gs = (loss_gs
                   + F.mse_loss(a.mean(dim=(2, 3)), b.mean(dim=(2, 3)))
                   + F.mse_loss(a.std(dim=(2, 3)), b.std(dim=(2, 3))))
    fcl, fsl = list(fc.values()), list(fs.values())
    loss_lf = 0.0
    for i in range(3):
        idx = i + 2
        target = module(None, None, fcl[idx], fsl[idx], down_sample(fcl, idx),
                        down_sample(fsl, idx))
        loss_lf = loss_lf + F.mse_loss(fcs[f"relu{i + 3}_1"], target)
    return loss_gs * train["lambda_g"] + loss_lf * train["lambda_l"]
