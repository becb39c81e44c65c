"""Shared parts of the references: the VGG layer tables, VGG features,
ImageNet normalization, full float32, the lower-precision control, and
seeded weights made on the device in a few large calls."""

import math

import torch
import torch.nn.functional as F

# torchvision VGG "features" layouts: channel counts, "M" = MaxPool2d(2, 2).
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
VGG16_TAPS_RECONET = {"relu1_2": 3, "relu2_2": 8, "relu3_3": 15,
                      "relu4_3": 22}
VGG19_TAPS_ADAATTN = {"relu1_1": 1, "relu2_1": 6, "relu3_1": 11,
                      "relu4_1": 20, "relu5_1": 29}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def full_float32():
    """Float32 that is float32: TF32 off for cuDNN and cuBLAS."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def tf32():
    """The training control: the same float32 reference with TF32 on."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


class Exact:
    """The reference's precision: operands as they are."""

    def __call__(self, x):
        return x


class FP8:
    """The serving control: every product's operands rounded to float8
    e4m3 with a per-tensor scale, the step below bfloat16."""

    def __call__(self, x):
        amax = x.detach().abs().amax().clamp(min=1e-12)
        scale = 448.0 / amax
        q = (x * scale).to(torch.float8_e4m3fn).to(x.dtype)
        return q / scale


def layer_table(cfg):
    """[(features_index, kind, in_ch, out_ch)] for conv/relu/pool layers."""
    table, idx, in_ch = [], 0, 3
    for v in cfg:
        if v == "M":
            table.append((idx, "pool", in_ch, in_ch))
            idx += 1
        else:
            table.append((idx, "conv", in_ch, v))
            table.append((idx + 1, "relu", v, v))
            idx += 2
            in_ch = v
    return table


def vgg_specs(cfg, taps):
    """(key, OIHW shape, fan_in) of the VGG convs up to the last tap."""
    out = []
    for idx, kind, cin, cout in layer_table(cfg):
        if idx > max(taps.values()):
            break
        if kind == "conv":
            out.append((f"features.{idx}.weight", (cout, cin, 3, 3), cin * 9))
            out.append((f"features.{idx}.bias", (cout,), cin * 9))
    return out


def vgg_features(state, x, cfg, taps, q=Exact()):
    max_tap = max(taps.values())
    inv = {v: k for k, v in taps.items()}
    out = {}
    for idx, kind, _, _ in layer_table(cfg):
        if idx > max_tap:
            break
        if kind == "conv":
            x = F.conv2d(q(x), q(state[f"features.{idx}.weight"]),
                         state[f"features.{idx}.bias"], padding=1)
        elif kind == "relu":
            x = F.relu(x)
        else:
            x = F.max_pool2d(x, 2, 2)
        if idx in inv:
            out[inv[idx]] = x
    return out


def vgg_normalize(x255):
    mean = torch.tensor(IMAGENET_MEAN, dtype=x255.dtype,
                        device=x255.device).view(-1, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=x255.dtype,
                       device=x255.device).view(-1, 1, 1)
    return (x255 / 255.0 - mean) / std


def make_weights(specs, seed, device):
    """One float32 state dict from ``specs`` [(key, shape, std, mean)]:
    one normal draw on the device for all of it, from ``seed``."""
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for (key, shape, std, mean), n in zip(specs, sizes):
        out[key] = flat[off:off + n].view(shape) * std + mean
        off += n
    return out


def he(specs, gain=2.0):
    """Weights N(0, gain/fan_in), biases 0: a trained network's scale
    kept through depth, where torch's default init shrinks it."""
    return [(k, s, math.sqrt(gain / fan) if k.endswith("weight") else 0.0,
             0.0) for k, s, fan in specs]


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)
