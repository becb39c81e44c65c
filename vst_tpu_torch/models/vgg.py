"""Frozen VGG19 feature extractor of AdaAttN (relu1_1 … relu5_1).

Counterpart of ``vst_tpu/models/vgg.py`` (``vgg19_adaattn_features``;
parity: AdaAttN/vgg19.py:8-63).  The module holds torchvision's
``features`` Sequential up to relu5_1, so its ``state_dict`` keys are
``features.<i>.weight``/``.bias`` (OIHW) and a torchvision VGG19
state_dict loads once its other keys are dropped (``build_vgg19_adaattn``).
ImageNet normalization happens inside; input and taps are NHWC.  The VGG16
and RTNSTV tap sets come with their slices.
"""

import numpy as np
import torch
import torch.nn as nn

from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.device import apply_precision, resolve_device
from vst_tpu_torch.models.init import as_rng, conv_init
from vst_tpu_torch.ops.conv import conv2d, max_pool2d
from vst_tpu_torch.ops.image import vgg_normalize

# torchvision VGG "features" layout: channel counts, "M" = MaxPool2d(2, 2).
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
# Tap name → features index of the ReLU producing it.
VGG19_TAPS_ADAATTN = {"relu1_1": 1, "relu2_1": 6, "relu3_1": 11,
                      "relu4_1": 20, "relu5_1": 29}


def _layer_table(cfg):
    """[(features_index, kind, in_ch, out_ch)] for conv/relu/pool layers."""
    table = []
    idx = 0
    in_ch = 3
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


def init_params(key, cfg, max_index: int, dtype=np.float32) -> dict:
    """numpy HWIO parameters up to ``max_index``, drawn exactly as the JAX
    package's ``init_params`` draws them (same order, same keys)."""
    rng = as_rng(key)
    params = {}
    for idx, kind, in_ch, out_ch in _layer_table(cfg):
        if idx > max_index:
            break
        if kind == "conv":
            w, b = conv_init(rng, 3, in_ch, out_ch, dtype)
            params[f"features.{idx}.weight"] = w
            params[f"features.{idx}.bias"] = b
    return params


class VGG19AdaAttN(nn.Module):
    """VGG19 ``features`` up to relu5_1; ``forward`` maps a 0–255 NHWC RGB
    batch to the ordered tap dict relu1_1 … relu5_1."""

    TAPS = VGG19_TAPS_ADAATTN

    def __init__(self):
        super().__init__()
        layers = []
        for idx, kind, in_ch, out_ch in _layer_table(VGG19_CFG):
            if idx > max(self.TAPS.values()):
                break
            if kind == "conv":
                layers.append(nn.Conv2d(in_ch, out_ch, 3, padding=1))
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> dict:
        apply_precision(x.dtype)
        inv = {v: k for k, v in self.TAPS.items()}
        x = vgg_normalize(x)
        out = {}
        for idx, layer in enumerate(self.features):
            if isinstance(layer, nn.Conv2d):
                x = conv2d(x, layer.weight, layer.bias, padding=1)
            elif isinstance(layer, nn.ReLU):
                x = torch.relu(x)
            else:
                x = max_pool2d(x)
            if idx in inv:
                out[inv[idx]] = x
        return out


def vgg19_adaattn_features(vgg: VGG19AdaAttN, x: torch.Tensor) -> dict:
    """AdaAttN tap set of a 0–255 NHWC RGB batch (normalized here)."""
    return vgg(x)


def build_vgg19_adaattn(state: dict, device="cuda",
                        dtype: torch.dtype = torch.float32) -> VGG19AdaAttN:
    """A VGG19AdaAttN holding ``state`` (torch layout; keys it does not use,
    such as a torchvision checkpoint's later layers and classifier, are
    dropped), on ``device`` at ``dtype``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = VGG19AdaAttN()
    keys = model.state_dict().keys()
    model.load_state_dict({k: state[k] for k in keys if k in state},
                          strict=True, assign=True)
    return model.to(device=dev, dtype=dtype).eval()


def init_vgg19_adaattn(seed, device="cuda",
                       dtype: torch.dtype = torch.float32) -> VGG19AdaAttN:
    """A VGG19AdaAttN holding the JAX package's ``init_vgg19_adaattn(seed)``."""
    dev = resolve_device(device)
    state = params_from_jax(init_params(seed, VGG19_CFG,
                                        max(VGG19_TAPS_ADAATTN.values())))
    return build_vgg19_adaattn(state, dev, dtype)
