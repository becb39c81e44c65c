"""Frozen VGG feature extractors: AdaAttN's VGG19 (relu1_1 … relu5_1),
RTNSTV's VGG19 (relu1_2, relu2_2, relu3_2, relu4_2) and ReCoNet's VGG16
(relu1_2, relu2_2, relu3_3, relu4_3).

Counterpart of ``vst_tpu/models/vgg.py`` (``vgg19_adaattn_features``,
``vgg19_rtnstv_features``, ``vgg16_features``; parity: AdaAttN/vgg19.py:
8-63, RTNSTV/vgg19.py:8-55, ReCoNet/network.py:9-40).  Each module holds
torchvision's ``features`` Sequential up to its last tap, so its
``state_dict`` keys are ``features.<i>.weight``/``.bias`` (OIHW) and a
torchvision state_dict loads once its other keys are dropped
(``build_vgg19_adaattn``, ``build_vgg19_rtnstv``, ``build_vgg16_reconet``).
Both VGG19s normalize their input inside (RTNSTV/vgg19.py:39); ReCoNet's
VGG16 takes input the caller has normalized (the ReCoNet trainers call
``vgg_normalize`` themselves).  Input and taps are NHWC.

``forward(x, spatial=ctx)`` (``parallel/spatial.py``) encodes this rank's
row block of an H-sharded frame: each zero-padded conv exchanges one row
a side, the pools need the block to start on a multiple of 2 to the
number of pools before the last tap (8 for VGG16's relu4_3, 16 for
VGG19's relu5_1) and, but for the frame's last block, to hold whole
units of it (``parallel/spatial.py::row_layout``; the last block floors
as the unsharded pools floor the frame), and the taps come back as row
blocks.  It differentiates (the
exchange's backward), so the train steps' losses run on it over a space
axis; AdaAttN's content side also serves on it.
"""

import numpy as np
import torch
import torch.nn as nn

from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.device import apply_precision, resolve_device
from vst_tpu_torch.models.init import as_rng, conv_init
from vst_tpu_torch.models.remat import segment
from vst_tpu_torch.ops.conv import conv2d, max_pool2d
from vst_tpu_torch.ops.image import vgg_normalize
from vst_tpu_torch.parallel.spatial import check_rows
from vst_tpu_torch.utils.profiling import span

# torchvision VGG "features" layouts: channel counts, "M" = MaxPool2d(2, 2).
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
# Tap name → features index of the ReLU producing it.
VGG16_TAPS_RECONET = {"relu1_2": 3, "relu2_2": 8, "relu3_3": 15, "relu4_3": 22}
VGG19_TAPS_RTNSTV = {"relu1_2": 3, "relu2_2": 8, "relu3_2": 13, "relu4_2": 22}
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


class _VGGTaps(nn.Module):
    """torchvision's ``features`` up to the last of ``TAPS``; ``forward``
    maps an NHWC batch to the ordered tap dict."""

    CFG: list = VGG19_CFG
    TAPS: dict = VGG19_TAPS_ADAATTN
    NORMALIZE = True    # ImageNet-normalize a 0–255 input first

    def __init__(self):
        super().__init__()
        layers = []
        for idx, kind, in_ch, out_ch in _layer_table(self.CFG):
            if idx > max(self.TAPS.values()):
                break
            if kind == "conv":
                layers.append(nn.Conv2d(in_ch, out_ch, 3, padding=1))
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, remat: bool = False,
                spatial=None) -> dict:
        """``remat=True`` checkpoints each inter-tap segment, as the JAX
        package's ``_run`` does: only the taps survive the forward, and
        backward recomputes one segment's internals at a time.
        ``spatial``: x is this rank's row block (module docstring).  Runs
        in the span "vst::vgg.encode"."""
        apply_precision(x.dtype)
        if spatial is not None:
            check_rows(spatial, x.shape[1], self.row_multiple(),
                       type(self).__name__)
        with span("vst::vgg.encode"):
            if self.NORMALIZE:
                x = vgg_normalize(x)
            out = {}
            start = 0
            for name, idx in self.TAPS.items():
                x = segment(self._layers, remat)(x, start, idx + 1, spatial)
                out[name] = x
                start = idx + 1
            return out

    @classmethod
    def row_multiple(cls) -> int:
        """2 to the number of pools before the last tap: the row unit a
        block's start (and, but for the last block, its height) must be a
        multiple of."""
        last = max(cls.TAPS.values())
        return 2 ** sum(kind == "pool" and idx < last
                        for idx, kind, _, _ in _layer_table(cls.CFG))

    def _layers(self, x, start, stop, spatial=None):
        for layer in self.features[start:stop]:
            if isinstance(layer, nn.Conv2d):
                x = conv2d(x, layer.weight, layer.bias, padding=1,
                           spatial=spatial)
            elif isinstance(layer, nn.ReLU):
                x = torch.relu(x)
            else:
                x = max_pool2d(x, spatial=spatial)
        return x


class VGG19AdaAttN(_VGGTaps):
    """VGG19 ``features`` up to relu5_1: a 0–255 NHWC RGB batch → the taps
    relu1_1 … relu5_1."""


class VGG19RTNSTV(_VGGTaps):
    """VGG19 ``features`` up to relu4_2: a 0–255 NHWC RGB batch → the taps
    relu1_2, relu2_2, relu3_2, relu4_2."""

    TAPS = VGG19_TAPS_RTNSTV


class VGG16ReCoNet(_VGGTaps):
    """VGG16 ``features`` up to relu4_3: an ImageNet-normalized NHWC batch
    → the taps relu1_2, relu2_2, relu3_3, relu4_3."""

    CFG = VGG16_CFG
    TAPS = VGG16_TAPS_RECONET
    NORMALIZE = False


def vgg19_adaattn_features(vgg: VGG19AdaAttN, x: torch.Tensor,
                           remat: bool = False, spatial=None) -> dict:
    """AdaAttN tap set of a 0–255 NHWC RGB batch (normalized here); with
    ``spatial``, of this rank's row block (R a multiple of 16)."""
    return vgg(x, remat=remat, spatial=spatial)


def vgg19_rtnstv_features(vgg: VGG19RTNSTV, x: torch.Tensor,
                          remat: bool = False, spatial=None) -> dict:
    """RTNSTV tap set of a 0–255 NHWC RGB batch (normalized here); with
    ``spatial``, of this rank's row block (R a multiple of 8)."""
    return vgg(x, remat=remat, spatial=spatial)


def vgg16_features(vgg: VGG16ReCoNet, x: torch.Tensor,
                   remat: bool = False, spatial=None) -> dict:
    """ReCoNet tap set of an already ``vgg_normalize``d NHWC batch; with
    ``spatial``, of this rank's row block (R a multiple of 8)."""
    return vgg(x, remat=remat, spatial=spatial)


def _build(cls, state: dict, device, dtype):
    dev = resolve_device(device)
    with torch.device("meta"):
        model = cls()
    keys = model.state_dict().keys()
    model.load_state_dict({k: state[k] for k in keys if k in state},
                          strict=True, assign=True)
    return model.to(device=dev, dtype=dtype).eval()


def _seeded(cls, seed, device, dtype):
    dev = resolve_device(device)
    state = params_from_jax(init_params(seed, cls.CFG,
                                        max(cls.TAPS.values())))
    return _build(cls, state, dev, dtype)


def build_vgg19_adaattn(state: dict, device="cuda",
                        dtype: torch.dtype = torch.float32) -> VGG19AdaAttN:
    """A VGG19AdaAttN holding ``state`` (torch layout; keys it does not use,
    such as a torchvision checkpoint's later layers and classifier, are
    dropped), on ``device`` at ``dtype``."""
    return _build(VGG19AdaAttN, state, device, dtype)


def build_vgg19_rtnstv(state: dict, device="cuda",
                       dtype: torch.dtype = torch.float32) -> VGG19RTNSTV:
    """A VGG19RTNSTV holding ``state`` (torch layout, keys it does not use
    dropped), on ``device`` at ``dtype``."""
    return _build(VGG19RTNSTV, state, device, dtype)


def build_vgg16_reconet(state: dict, device="cuda",
                        dtype: torch.dtype = torch.float32) -> VGG16ReCoNet:
    """A VGG16ReCoNet holding ``state`` (torch layout, keys it does not use
    dropped), on ``device`` at ``dtype``."""
    return _build(VGG16ReCoNet, state, device, dtype)


def init_vgg19_adaattn(seed, device="cuda",
                       dtype: torch.dtype = torch.float32) -> VGG19AdaAttN:
    """A VGG19AdaAttN holding the JAX package's ``init_vgg19_adaattn(seed)``."""
    return _seeded(VGG19AdaAttN, seed, device, dtype)


def init_vgg19_rtnstv(seed, device="cuda",
                      dtype: torch.dtype = torch.float32) -> VGG19RTNSTV:
    """A VGG19RTNSTV holding the JAX package's ``init_vgg19_rtnstv(seed)``."""
    return _seeded(VGG19RTNSTV, seed, device, dtype)


def init_vgg16_reconet(seed, device="cuda",
                       dtype: torch.dtype = torch.float32) -> VGG16ReCoNet:
    """A VGG16ReCoNet holding the JAX package's ``init_vgg16_reconet(seed)``."""
    return _seeded(VGG16ReCoNet, seed, device, dtype)
