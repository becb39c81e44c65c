"""LPIPS perceptual metric — the vendored package's whole surface.

Counterpart of ``vst_tpu/eval/lpips.py`` (parity: AdaAttN/lpips/lpips.py:
24-161 with all three trunks, as used by ``eval.py``'s lpips_loss,
AdaAttN/eval.py:19-35, net="vgg" default):

- inputs scaled to [-1, 1] (``im2tensor``), then (v0.1) the
  ScalingLayer's shift/scale constants (lpips/lpips.py:164-171) —
  ``version="0.0"`` skips the scaling layer as the vendored package does
  (lpips/lpips.py:135);
- trunk slices (lpips/pretrained_networks.py): vgg16
  relu1_2/2_2/3_3/4_3/5_3; alexnet after every ReLU (5 taps);
  squeezenet1_1 after slice boundaries 2/5/8/10/11/12/13 (7 taps);
- per-layer unit-normalization over channels (eps 1e-10), squared diff,
  calibrated 1×1 linear head (no bias), spatial mean, summed over layers;
- ``use_lpips=False`` is the "baseline" mode: channel-sum of the squared
  normalized diff, no learned heads (lpips/lpips.py:149-153);
- FakeNet baselines L2 / DSSIM in RGB or Lab colorspace
  (lpips/lpips.py:241-280, helpers lpips/__init__.py:17-24), numpy.

Parameters: a dict of tensors in torch layout (OIHW) keyed
"features.<i>.weight/bias" (torchvision's trunk keys; squeezenet Fire
modules "features.<i>.{squeeze,expand1x1,expand3x3}") plus the heads
"lin<k>.weight" (1, C_k, 1, 1) — a torchvision trunk state_dict and
``load_linear_heads`` of a vendored checkpoint together, or the JAX
package's parameters through ``compat.params_from_jax``.  Runs in float32
with TF32 off on the parameters' device.
"""

import numpy as np
import torch
import torch.nn.functional as F

from vst_tpu_torch.device import apply_precision
from vst_tpu_torch.models.init import as_rng
from vst_tpu_torch.models.vgg import VGG16_CFG, _layer_table, init_params
from vst_tpu_torch.ops.conv import conv2d, max_pool2d
from vst_tpu_torch.ops.resize import resize_bilinear

# torchvision vgg16.features ReLU indices for relu1_2/2_2/3_3/4_3/5_3
LPIPS_VGG16_TAPS = (3, 8, 15, 22, 29)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
LPIPS_CHANNELS_BY_NET = {
    "vgg": LPIPS_CHANNELS,
    "alex": (64, 192, 384, 256, 256),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _vgg16_lpips_feats(params, x):
    taps = set(LPIPS_VGG16_TAPS)
    out = []
    for idx, kind, _, _ in _layer_table(VGG16_CFG):
        if idx > LPIPS_VGG16_TAPS[-1]:
            break
        if kind == "conv":
            x = conv2d(x, params[f"features.{idx}.weight"],
                       params[f"features.{idx}.bias"], stride=1, padding=1)
        elif kind == "relu":
            x = torch.relu(x)
        else:
            x = max_pool2d(x)
        if idx in taps:
            out.append(x)
    return out


def _max_pool3s2(x, ceil_mode=False):
    """MaxPool2d(3, 2) — ceil_mode pads bottom/right with -inf when the last
    window would be dropped (squeezenet1_1's pools use ceil_mode=True),
    the JAX package's window arithmetic."""
    if ceil_mode:
        pads = []
        for n in x.shape[1:3]:
            rem = (n - 3) % 2
            pads.append(2 - rem if rem else 0)
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[1], 0, pads[0]), value=-float("inf"))
    return max_pool2d(x, 3, 2)


def _alexnet_feats(params, x):
    """torchvision alexnet.features, taps after every ReLU
    (lpips/pretrained_networks.py alexnet slices 2/5/8/10/12)."""
    def c(i, x, stride=1, padding=0):
        return torch.relu(conv2d(x, params[f"features.{i}.weight"],
                                 params[f"features.{i}.bias"],
                                 stride=stride, padding=padding))

    out = []
    x = c(0, x, stride=4, padding=2)
    out.append(x)
    x = c(3, _max_pool3s2(x), padding=2)
    out.append(x)
    x = c(6, _max_pool3s2(x), padding=1)
    out.append(x)
    x = c(8, x, padding=1)
    out.append(x)
    x = c(10, x, padding=1)
    out.append(x)
    return out


def _fire(params, i, x):
    """squeezenet Fire: squeeze 1×1 → ReLU → concat(expand1x1, expand3x3)."""
    s = torch.relu(conv2d(x, params[f"features.{i}.squeeze.weight"],
                          params[f"features.{i}.squeeze.bias"]))
    e1 = torch.relu(conv2d(s, params[f"features.{i}.expand1x1.weight"],
                           params[f"features.{i}.expand1x1.bias"]))
    e3 = torch.relu(conv2d(s, params[f"features.{i}.expand3x3.weight"],
                           params[f"features.{i}.expand3x3.bias"], padding=1))
    return torch.cat([e1, e3], dim=-1)


def _squeezenet_feats(params, x):
    """torchvision squeezenet1_1.features, 7 taps at the vendored slice
    boundaries (lpips/pretrained_networks.py squeezenet, N_slices=7)."""
    out = []
    x = torch.relu(conv2d(x, params["features.0.weight"],
                          params["features.0.bias"], stride=2))
    out.append(x)                                   # slice1 = [0, 2)
    x = _fire(params, 4, _fire(params, 3, _max_pool3s2(x, ceil_mode=True)))
    out.append(x)                                   # slice2 = [2, 5)
    x = _fire(params, 7, _fire(params, 6, _max_pool3s2(x, ceil_mode=True)))
    out.append(x)                                   # slice3 = [5, 8)
    x = _fire(params, 9, _max_pool3s2(x, ceil_mode=True))
    out.append(x)                                   # slice4 = [8, 10)
    x = _fire(params, 10, x)
    out.append(x)                                   # slice5 = [10, 11)
    x = _fire(params, 11, x)
    out.append(x)                                   # slice6 = [11, 12)
    x = _fire(params, 12, x)
    out.append(x)                                   # slice7 = [12, 13)
    return out


_TRUNKS = {"vgg": _vgg16_lpips_feats, "alex": _alexnet_feats,
           "squeeze": _squeezenet_feats}


def _normalize(feat, eps=1e-10):
    norm = torch.sqrt(torch.sum(torch.square(feat.float()), dim=-1,
                                keepdim=True))
    return feat / (norm + eps)


def _inputs(params, img0, img1, version):
    """The pair on the parameters' device in float32, through the
    ScalingLayer for v0.1 (v0.0 consumes the [-1, 1] inputs raw,
    lpips/lpips.py:135 picks by self.version)."""
    dev = next(iter(params.values())).device
    x0 = torch.as_tensor(img0).to(dev, torch.float32)
    x1 = torch.as_tensor(img1).to(dev, torch.float32)
    if version == "0.1":
        shift = torch.tensor(_SHIFT, device=dev)
        scale = torch.tensor(_SCALE, device=dev)
        x0 = (x0 - shift) / scale
        x1 = (x1 - shift) / scale
    return x0, x1


@torch.inference_mode()
def lpips_distance(params, img0, img1, net: str = "vgg",
                   use_lpips: bool = True, spatial: bool = False,
                   ret_per_layer: bool = False, version: str = "0.1"):
    """LPIPS distance (lpips/lpips.py:129-161).  img0/img1: (N, H, W, 3)
    RGB in [-1, 1] (numpy or tensors); returns (N,) on the parameters'
    device.

    ``use_lpips=False`` is the package's "baseline" mode: channel-sum of
    squared normalized diffs, no learned heads.  ``spatial=True`` returns a
    per-pixel distance map (N, H, W, 1) — each layer's map bilinearly
    upsampled to the input size (lpips/lpips.py:145-152, upsample
    align_corners=False) — instead of the spatial average.
    ``ret_per_layer`` additionally returns the per-layer values."""
    return _lpips(params, img0, img1, net, use_lpips, spatial, ret_per_layer,
                  version)


def _lpips(params, img0, img1, net="vgg", use_lpips=True, spatial=False,
           ret_per_layer=False, version="0.1"):
    """``lpips_distance`` without its inference mode, for the ranking
    trainer, which takes gradients through the heads."""
    apply_precision(torch.float32)
    x0, x1 = _inputs(params, img0, img1, version)
    f0 = _TRUNKS[net](params, x0)
    f1 = _TRUNKS[net](params, x1)
    res_layers = []
    for k, (a, b) in enumerate(zip(f0, f1)):
        diff = torch.square(_normalize(a) - _normalize(b))
        if use_lpips:
            res = conv2d(diff, params[f"lin{k}.weight"], None)
        else:
            res = torch.sum(diff, dim=-1, keepdim=True)
        if spatial:
            res_layers.append(resize_bilinear(res, tuple(x0.shape[1:3])))
        else:
            res_layers.append(torch.mean(res, dim=(1, 2, 3)))
    val = sum(res_layers)
    return (val, res_layers) if ret_per_layer else val


def lpips_vgg(params, img0, img1):
    """LPIPS distance, vgg flavor (the eval.py default)."""
    return lpips_distance(params, img0, img1, "vgg")


def image_to_lpips_input(img_255: np.ndarray) -> np.ndarray:
    """HWC RGB 0–255 → (1, H, W, 3) in [-1, 1] (lpips.im2tensor)."""
    return (np.asarray(img_255, np.float32) / (255.0 / 2.0) - 1.0)[None]


def load_linear_heads(path: str, net: str = "vgg") -> dict:
    """A vendored LPIPS linear-head checkpoint ("lin<k>.model.1.weight",
    (1, C, 1, 1)) → the "lin<k>.weight" heads, in that same layout."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {f"lin{k}.weight": state[f"lin{k}.model.1.weight"]
            for k in range(len(LPIPS_CHANNELS_BY_NET[net]))}


# (out_ch, in_ch, k) per torchvision features index
_ALEX_CONVS = {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3),
               8: (256, 384, 3), 10: (256, 256, 3)}
# (squeeze_ch, in_ch, expand_ch) per Fire index in squeezenet1_1
_SQUEEZE_FIRES = {3: (16, 64, 64), 4: (16, 128, 64), 6: (32, 128, 128),
                  7: (32, 256, 128), 9: (48, 256, 192), 10: (48, 384, 192),
                  11: (64, 384, 256), 12: (64, 512, 256)}


def random_lpips_params(seed: int = 0, net: str = "vgg") -> dict:
    """Random-init LPIPS parameters (trunk + heads) for tests and smoke
    runs: numpy HWIO, drawn exactly as the JAX package's
    ``random_lpips_params`` (``compat.params_from_jax`` carries them
    across)."""
    rng = as_rng(seed + 1)

    def conv(co, ci, k):
        w = (rng.standard_normal((k, k, ci, co))
             * np.sqrt(2.0 / (k * k * ci))).astype(np.float32)
        return w, (rng.standard_normal(co) * 0.01).astype(np.float32)

    if net == "vgg":
        params = init_params(seed, VGG16_CFG, LPIPS_VGG16_TAPS[-1])
    elif net == "alex":
        params = {}
        for i, (co, ci, k) in _ALEX_CONVS.items():
            w, b = conv(co, ci, k)
            params[f"features.{i}.weight"] = w
            params[f"features.{i}.bias"] = b
    elif net == "squeeze":
        params = {}
        w, b = conv(64, 3, 3)
        params["features.0.weight"] = w
        params["features.0.bias"] = b
        for i, (sq, ci, ex) in _SQUEEZE_FIRES.items():
            for name, (co, cin, k) in (("squeeze", (sq, ci, 1)),
                                       ("expand1x1", (ex, sq, 1)),
                                       ("expand3x3", (ex, sq, 3))):
                w, b = conv(co, cin, k)
                params[f"features.{i}.{name}.weight"] = w
                params[f"features.{i}.{name}.bias"] = b
    else:
        raise ValueError(net)
    for k, c in enumerate(LPIPS_CHANNELS_BY_NET[net]):
        params[f"lin{k}.weight"] = np.abs(
            rng.standard_normal((1, 1, c, 1))).astype(np.float32) * 0.1
    return params


# ------------------------------------------------ FakeNet baselines
# lpips/lpips.py:241-280 — non-learned metric stand-ins, on the host.

def rgb2lab(rgb_uint8: np.ndarray) -> np.ndarray:
    """sRGB (HWC uint8/0–255 float) → CIELAB D65, matching skimage.color
    (used by lpips.tensor2tensorlab)."""
    rgb = np.asarray(rgb_uint8, np.float64) / 255.0
    linear = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    m = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    xyz = linear @ m.T
    xyz /= np.array([0.95047, 1.0, 1.08883])
    d = 6.0 / 29.0
    f = np.where(xyz > d ** 3, np.cbrt(xyz), xyz / (3 * d * d) + 4.0 / 29.0)
    lab = np.empty_like(f)
    lab[..., 0] = 116.0 * f[..., 1] - 16.0
    lab[..., 1] = 500.0 * (f[..., 0] - f[..., 1])
    lab[..., 2] = 200.0 * (f[..., 1] - f[..., 2])
    return lab


def _ssim_uniform(a, b, data_range, win=7):
    """skimage compare_ssim semantics: per-channel uniform-window SSIM with
    sample covariance, edge-cropped mean (lpips/__init__.py:22-24 dssim)."""
    from scipy.ndimage import uniform_filter

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    pad = (win - 1) // 2
    npix = win * win
    cov_norm = npix / (npix - 1.0)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        ux = uniform_filter(x, win)
        uy = uniform_filter(y, win)
        uxx = uniform_filter(x * x, win)
        uyy = uniform_filter(y * y, win)
        uxy = uniform_filter(x * y, win)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)
             / ((ux * ux + uy * uy + c1) * (vx + vy + c2)))
        vals.append(s[pad:-pad or None, pad:-pad or None].mean())
    return float(np.mean(vals))


def l2_baseline(img0_255, img1_255, colorspace: str = "Lab") -> float:
    """FakeNet L2 (lpips/lpips.py:250-264): 0.5·mean((a−b)/range)² in RGB
    (range 255) or Lab (range 100)."""
    if colorspace == "RGB":
        a = np.asarray(img0_255, np.float64) / 255.0
        b = np.asarray(img1_255, np.float64) / 255.0
    else:
        a = rgb2lab(img0_255) / 100.0
        b = rgb2lab(img1_255) / 100.0
    return float(0.5 * np.mean((a - b) ** 2))


def dssim_baseline(img0_255, img1_255, colorspace: str = "Lab") -> float:
    """FakeNet DSSIM (lpips/lpips.py:267-280): (1 − SSIM)/2 in RGB
    (data_range 255) or Lab (data_range 100)."""
    if colorspace == "RGB":
        s = _ssim_uniform(np.asarray(img0_255, np.float64),
                          np.asarray(img1_255, np.float64), 255.0)
    else:
        s = _ssim_uniform(rgb2lab(img0_255), rgb2lab(img1_255), 100.0)
    return float((1.0 - s) / 2.0)
