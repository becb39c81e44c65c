"""RAFT optical flow (Teed & Deng, ECCV 2020), torchvision's ``raft_large``.

Counterpart of ``vst_tpu/models/raft.py``.  The reference runs
torchvision's frozen ``raft_large`` to generate flow for the AdaAttN
Sintel experiments (AdaAttN/datasets.py:73-96) and the video experiments
(exps_video.py:42).  The architecture:

- feature encoder (instance norm): 7×7/2 conv → residual layers
  64,64 / 96,96(↓2) / 128,128(↓2) → 1×1 conv to 256, at 1/8 resolution
- context encoder: same shape with batch norm (inference statistics),
  output split into hidden (tanh, 128) and context (relu, 128)
- 4-level all-pairs correlation pyramid (⟨f1, f2⟩/√D, 2× average pooling),
  radius-4 bilinear lookup → 4·9² correlation features per pixel
- recurrent update: motion encoder → two separable (1×5)/(5×1) ConvGRUs →
  flow head; convex 8× upsampling with a predicted 3×3 combination mask.

Parameters: a dict of tensors keyed as the JAX package keys them
(``vst_tpu/models/raft.py:44-117``), torch layout (OIHW), from
``compat.params_from_jax`` of its ``.npz`` or ``compat_raft`` of a
torchvision checkpoint.  Activations are NHWC at every function, as in
the JAX package.  Everything runs in float32 with TF32 off (the JAX
package's full float32); the correlation volume is one ``bmm`` — JAX's
``einsum`` outside any kernel — and the window lookup a pixel-space
gather, which stays defined where a level is 1 px wide (``F.grid_sample``'s
normalized grid divides by w − 1 there): the levels laid end to end, all
four levels' corners of an iteration in one gather.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from vst_tpu_torch.compat import params_from_jax
from vst_tpu_torch.device import apply_precision, resolve_device
from vst_tpu_torch.models.init import as_rng
from vst_tpu_torch.ops.conv import conv2d
from vst_tpu_torch.ops.norm import instance_norm

HIDDEN = 128
CONTEXT = 128
CORR_LEVELS = 4
CORR_RADIUS = 4


# ------------------------------------------------------------ param init

def _conv_p(rng, name, cin, cout, k):
    fan_in = cin * k * k
    bound = 1.0 / np.sqrt(fan_in)
    return {
        f"{name}.weight": rng.uniform(-bound, bound,
                                      (k, k, cin, cout)).astype(np.float32),
        f"{name}.bias": rng.uniform(-bound, bound, cout).astype(np.float32),
    }


def _norm_p(name, ch, kind):
    if kind == "instance":
        return {}
    return {
        f"{name}.weight": np.ones(ch, np.float32),
        f"{name}.bias": np.zeros(ch, np.float32),
        f"{name}.running_mean": np.zeros(ch, np.float32),
        f"{name}.running_var": np.ones(ch, np.float32),
    }


_ENCODER_LAYERS = [  # (layer name, in, out, stride)
    ("layer1.0", 64, 64, 1), ("layer1.1", 64, 64, 1),
    ("layer2.0", 64, 96, 2), ("layer2.1", 96, 96, 1),
    ("layer3.0", 96, 128, 2), ("layer3.1", 128, 128, 1),
]


def _encoder_params(rng, prefix, out_ch, norm_kind):
    p = {}
    p.update(_conv_p(rng, f"{prefix}.conv1", 3, 64, 7))
    p.update(_norm_p(f"{prefix}.norm1", 64, norm_kind))
    for name, cin, cout, stride in _ENCODER_LAYERS:
        base = f"{prefix}.{name}"
        p.update(_conv_p(rng, f"{base}.conv1", cin, cout, 3))
        p.update(_norm_p(f"{base}.norm1", cout, norm_kind))
        p.update(_conv_p(rng, f"{base}.conv2", cout, cout, 3))
        p.update(_norm_p(f"{base}.norm2", cout, norm_kind))
        if stride != 1 or cin != cout:
            p.update(_conv_p(rng, f"{base}.downsample", cin, cout, 1))
            p.update(_norm_p(f"{base}.downsample_norm", cout, norm_kind))
    p.update(_conv_p(rng, f"{prefix}.conv2", 128, out_ch, 1))
    return p


def init_raft_numpy(seed=0) -> dict:
    """The JAX package's ``init_raft(seed)``: numpy, HWIO, the same draws
    in the same order."""
    rng = as_rng(seed)
    p = {}
    p.update(_encoder_params(rng, "fnet", 256, "instance"))
    p.update(_encoder_params(rng, "cnet", HIDDEN + CONTEXT, "batch"))
    corr_ch = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
    p.update(_conv_p(rng, "update.enc.convc1", corr_ch, 256, 1))
    p.update(_conv_p(rng, "update.enc.convc2", 256, 192, 3))
    p.update(_conv_p(rng, "update.enc.convf1", 2, 128, 7))
    p.update(_conv_p(rng, "update.enc.convf2", 128, 64, 3))
    p.update(_conv_p(rng, "update.enc.conv", 192 + 64, 128 - 2, 3))
    gin = HIDDEN + (CONTEXT + 128)
    for tag, kh, kw in (("h", 1, 5), ("v", 5, 1)):
        for gate in ("z", "r", "q"):
            name = f"update.gru.conv{gate}{tag}"
            fan = gin * kh * kw
            bound = 1.0 / np.sqrt(fan)
            p[f"{name}.weight"] = rng.uniform(
                -bound, bound, (kh, kw, gin, HIDDEN)).astype(np.float32)
            p[f"{name}.bias"] = rng.uniform(-bound, bound,
                                            HIDDEN).astype(np.float32)
    p.update(_conv_p(rng, "update.flow.conv1", HIDDEN, 256, 3))
    p.update(_conv_p(rng, "update.flow.conv2", 256, 2, 3))
    p.update(_conv_p(rng, "update.mask.conv1", HIDDEN, 256, 3))
    p.update(_conv_p(rng, "update.mask.conv2", 256, 64 * 9, 1))
    return p


def init_raft(seed=0, device="cuda") -> dict:
    """The JAX package's ``init_raft(seed)`` in torch layout on ``device``
    (tests and smoke runs: the repository holds no pretrained weights)."""
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in
            params_from_jax(init_raft_numpy(seed)).items()}


# ------------------------------------------------------------- encoders

def _conv(params, name, x, stride=1, padding=0):
    return conv2d(x, params[f"{name}.weight"], params[f"{name}.bias"],
                  stride=stride, padding=padding)


def _norm(params, name, x, kind):
    if kind == "instance":
        return instance_norm(x)
    mean = params[f"{name}.running_mean"]
    var = params[f"{name}.running_var"]
    scale = params[f"{name}.weight"]
    bias = params[f"{name}.bias"]
    inv = scale * torch.rsqrt(var + 1e-5)
    return (x - mean) * inv + bias


def _res_block(params, base, x, stride, kind):
    y = _conv(params, f"{base}.conv1", x, stride=stride, padding=1)
    y = torch.relu(_norm(params, f"{base}.norm1", y, kind))
    y = _conv(params, f"{base}.conv2", y, padding=1)
    y = torch.relu(_norm(params, f"{base}.norm2", y, kind))
    if f"{base}.downsample.weight" in params:
        x = _conv(params, f"{base}.downsample", x, stride=stride)
        x = _norm(params, f"{base}.downsample_norm", x, kind)
    return torch.relu(x + y)


def _encoder(params, prefix, x, kind):
    x = _conv(params, f"{prefix}.conv1", x, stride=2, padding=3)
    x = torch.relu(_norm(params, f"{prefix}.norm1", x, kind))
    for name, _, _, stride in _ENCODER_LAYERS:
        x = _res_block(params, f"{prefix}.{name}", x, stride, kind)
    return _conv(params, f"{prefix}.conv2", x)


# ----------------------------------------------------------- correlation

def build_corr_pyramid(f1, f2, num_levels=CORR_LEVELS):
    """All-pairs correlation pyramid.

    f1/f2: (N, H, W, C) at 1/8 resolution → list of (N·H·W, h_l, w_l)
    volumes, level 0 full resolution, each next 2× average-pooled.
    """
    n, h, w, c = f1.shape
    a = f1.reshape(n, h * w, c).float()
    b = f2.reshape(n, h * w, c).float()
    corr = torch.bmm(a, b.transpose(1, 2)) / math.sqrt(c)
    corr = corr.reshape(n * h * w, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        hh, ww = corr.shape[1] // 2, corr.shape[2] // 2
        corr = corr[:, :hh * 2, :ww * 2]
        corr = corr.reshape(corr.shape[0], hh, 2, ww, 2).mean(dim=(2, 4))
        pyramid.append(corr)
    return pyramid


def _gather_bilinear(flat, xy, h, w, base):
    """Bilinear samples at pixel coordinates of images laid end to end.

    flat: (B, T); xy: (B, Q, 2) (x, y) pixel coordinates; h, w, base: the
    height, width and offset in ``flat`` of the image each point samples
    (ints, or (Q,) integer tensors) → (B, Q), zeros padding.  The four
    corners of every point go through one gather, and their terms are
    summed in the JAX package's order: (0, 0), (0, 1), (1, 0), (1, 1)."""
    b, q = xy.shape[:2]
    if flat.shape[1] == 0:
        return torch.zeros((b, q), dtype=torch.float32, device=flat.device)
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    xi = torch.stack([x0, x0 + 1, x0, x0 + 1])
    yi = torch.stack([y0, y0, y0 + 1, y0 + 1])
    wgt = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                       wx * wy])
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = torch.where(valid, base + yi * w + xi, 0)
    vals = torch.gather(flat, 1, idx.transpose(0, 1).reshape(b, 4 * q))
    t = vals.reshape(b, 4, q).transpose(0, 1) * torch.where(valid, wgt, 0.0)
    return t[0] + t[1] + t[2] + t[3]


def _sample_bilinear_pixel(img, xy):
    """img: (B, h, w); xy: (B, P, 2) pixel coords → (B, P); zeros padding
    (an empty level, below 8 px at 1/8 resolution, samples zeros)."""
    b, h, w = img.shape
    return _gather_bilinear(img.reshape(b, h * w), xy, h, w, 0)


def _window(radius, device):
    """(P, 2) window offsets as (dx, dy), x-offset MAJOR: torchvision's
    CorrBlock.index_pyramid enumerates meshgrid(di, dj, indexing="ij")
    with delta[..., 0] paired with x, so flat index i·(2r+1)+j has
    (dx, dy) = (di[i], dj[j]).  The order fixes which update.enc.convc1
    input channel sees which offset (pretrained-weight parity)."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    gi, gj = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([gi, gj], dim=-1).reshape(-1, 2)


def _flatten_pyramid(pyramid, radius=CORR_RADIUS):
    """The pyramid's levels laid end to end for one gather over all of
    them: (flat (B, T), then per window point, level-major, its level's
    height, width and offset in ``flat`` ((L·P,) each), the levels' scales
    2^l (L, 1, 1) and the window offsets (P, 2))."""
    dev = pyramid[0].device
    p = (2 * radius + 1) ** 2
    flat = torch.cat([c.reshape(c.shape[0], -1) for c in pyramid], dim=1)
    hs = [c.shape[1] for c in pyramid]
    ws = [c.shape[2] for c in pyramid]
    bases = np.cumsum([0] + [h * w for h, w in zip(hs, ws)])[:-1]

    def per_point(v):
        return torch.tensor(np.asarray(v, np.int64),
                            device=dev).repeat_interleave(p)

    scales = torch.tensor([2.0 ** lvl for lvl in range(len(pyramid))],
                          device=dev).reshape(-1, 1, 1)
    return (flat, per_point(hs), per_point(ws), per_point(bases), scales,
            _window(radius, dev))


def _lookup(levels, coords):
    """``lookup_corr`` on a ``_flatten_pyramid``: one gather a call."""
    flat, hs, ws, bases, scales, d = levels
    n, h, w, _ = coords.shape
    c = coords.reshape(n * h * w, 1, 1, 2) / scales[None]
    pts = (c + d[None, None]).reshape(n * h * w, -1, 2)
    return _gather_bilinear(flat, pts, hs, ws, bases).reshape(n, h, w, -1)


def lookup_corr(pyramid, coords, radius=CORR_RADIUS):
    """Sample (2r+1)² correlation windows around ``coords`` at each level.

    coords: (N, H, W, 2) current target positions in level-0 pixel units.
    Returns (N, H, W, num_levels·(2r+1)²), level-major.
    """
    return _lookup(_flatten_pyramid(pyramid, radius), coords)


# ---------------------------------------------------------------- update

def _motion_encoder(params, corr_feat, flow):
    c = torch.relu(_conv(params, "update.enc.convc1", corr_feat))
    c = torch.relu(_conv(params, "update.enc.convc2", c, padding=1))
    f = torch.relu(_conv(params, "update.enc.convf1", flow, padding=3))
    f = torch.relu(_conv(params, "update.enc.convf2", f, padding=1))
    m = torch.relu(_conv(params, "update.enc.conv", torch.cat([c, f], dim=-1),
                         padding=1))
    return torch.cat([m, flow], dim=-1)              # 128 channels


def _sep_conv_gru(params, h, x):
    """(1,5) then (5,1) ConvGRU passes."""
    h = _gru_pass(params, "h", (0, 2), h, x)
    return _gru_pass(params, "v", (2, 0), h, x)


def _gru_pass(params, tag, pad_hw, h, x):
    hx = torch.cat([h, x], dim=-1)
    z = torch.sigmoid(_conv(params, f"update.gru.convz{tag}", hx,
                            padding=pad_hw))
    r = torch.sigmoid(_conv(params, f"update.gru.convr{tag}", hx,
                            padding=pad_hw))
    q = torch.tanh(_conv(params, f"update.gru.convq{tag}",
                         torch.cat([r * h, x], dim=-1), padding=pad_hw))
    return (1 - z) * h + z * q


def _flow_head(params, h):
    y = torch.relu(_conv(params, "update.flow.conv1", h, padding=1))
    return _conv(params, "update.flow.conv2", y, padding=1)


def _upsample_mask(params, h):
    y = torch.relu(_conv(params, "update.mask.conv1", h, padding=1))
    return 0.25 * _conv(params, "update.mask.conv2", y)


def convex_upsample(flow, mask):
    """8× convex upsampling: softmax-weighted 3×3 neighborhood combination.

    flow: (N, H, W, 2) coarse; mask: (N, H, W, 9·64) → (N, 8H, 8W, 2).

    Mask channel layout matches torchvision's ``upsample_flow``
    (``up_mask.view(b, 1, 9, 8, 8, h, w)``): channel = k·64 + a·8 + b with
    k the 3×3 neighbor (row-major, F.unfold order), (a, b) the sub-pixel
    (row, col).  Load-bearing for pretrained update.mask.conv2 weights.
    """
    n, h, w, _ = flow.shape
    m = torch.softmax(mask.reshape(n, h, w, 9, 8, 8), dim=3)
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    patches = torch.stack(
        [fp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
        dim=-2)                                     # (N, H, W, 9, 2)
    up = torch.einsum("nhwkab,nhwkc->nhwabc", m, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(n, 8 * h, 8 * w, 2)


# ----------------------------------------------------------------- model

@torch.inference_mode()
def raft_flow(params_or_module, img1, img2, iters: int = 12):
    """Estimate optical flow img1→img2.

    ``params_or_module``: the parameter dict (or a module whose
    ``state_dict`` holds it).  img1/img2: (N, H, W, 3) in [-1, 1] (the
    reference's raftTransforms, AdaAttN/utilities.py:21-28), numpy or
    tensors, H and W divisible by 8; they go to the parameters' device.
    Returns the final upsampled (N, H, W, 2) flow there (the reference
    always takes ``raft(...)[-1]``).
    """
    params = params_or_module
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    apply_precision(torch.float32)
    dev = params["fnet.conv1.weight"].device
    img1 = torch.as_tensor(img1).to(dev, torch.float32)
    img2 = torch.as_tensor(img2).to(dev, torch.float32)
    n, h, w, _ = img1.shape
    # the two images through the feature encoder as one batch: instance
    # norm is per image, so this is the per-image function
    f1, f2 = _encoder(params, "fnet", torch.cat([img1, img2]),
                      "instance").split(n)
    levels = _flatten_pyramid(build_corr_pyramid(f1, f2))

    ctx = _encoder(params, "cnet", img1, "batch")
    hidden = torch.tanh(ctx[..., :HIDDEN])
    context = torch.relu(ctx[..., HIDDEN:])

    h8, w8 = h // 8, w // 8
    gy, gx = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=dev),
                            torch.arange(w8, dtype=torch.float32, device=dev),
                            indexing="ij")
    coords0 = torch.stack([gx, gy], -1)[None].expand(n, h8, w8, 2)
    coords1 = coords0
    for _ in range(iters):
        corr_feat = _lookup(levels, coords1)
        flow = coords1 - coords0
        motion = _motion_encoder(params, corr_feat, flow)
        hidden = _sep_conv_gru(params, hidden,
                               torch.cat([context, motion], dim=-1))
        coords1 = coords1 + _flow_head(params, hidden)
    mask = _upsample_mask(params, hidden)
    return convex_upsample(coords1 - coords0, mask)
