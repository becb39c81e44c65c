"""Convolutions and pooling (NHWC activations, OIHW weights as the
reference's ``state_dict`` stores them).

Counterpart of ``vst_tpu/ops/conv.py``.  The JAX forms there
(``conv2d_reflect1_k3s1``, ``conv2d_reflect1_k3s2``,
``conv2d_nearest_up2``) are XLA layout rewrites of "reflect-pad, then
convolve"; the port computes the same function directly.  The 9×9
layers keep the JAX package's f=4 polyphase packing, because the packed
3×3 VALID conv is what kernel K2 (``kernels/head_conv.py``) computes.

Each layer takes ``spatial=``, a ``parallel/spatial.py::SpatialContext``:
x is then this rank's block of an H-sharded frame, its first row at level
0 a multiple of the entry's unit (``row_layout``), and the layer takes the
rows it reads beyond the block from its neighbours, padding only at the
frame's global edges.  Every block but the last holds whole units, so
only the bottom block can hold an odd count of rows at some level, and it
is padded there as the unsharded layer pads the frame:

- reflect k×k stride 1: k//2 rows a side, reflected at an edge;
- reflect 3×3 stride 2: 1 row above and none below (every block's start
  even); an odd bottom block also one row below, reflected at the edge;
- 9×9 through K2: 4 rows a side, packed with the block (any R, the zero
  rows the packing adds below feeding only outputs that are cut);
- nearest ×2 + reflect 3×3: 1 upsampled row a side, repeated at an edge
  (the upsampled frame's reflection);
- transposed conv k3 s2 p1 op1: 1 row below, zero at the bottom edge;
- zero-padded conv: p rows above and k−1−p below, zero at an edge;
- max pool 2×2 s2: none (every block's start even; an odd bottom block
  floors at the edge, as the unsharded pool floors the frame).

The W border is padded as in the unsharded layer, in the same copy as the
rows (``parallel/spatial.py::exchange_rows``), so the conv reads the layout
the unsharded layer's padded copy has.  Every sharded layer
differentiates: the exchange's backward carries the halo rows' gradients
back to their ranks, and the conv's own backward is autograd's (K2's
Function for the 9×9).
"""

import torch
import torch.nn.functional as F

from vst_tpu_torch.kernels.head_conv import conv3x3_valid
from vst_tpu_torch.ops.pad import reflection_pad2d
from vst_tpu_torch.ops.resize import upsample_nearest


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def _sp():
    """``parallel/spatial.py``, imported at call time (``parallel``
    imports the models, which import this module)."""
    from vst_tpu_torch.parallel import spatial

    return spatial


def _check_whole(spatial, rows, k, what):
    """A block other than the bottom one must hold whole windows of ``k``
    rows (the layout gives it whole units)."""
    if rows % k and not spatial.last:
        raise ValueError(f"{what}: a block of {rows} rows that is not the "
                         f"frame's last must divide by {k}")


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride: int = 1, padding: int = 0, spatial=None) -> torch.Tensor:
    """torch Conv2d semantics (symmetric zero ``padding``) on NHWC input
    with OIHW weights → NHWC: the VGG convs and AdaAttN's 1×1 convs.
    ``spatial``: x is a row block (stride 1; module docstring)."""
    if spatial is None:
        return _nhwc(F.conv2d(_nchw(x), w, b, stride=stride,
                              padding=padding))
    sp = _sp()
    if stride != 1:
        raise ValueError("conv2d over a row block: stride 1 only")
    k = w.shape[2]
    xp = sp.exchange_rows(spatial, x, padding, k - 1 - padding, "zero", padding,
                     "zero")
    return _nhwc(F.conv2d(_nchw(xp), w, b))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None, stride: int = 2,
                     padding: int = 1, output_padding: int = 1,
                     spatial=None) -> torch.Tensor:
    """``torch.nn.ConvTranspose2d`` on NHWC input with torch's (I, O, kh,
    kw) weights → NHWC; output size (in − 1)·stride − 2·padding + k +
    output_padding (RTNSTV's Deconv, k 3, s 2, p 1, op 1: 2× upsampling).
    The JAX package leaves it to XLA (``vst_tpu/ops/conv.py:57-90``).

    ``spatial`` (k 3, s 2, p 1, op 1 only): output row 2i+1 of the block's
    last input row i reads row i+1, the next block's first (zero below the
    frame: the output_padding row), so the block takes one row from below,
    and the 2R + 1 rows out are cut to 2R."""
    if spatial is None:
        return _nhwc(F.conv_transpose2d(_nchw(x), w, b, stride=stride,
                                        padding=padding,
                                        output_padding=output_padding))
    sp = _sp()
    if (w.shape[2], stride, padding, output_padding) != (3, 2, 1, 1):
        raise ValueError("conv_transpose2d over a row block: k 3, stride 2, "
                         "padding 1, output_padding 1 only")
    r = x.shape[1]
    xh = sp.exchange_rows(spatial, x, 0, 1, "zero")
    y = F.conv_transpose2d(_nchw(xh), w, b, stride=2, padding=1,
                           output_padding=(0, 1))
    return _nhwc(y[:, :, :2 * r])


def max_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2,
               spatial=None) -> torch.Tensor:
    """``torch.nn.MaxPool2d(window, stride)`` (VALID) on NHWC.  Over a row
    block (``spatial``) each window lies in the block when window ==
    stride and the block starts on a multiple of it; the bottom block's
    rows need not divide (the pool floors at the frame's edge)."""
    if spatial is not None:
        if window != stride:
            raise ValueError("max_pool2d over a row block: window == stride "
                             "only")
        _check_whole(spatial, x.shape[1], stride, "max_pool2d")
    return _nhwc(F.max_pool2d(_nchw(x), window, stride))


def conv2d_reflect(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None,
                   stride: int = 1, spatial=None) -> torch.Tensor:
    """Reflect-pad k//2, then a k×k conv: ReCoNet's ConvLayer and AdaAttN's
    ``Conv`` (AdaAttN/network.py:11-21).  x NHWC, w OIHW → NHWC.
    ``spatial``: x is a row block (stride 1, or 3×3 stride 2)."""
    pad = w.shape[-1] // 2
    if spatial is None:
        xp = reflection_pad2d(x, pad)
        return _nhwc(F.conv2d(_nchw(xp), w, b, stride=stride))
    sp = _sp()
    if stride == 1:
        above = below = pad
    elif stride == 2 and w.shape[-1] == 3:
        # output row y reads input rows 2y-1 … 2y+1: with the block's
        # first row even, one row above, and none below but on an odd
        # bottom block, whose last output reads the reflected row under it
        r = x.shape[1]
        _check_whole(spatial, r, 2, "stride-2 conv2d_reflect")
        above = 1
        below = [0] * (spatial.size - 1) + [r % 2 if spatial.last else 0]
    else:
        raise ValueError("conv2d_reflect over a row block: stride 1, or a "
                         "3×3 kernel at stride 2")
    xp = sp.exchange_rows(spatial, x, above, below, "reflect", pad)
    return _nhwc(F.conv2d(_nchw(xp), w, b, stride=stride))


def conv2d_nearest_up2(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor | None = None,
                       spatial=None) -> torch.Tensor:
    """ReCoNet's UpsampleConvLayer body: nearest ×2, reflect-pad 1, 3×3.
    ``spatial``: the upsampled block takes one upsampled row a side from
    its neighbours; at a global edge the edge row repeats, which is the
    upsampled frame's reflection (its rows 0 and 1 are equal)."""
    up = upsample_nearest(x, 2)
    if spatial is None:
        return conv2d_reflect(up, w, b)
    sp = _sp()
    return _nhwc(F.conv2d(_nchw(sp.exchange_rows(spatial, up, 1, 1, "clamp", 1)),
                          w, b))


def polyphase_weights(w: torch.Tensor, f: int) -> torch.Tensor:
    """OIHW k×k weights → the packed HWIO (t, t, f²·Cin, f²·Cout) form:
    W2[di, dj, (p, q, cin), (a, b, cout)] = w[f·di+p−a, f·dj+q−b], zero
    outside [0, k).  Channel order is (row phase, column phase, c), c
    fastest, as ``vst_tpu/ops/conv.py::_polyphase_weights``."""
    cout, cin, k, _ = w.shape
    t = (k + f - 2) // f + 1
    pad = f - 1
    hwio = w.permute(2, 3, 1, 0)
    w_pad = F.pad(hwio, (0, 0, 0, 0, pad, pad, pad, pad))
    di = torch.arange(t)[:, None, None]
    p = torch.arange(f)[None, :, None]
    a = torch.arange(f)[None, None, :]
    idx = (f * di + p - a + pad).reshape(-1).to(w.device)
    g = w_pad[idx].reshape(t, f, f, k + 2 * pad, cin, cout)
    g = g[:, :, :, idx].reshape(t, f, f, t, f, f, cin, cout)
    # [di, p, a, dj, q, b, c, o] → [di, dj, (p, q, c), (a, b, o)]
    return g.permute(0, 3, 1, 4, 6, 2, 5, 7).reshape(
        t, t, f * f * cin, f * f * cout).contiguous()


def conv2d_polyphase_reflect(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor | None = None,
                             factor: int = 4, spatial=None) -> torch.Tensor:
    """Reflect-pad k//2 then a k×k stride-1 conv (k = 2f+1), computed as a
    3×3 VALID conv over the f×-space-to-depth packed input (K2).

    With pad = k//2 = f, reflect-padding by f and packing f×f pixels per
    channel group gives exactly the packed tensor the JAX form builds by
    phase shuffling (``vst_tpu/ops/conv.py:202-226``).  An H or W that is
    not a multiple of f gets zero rows/columns below and right of the
    padded input; the outputs they feed lie outside (H, W) and are cut
    off, so every size goes through the same kernel.

    ``spatial``: x is a row block of R rows, any R; its f rows a side
    come from the neighbours (reflected at a global edge, which needs
    R > f) and are packed with it, so K2 runs unchanged; where R is not a
    multiple of f the packing's zero rows lie below those f rows and feed
    only outputs that are cut, as in the unsharded frame."""
    f = factor
    cout, cin, k, _ = w.shape
    if k != 2 * f + 1:
        raise ValueError(f"polyphase reflect conv needs k == 2f+1, got "
                         f"k={k}, f={f}")
    n, h, wd, _ = x.shape
    hq, wq = -(-h // f), -(-wd // f)
    if spatial is None:
        xp = reflection_pad2d(x, f)
    else:
        xp = _sp().exchange_rows(spatial, x, f, f, "reflect", f)
    if (hq * f, wq * f) != (h, wd):
        xp = F.pad(xp, (0, 0, 0, wq * f - wd, 0, hq * f - h))
    packed = xp.reshape(n, hq + 2, f, wq + 2, f, cin).permute(
        0, 1, 3, 2, 4, 5).reshape(n, hq + 2, wq + 2, f * f * cin)
    out = conv3x3_valid(packed.contiguous(), polyphase_weights(w, f))
    out = out.reshape(n, hq, wq, f, f, cout).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, hq * f, wq * f, cout)[:, :h, :wd]
    if b is not None:
        out = out + b.to(out.dtype)
    return out.contiguous()
