"""Image-space math.  Counterpart of ``vst_tpu/ops/image.py``:

- ``vgg_normalize``: ReCoNet/utilities.py:101-106, AdaAttN/utilities.py:78-85;
- ``gram_matrix``: ReCoNet/utilities.py:93-98, normalized by C·H·W;
- ``gram_matrix_hw``: RTNSTV/utilities.py:155-160, normalized by H·W;
- ``rgb_to_luma709``: ReCoNet/train_single/train_candy.py:114.

Grams and luma accumulate in float32 (float64 for float64 inputs).  The
Gram's float32 product is exact float32: cuBLAS's TF32 is off, torch's
default, and ``device.apply_precision`` keeps it off for float32 work."""

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x/255 − mean) / std with ImageNet statistics, for a 0–255 NHWC RGB
    tensor: computed in float32 (float64 for float64 input), returned in
    x's dtype."""
    acc = _acc_dtype(x)
    mean = torch.tensor(IMAGENET_MEAN, dtype=acc, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=acc, device=x.device)
    return ((x.to(acc) / 255.0 - mean) / std).to(x.dtype)


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _gram(y: torch.Tensor) -> torch.Tensor:
    n, h, w, c = y.shape
    f = y.reshape(n, h * w, c).to(_acc_dtype(y))
    return torch.matmul(f.transpose(1, 2), f)


def _gram_over(y: torch.Tensor, scale: int, spatial) -> torch.Tensor:
    """FᵀF / (scale·H·W); with ``spatial`` (``parallel/spatial.py``) y is
    this rank's row block: its FᵀF all-reduced over the axis, with the
    block's H·W riding on the same all-reduce where the layout is uneven
    (``all_reduce_sum_count``), then divided by the frame's scale·H·W, so
    every rank holds the frame's Gram (the all-reduce's backward gives
    each block its gradient)."""
    _, h, w, _ = y.shape
    if spatial is None:
        return _gram(y) / (scale * h * w)
    from vst_tpu_torch.parallel.spatial import all_reduce_sum_count

    total, count = all_reduce_sum_count(spatial, _gram(y), h * w)
    return total / (scale * count)


def gram_matrix(y: torch.Tensor, spatial=None) -> torch.Tensor:
    """(N, C, C) Gram matrix of NHWC features / (C·H·W), ReCoNet's; of
    the frame with ``spatial`` (``_gram_over``)."""
    return _gram_over(y, y.shape[3], spatial)


def gram_matrix_hw(y: torch.Tensor, spatial=None) -> torch.Tensor:
    """(N, C, C) Gram matrix of NHWC features / (H·W), RTNSTV's; of the
    frame with ``spatial`` (``_gram_over``)."""
    return _gram_over(y, 1, spatial)


def rgb_to_luma709(x: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of an NHWC RGB tensor → (N, H, W)."""
    acc = _acc_dtype(x)
    wts = torch.tensor([0.2126, 0.7152, 0.0722], dtype=acc, device=x.device)
    return (x.to(acc) * wts).sum(dim=-1)
