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


def gram_matrix(y: torch.Tensor) -> torch.Tensor:
    """(N, C, C) Gram matrix of NHWC features / (C·H·W), ReCoNet's."""
    _, h, w, c = y.shape
    return _gram(y) / (c * h * w)


def gram_matrix_hw(y: torch.Tensor) -> torch.Tensor:
    """(N, C, C) Gram matrix of NHWC features / (H·W), RTNSTV's."""
    _, h, w, _ = y.shape
    return _gram(y) / (h * w)


def rgb_to_luma709(x: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance of an NHWC RGB tensor → (N, H, W)."""
    acc = _acc_dtype(x)
    wts = torch.tensor([0.2126, 0.7152, 0.0722], dtype=acc, device=x.device)
    return (x.to(acc) * wts).sum(dim=-1)
