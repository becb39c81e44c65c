"""Image-space math.  Counterpart of ``vst_tpu/ops/image.py``
(``vgg_normalize``; parity: ReCoNet/utilities.py:101-106,
AdaAttN/utilities.py:78-85)."""

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x/255 − mean) / std with ImageNet statistics, for a 0–255 NHWC RGB
    tensor: computed in float32, returned in x's dtype."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x.float() / 255.0 - mean) / std).to(x.dtype)
