"""Gram-matrix style distance (parity: AdaAttN/eval.py:70-108).

Counterpart of ``vst_tpu/eval/gram.py``: the MSE between /(H·W)-
normalized VGG19 Grams over the five relu*_1 taps, averaged over taps.
Inputs are 0–255 NHWC RGB tensors; the VGG19 (``models/vgg.py::
VGG19AdaAttN``) runs in its parameters' dtype, float32 for the metric.
"""

import torch

from vst_tpu_torch.ops.image import gram_matrix_hw


@torch.inference_mode()
def gram_loss_5tap(vgg, img: torch.Tensor, style: torch.Tensor
                   ) -> torch.Tensor:
    p = next(vgg.parameters())
    fcs = vgg(img.to(p.device, p.dtype))
    fs = vgg(style.to(p.device, p.dtype))
    loss = 0.0
    for tap in fcs:
        g1 = gram_matrix_hw(fcs[tap])
        g2 = gram_matrix_hw(fs[tap])
        loss = loss + torch.mean(torch.square(g1 - g2))
    return loss / 5.0
