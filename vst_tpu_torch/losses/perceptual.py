"""Counterpart of ``vst_tpu/losses/perceptual.py``: ``mse`` (the content,
style and regularization losses of ReCoNet and RTNSTV come with their
slices)."""

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.nn.MSELoss(reduction="mean"), taken in float32."""
    return torch.mean(torch.square(a.float() - b.float()))
