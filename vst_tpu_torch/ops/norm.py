"""Instance normalization (NHWC).  Counterpart of ``vst_tpu/ops/norm.py``:
torch InstanceNorm2d defaults (eps 1e-5, biased variance, no running
stats), statistics in float32 whatever the input dtype, and in float64
for float64 input (the exact evaluation a card check compares with)."""

import torch


def instance_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """Normalize each (sample, channel) plane over H, W.  x: (N, H, W, C);
    scale/bias: (C,) or None."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    out = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    if scale is not None:
        out = out * scale.to(acc)
    if bias is not None:
        out = out + bias.to(acc)
    return out.to(x.dtype)
