"""Instance normalization (NHWC).  Counterpart of ``vst_tpu/ops/norm.py``:
torch InstanceNorm2d defaults (eps 1e-5, biased variance, no running
stats), statistics in float32 whatever the input dtype, and in float64
for float64 input (the exact evaluation a card check compares with)."""

import torch


def instance_norm(x: torch.Tensor, scale: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None,
                  eps: float = 1e-5, spatial=None) -> torch.Tensor:
    """Normalize each (sample, channel) plane over H, W.  x: (N, H, W, C);
    scale/bias: (C,) or None.

    ``spatial`` (``parallel/spatial.py``): x is this rank's row block; the
    block's Σx is all-reduced over the axis into the frame's mean, then
    its Σ(x − mean)² into the variance: the unsharded two passes, two
    small all-reduces, whose backward all-reduces the statistics'
    gradients (``parallel/spatial.py::all_reduce_sum``).  The count is
    the frame's H·W: the block's times the axis size, or, on an uneven
    layout, the blocks' summed in the first all-reduce
    (``all_reduce_sum_count``)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    if spatial is None:
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    else:
        from vst_tpu_torch.parallel import spatial as sp

        total, count = sp.all_reduce_sum_count(
            spatial, xf.sum(dim=(1, 2), keepdim=True),
            x.shape[1] * x.shape[2])
        mean = total / count
        var = sp.all_reduce_sum(spatial, (xf - mean).square().sum(
            dim=(1, 2), keepdim=True)) / count
    out = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    if scale is not None:
        out = out * scale.to(acc)
    if bias is not None:
        out = out + bias.to(acc)
    return out.to(x.dtype)
