"""Resampling (NHWC).  Counterpart of ``vst_tpu/ops/resize.py``.

- ``resize_bilinear``: torch's ``F.interpolate(mode="bilinear",
  align_corners=False)`` without antialiasing (AdaAttN feature pyramids
  and decoder upsampling).
- ``upsample_nearest``: ``F.interpolate(scale_factor=k)``, mode "nearest",
  integer factors (ReCoNet's UpsampleConvLayer).
"""

import torch
import torch.nn.functional as F


def _bilinear(x, size):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    spatial=None) -> torch.Tensor:
    """Resize an NHWC tensor to (out_h, out_w), bilinear with
    align_corners=False and no antialiasing, in x's dtype.

    ``spatial`` (``parallel/spatial.py``): x is a row block of R rows and
    ``out_h`` the output block's rows.  Down by an integer factor s (R a
    multiple of out_h) every output row reads rows s·y + s/2 − 1 and
    s·y + s/2 of the block: no exchange.  Up ×2 (out_h = 2R) the first
    and last output rows read one row beyond the block: one row a side
    from the neighbours, the edge row repeated at a global edge (torch
    clamps the source index there), and the outer two output rows of
    each side cut."""
    r = x.shape[1]
    if spatial is None or size[0] == r or (size[0] < r and r % size[0] == 0):
        return x if tuple(x.shape[1:3]) == tuple(size) else _bilinear(x, size)
    if size[0] != 2 * r:
        raise ValueError(f"resize_bilinear over a row block: {r} rows to "
                         f"{size[0]} (an integer factor down, or 2× up)")
    from vst_tpu_torch.parallel import spatial as sp

    xh = sp.exchange_rows(spatial, x, 1, 1, "clamp")
    return _bilinear(xh, (2 * r + 4, size[1]))[:, 2:2 * r + 2].contiguous()


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Each pixel of an NHWC tensor repeats ``scale``× along H and W."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
