"""Backward warping and occlusion masks by bilinear grid sampling (NHWC).

Counterpart of ``vst_tpu/ops/warp.py`` (parity: ReCoNet/utilities.py:39-90,
RTNSTV/utilities.py:80-110).  The reference calls
``F.grid_sample(mode="bilinear", align_corners=False)`` itself, and so does
the port: the JAX package's corner-packed gather works around the TPU's
gathers and is not carried over.  The reference's mix of a 2/(dim − 1)
normalization with the align_corners=False unnormalization is reproduced
literally.  Sampling runs in float32 (float64 for float64 inputs) and the
result comes back in x's dtype.
"""

import torch
import torch.nn.functional as F


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "zeros") -> torch.Tensor:
    """Sample the NHWC tensor ``x`` at normalized positions ``grid`` (N, Ho,
    Wo, 2), grid[..., 0] the x and grid[..., 1] the y coordinate in
    [-1, 1]; padding "zeros" or "border".  Differentiable in x and grid."""
    acc = _acc_dtype(x)
    out = F.grid_sample(x.permute(0, 3, 1, 2).to(acc), grid.to(acc),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=False)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _pixel_grid(h: int, w: int, dtype, device, row0: int = 0) -> torch.Tensor:
    """(H, W, 2) grid of (x, y) pixel coordinates, rows from ``row0``."""
    gy, gx = torch.meshgrid(torch.arange(row0, row0 + h, dtype=dtype,
                                         device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _normalize(v, h, w):
    """Pixel positions → grid_sample's [-1, 1], by 2·v/(dim − 1) − 1."""
    return torch.stack([2.0 * v[..., 0] / max(w - 1, 1) - 1.0,
                        2.0 * v[..., 1] / max(h - 1, 1) - 1.0], dim=-1)


def warp(x: torch.Tensor, flow: torch.Tensor,
         padding_mode: str = "zeros", spatial=None,
         sizes=None) -> torch.Tensor:
    """Backward-warp ``x`` (N, H, W, C) by ``flow`` (N, H, W, 2), channels
    (fx, fy): sample x at pixel grid + flow (ReCoNet/utilities.py:39-57).

    ``spatial`` (``parallel/spatial.py``): x and flow are this rank's row
    blocks of R rows.  A flow vector may point anywhere in the frame, so
    the source is gathered over the axis (``gather_rows``, whose backward
    reduce-scatters its gradient), and the grid holds this block's rows
    at the frame's coordinates (from the block's first row, the rows of
    the blocks before it, normalized by the frame's H); the result is
    this block's rows.  ``sizes``: every block's rows, where the caller
    has them; by default from ``level_rows`` (one all-gather where the
    layout is uneven)."""
    _, h, w, _ = x.shape
    acc = _acc_dtype(x)
    if spatial is None:
        grid = _pixel_grid(h, w, acc, x.device)[None] + flow.to(acc)
        return grid_sample_bilinear(x, _normalize(grid, h, w), padding_mode)
    from vst_tpu_torch.parallel.spatial import gather_rows, level_rows

    if sizes is None:
        sizes = [r for r, in level_rows(spatial, h)]
    src = gather_rows(spatial, x, sizes)
    grid = (_pixel_grid(h, w, acc, x.device, sum(sizes[:spatial.index]))[None]
            + flow.to(acc))
    return grid_sample_bilinear(src, _normalize(grid, src.shape[1], w),
                                padding_mode)


def flow_warp_mask(flow01: torch.Tensor, flow10: torch.Tensor,
                   padding_mode: str = "zeros",
                   threshold: float = 2.0) -> torch.Tensor:
    """Occlusion mask from forward/backward flow consistency: 1 where the
    round trip's L1 error over the two flow channels is under
    ``threshold``.  flow01/flow10: (N, H, W, 2) or (H, W, 2); the mask is
    (N, H, W) or (H, W)."""
    squeeze = flow01.dim() == 3
    if squeeze:
        flow01, flow10 = flow01[None], flow10[None]
    _, h, w, _ = flow01.shape
    acc = _acc_dtype(flow01)
    grid = _pixel_grid(h, w, acc, flow01.device)[None]
    target = grid + flow01.to(acc)
    vgrid = grid + flow10.to(acc)
    warped = grid_sample_bilinear(target, _normalize(vgrid, h, w),
                                  padding_mode)
    err = (warped - grid).abs().sum(dim=-1)
    mask = (err < threshold).to(acc)
    return mask[0] if squeeze else mask
