"""Resampling (NHWC).  Counterpart of ``vst_tpu/ops/resize.py``.

- ``resize_bilinear``: torch's ``F.interpolate(mode="bilinear",
  align_corners=False)`` without antialiasing (AdaAttN feature pyramids
  and, as ``upsample_bilinear2``, decoder upsampling).
- ``upsample_nearest``: ``F.interpolate(scale_factor=k)``, mode "nearest",
  integer factors (ReCoNet's UpsampleConvLayer).
"""

import numpy as np
import torch
import torch.nn.functional as F


def _bilinear(x, size):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    spatial=None, blocks=None) -> torch.Tensor:
    """Resize an NHWC tensor to (out_h, out_w), bilinear with
    align_corners=False and no antialiasing, in x's dtype.

    ``spatial`` (``parallel/spatial.py``): x is a row block of R rows and
    ``out_h`` the output block's rows.  Down by an integer factor s (R a
    multiple of out_h on every block) every output row reads rows
    s·y + s/2 − 1 and s·y + s/2 of the block: no exchange.  Up ×2 on
    every block (out_h = 2R) is ``upsample_bilinear2``.  Any other resize (a factor that is not
    a whole number, or blocks whose factors differ) reads the rows the
    frame's source index gives (``_resize_rows``).  ``blocks``: every
    block's (rows in, rows out), where the caller has them (one
    ``level_rows`` for several resizes); by default from ``level_rows``:
    this block's where the layout is even, else one small all-gather."""
    r = x.shape[1]
    if spatial is None:
        return _local(x, size)
    if blocks is None:
        from vst_tpu_torch.parallel.spatial import level_rows

        blocks = level_rows(spatial, r, size[0])
    if all(o == i for i, o in blocks):
        return _local(x, size)
    if all(o == 2 * i for i, o in blocks):
        return upsample_bilinear2(x, spatial, size[1])
    s, rem = divmod(sum(i for i, _ in blocks), sum(o for _, o in blocks))
    if not rem and all(i == s * o for i, o in blocks):
        return _local(x, size)
    return _resize_rows(x, size, spatial, blocks)


def upsample_bilinear2(x: torch.Tensor, spatial=None,
                       out_w: int | None = None) -> torch.Tensor:
    """``resize_bilinear`` of x to twice its rows (and to ``out_w``
    columns, by default twice its own): with ``spatial`` every block
    doubles, so it needs no block's rows but its own; the first and last
    output rows read one row beyond the block, one row a side from the
    neighbours, the edge row repeated at a global edge (torch clamps the
    source index there), and the outer two output rows of each side
    cut."""
    r = x.shape[1]
    out_w = 2 * x.shape[2] if out_w is None else out_w
    if spatial is None:
        return _bilinear(x, (2 * r, out_w))
    from vst_tpu_torch.parallel.spatial import exchange_rows

    xh = _bilinear(exchange_rows(spatial, x, 1, 1, "clamp"),
                   (2 * r + 4, out_w))
    return xh[:, 2:2 * r + 2].contiguous()


def _local(x, size):
    return x if tuple(x.shape[1:3]) == tuple(size) else _bilinear(x, size)


def _resize_rows(x, size, spatial, blocks):
    """The general resize of a row block: ``blocks`` holds every rank's
    (rows in, rows out).  Output row Y of the frame reads its source rows
    ⌊t⌋ and ⌊t⌋ + 1 (the last row at the edge) at t = max((Y + ½)·H/H_out
    − ½, 0), torch's arithmetic in x's accumulation dtype; the rows beyond
    the block come from its neighbours (``exchange_rows``, a count for
    each rank).  The columns are resized first, as one ``_bilinear`` over
    the rows, then each output row is h0·row0 + h1·row1, the order of
    torch's own sum."""
    from vst_tpu_torch.parallel.spatial import exchange_rows

    acc = np.float64 if x.dtype == torch.float64 else np.float32
    h_in = sum(i for i, _ in blocks)
    h_out = sum(o for _, o in blocks)
    scale = acc(h_in) / acc(h_out)
    reads, starts = [], [0, 0]
    for i, o in blocks:
        y = np.arange(starts[1], starts[1] + o, dtype=acc)
        t = np.maximum((y + acc(0.5)) * scale - acc(0.5), acc(0))
        y0 = np.minimum(t.astype(np.int64), h_in - 1)
        reads.append((starts[0], i, y0, np.minimum(y0 + 1, h_in - 1),
                      (t - y0).astype(acc)))
        starts = [starts[0] + i, starts[1] + o]
    above = [max(s - int(y0[0]), 0) if len(y0) else 0
             for s, _, y0, _, _ in reads]
    below = [max(int(y1[-1]) - (s + i - 1), 0) if len(y1) else 0
             for s, i, _, y1, _ in reads]
    start, _, y0, y1, lam = reads[spatial.index]
    xh = exchange_rows(spatial, x, above, below, "clamp")
    if xh.shape[2] != size[1]:
        xh = _bilinear(xh, (xh.shape[1], size[1]))
    first = start - above[spatial.index]
    dev = x.device
    r0 = xh[:, torch.from_numpy(y0 - first).to(dev)]
    r1 = xh[:, torch.from_numpy(y1 - first).to(dev)]
    h1 = torch.from_numpy(lam).to(device=dev, dtype=x.dtype)[:, None, None]
    return (1 - h1) * r0 + h1 * r1


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Each pixel of an NHWC tensor repeats ``scale``× along H and W."""
    return x.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
