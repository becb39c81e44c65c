"""Multi-scale feature pyramid.  Counterpart of ``vst_tpu/ops/features.py``
(parity: AdaAttN/utilities.py:98-109)."""

from collections.abc import Sequence

import torch

from vst_tpu_torch.ops.resize import resize_bilinear


def pyramid_rows(feats: Sequence[torch.Tensor], spatial=None):
    """Every block's rows of each of ``feats`` (row blocks over
    ``spatial``), one tuple a rank, from one ``level_rows``: no
    collective where the layout is even, one all-gather otherwise; None
    without ``spatial``."""
    if spatial is None:
        return None
    from vst_tpu_torch.parallel.spatial import level_rows

    return level_rows(spatial, *(f.shape[1] for f in feats))


def feature_down_sample(feats: Sequence[torch.Tensor],
                        last_feat_idx: int, spatial=None,
                        rows=None) -> torch.Tensor:
    """feats[0..last_feat_idx] bilinearly resized to feats[last_feat_idx]'s
    spatial size and concatenated along channels (NHWC).

    ``spatial``: the feats are row blocks of an H-sharded frame; where
    each factor (2–16 on AdaAttN's VGG19 taps) divides every block's rows,
    every source row lies in the block, and otherwise (a frame whose H is
    not a multiple of 16 split unevenly) ``resize_bilinear`` takes the
    rows the frame's source index reads from the neighbours.  ``rows``:
    every block's rows at every level (``pyramid_rows`` of ``feats``,
    which it defaults to), so that several calls over one pyramid learn
    them once."""
    target = feats[last_feat_idx]
    size = tuple(target.shape[1:3])
    if rows is None:
        rows = pyramid_rows(feats[:last_feat_idx + 1], spatial)
    parts = [resize_bilinear(
        feats[i], size, spatial,
        None if rows is None else [(t[i], t[last_feat_idx]) for t in rows])
        for i in range(last_feat_idx)]
    return torch.cat(parts + [target], dim=-1)
