"""Content, style and regularization losses.  Counterpart of
``vst_tpu/losses/perceptual.py``:

- ReCoNet's (ReCoNet/train_single/train_candy.py:125-145): content on
  relu3_3, style Grams over the four taps normalized by C·H·W, total
  variation as a raw sum; weight-free (the trainers scale);
- RTNSTV's ``rtnstv_spatial_loss`` (RTNSTV/train.py:36-60): content on
  relu4_2, style Grams normalized by H·W, the mean of a square-rooted
  total variation; scaled by its weights here, as JAX's.

NHWC, taken in float32 (float64 for float64 inputs).

Each takes ``spatial=`` (``parallel/spatial.py``): the inputs are this
rank's row blocks of an H-sharded frame and each returns this rank's
share, the shares summing over the axis to the frame's loss (the ReCoNet
and RTNSTV steps over a data × space mesh)."""

import torch

from vst_tpu_torch.ops.image import gram_matrix, gram_matrix_hw
from vst_tpu_torch.parallel.mesh import batch_shards


def _acc(x):
    return x.double() if x.dtype == torch.float64 else x.float()


def _share(loss, spatial):
    """A loss that every rank computes whole (of all-reduced or whole
    quantities) → this rank's share: divided by the axis size, so that
    the shares sum to it (in full, its gradient would come out that many
    times too large)."""
    return loss if spatial is None else loss / spatial.size


def mse(a: torch.Tensor, b: torch.Tensor, spatial=None) -> torch.Tensor:
    """torch.nn.MSELoss(reduction="mean"), taken in float32 (float64 when
    either input is float64).  ``spatial``: a and b are row blocks; this
    rank's share Σ(a − b)² / (the frame's element count: the block's
    times the axis size, summed over the blocks on an uneven layout)."""
    if torch.float64 in (a.dtype, b.dtype):
        d = a.double() - b.double()
    else:
        d = a.float() - b.float()
    if spatial is None:
        return torch.mean(torch.square(d))
    from vst_tpu_torch.parallel.spatial import frame_count

    return torch.sum(torch.square(d)) / frame_count(spatial, d.numel(), d)


def reconet_content_loss(styled_feats, content_feats, tap_index: int = 2,
                         spatial=None):
    """MSE of the stylized and content taps at ``tap_index`` (relu3_3)."""
    return mse(styled_feats[tap_index], content_feats[tap_index], spatial)


def reconet_style_loss(styled_feats, style_grams, spatial=None):
    """Σ over taps of MSE(gram(styled tap), style gram), grams / (C·H·W);
    each style gram (1, C, C) broadcasts over the batch, as the
    reference's ``gram_s.expand``.  ``spatial``: the Grams are the
    frame's (all-reduced), so every rank would compute the whole loss;
    each rank's is its share (``_share``)."""
    loss = 0.0
    for feat, gs in zip(styled_feats, style_grams):
        gf = gram_matrix(feat, spatial)
        loss = loss + mse(gf, gs.expand_as(gf))
    return _share(loss, spatial)


def _tv_terms(x, spatial=None):
    """The squared horizontal and vertical neighbour differences that both
    TVs sum, (N, H − 1, W − 1, C) each: the frame's last row and column
    drop out.  ``spatial``: x is a row block; the vertical differences of
    its last row take the next block's first row (``exchange_rows``, one
    row from below, zero under the frame), and the frame's last row drops
    out on the last rank only, which masks out the zero edge's terms."""
    if spatial is None:
        reg1 = torch.square(x[:, :-1, 1:, :] - x[:, :-1, :-1, :])
        reg2 = torch.square(x[:, 1:, :-1, :] - x[:, :-1, :-1, :])
        return reg1, reg2
    from vst_tpu_torch.parallel.spatial import exchange_rows

    xe = exchange_rows(spatial, x, 0, 1, "zero")
    n = x.shape[1] - int(spatial.last)
    reg1 = torch.square(x[:, :n, 1:, :] - x[:, :n, :-1, :])
    reg2 = torch.square(xe[:, 1:n + 1, :-1, :] - xe[:, :n, :-1, :])
    return reg1, reg2


def reconet_reg_loss(styled, mesh=None, spatial=None):
    """Total variation as a raw sum of squared neighbour differences
    (train_candy.py:140-145: torch.sum, not mean).  With a ``mesh``,
    ``styled`` is this rank's shard of the batch and the sum is multiplied
    by the number of shards (the mean over ranks is the global sum).
    ``spatial``: styled is a row block and the sum its share
    (``_tv_terms``)."""
    reg1, reg2 = _tv_terms(_acc(styled), spatial)
    return torch.sum(reg1 + reg2) * batch_shards(mesh)


def rtnstv_spatial_loss(content_feats, styled_feats, style_grams, styled,
                        alpha, beta, gamma, spatial=None):
    """(content, style, reg) of one frame, scaled by alpha, beta, gamma.
    ``content_feats`` / ``styled_feats``: ``vgg19_rtnstv_features`` tap
    dicts; ``style_grams``: (1, C, C) H·W-normalized grams in tap order,
    broadcast over the batch; ``styled``: the 0–255 frames, whose TV is
    the mean of sqrt(max(dx² + dy², 1e-8)).

    ``spatial``: the inputs are row blocks and each term this rank's
    share: the content MSE's and the TV's block sums over the frame's
    counts (the TV's N·(H − 1)·(W − 1)·C), the style MSE of the all-reduced
    Grams as ``reconet_style_loss``'s (``_share``)."""
    content = mse(content_feats["relu4_2"], styled_feats["relu4_2"],
                  spatial) * alpha
    style = 0.0
    for gs, feat in zip(style_grams, styled_feats.values()):
        gf = gram_matrix_hw(feat, spatial)
        style = style + mse(gf, gs.expand_as(gf))
    x = _acc(styled)
    reg1, reg2 = _tv_terms(x, spatial)
    tv = torch.sqrt(torch.clamp(reg1 + reg2, min=1e-8))
    if spatial is None:
        reg = torch.mean(tv)
    else:
        from vst_tpu_torch.parallel.spatial import frame_count

        n, r, w, c = x.shape
        h = frame_count(spatial, r, tv)
        reg = torch.sum(tv) / (n * (h - 1) * (w - 1) * c)
    return content, _share(style, spatial) * beta, reg * gamma
