"""Content, style and regularization losses.  Counterpart of
``vst_tpu/losses/perceptual.py``:

- ReCoNet's (ReCoNet/train_single/train_candy.py:125-145): content on
  relu3_3, style Grams over the four taps normalized by C·H·W, total
  variation as a raw sum; weight-free (the trainers scale);
- RTNSTV's ``rtnstv_spatial_loss`` (RTNSTV/train.py:36-60): content on
  relu4_2, style Grams normalized by H·W, the mean of a square-rooted
  total variation; scaled by its weights here, as JAX's.

NHWC, taken in float32 (float64 for float64 inputs)."""

import torch

from vst_tpu_torch.ops.image import gram_matrix, gram_matrix_hw


def _acc(x):
    return x.double() if x.dtype == torch.float64 else x.float()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.nn.MSELoss(reduction="mean"), taken in float32 (float64 when
    either input is float64)."""
    if torch.float64 in (a.dtype, b.dtype):
        return torch.mean(torch.square(a.double() - b.double()))
    return torch.mean(torch.square(a.float() - b.float()))


def reconet_content_loss(styled_feats, content_feats, tap_index: int = 2):
    """MSE of the stylized and content taps at ``tap_index`` (relu3_3)."""
    return mse(styled_feats[tap_index], content_feats[tap_index])


def reconet_style_loss(styled_feats, style_grams):
    """Σ over taps of MSE(gram(styled tap), style gram), grams / (C·H·W);
    each style gram (1, C, C) broadcasts over the batch, as the
    reference's ``gram_s.expand``."""
    loss = 0.0
    for feat, gs in zip(styled_feats, style_grams):
        gf = gram_matrix(feat)
        loss = loss + mse(gf, gs.expand_as(gf))
    return loss


def reconet_reg_loss(styled):
    """Total variation as a raw sum of squared neighbour differences
    (train_candy.py:140-145: torch.sum, not mean)."""
    x = _acc(styled)
    reg1 = torch.square(x[:, :-1, 1:, :] - x[:, :-1, :-1, :])
    reg2 = torch.square(x[:, 1:, :-1, :] - x[:, :-1, :-1, :])
    return torch.sum(reg1 + reg2)


def rtnstv_spatial_loss(content_feats, styled_feats, style_grams, styled,
                        alpha, beta, gamma):
    """(content, style, reg) of one frame, scaled by alpha, beta, gamma.
    ``content_feats`` / ``styled_feats``: ``vgg19_rtnstv_features`` tap
    dicts; ``style_grams``: (1, C, C) H·W-normalized grams in tap order,
    broadcast over the batch; ``styled``: the 0–255 frames, whose TV is
    the mean of sqrt(max(dx² + dy², 1e-8))."""
    content = mse(content_feats["relu4_2"], styled_feats["relu4_2"]) * alpha
    style = 0.0
    for gs, feat in zip(style_grams, styled_feats.values()):
        gf = gram_matrix_hw(feat)
        style = style + mse(gf, gs.expand_as(gf))
    x = _acc(styled)
    reg1 = torch.square(x[:, :-1, 1:, :] - x[:, :-1, :-1, :])
    reg2 = torch.square(x[:, 1:, :-1, :] - x[:, :-1, :-1, :])
    reg = torch.mean(torch.sqrt(torch.clamp(reg1 + reg2, min=1e-8))) * gamma
    return content, style * beta, reg
