"""Content, style and regularization losses.  Counterpart of
``vst_tpu/losses/perceptual.py`` (parity: ReCoNet/train_single/
train_candy.py:125-145): content on relu3_3, style Grams over the four
taps normalized by C·H·W, total variation as a raw sum.  Weight-free
(the trainers scale), NHWC, taken in float32 (float64 for float64
inputs).  RTNSTV's spatial loss comes with its slice."""

import torch

from vst_tpu_torch.ops.image import gram_matrix


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
