"""AdaAttN training losses.  Counterpart of ``vst_tpu/losses/adaattn.py``
(parity: AdaAttN/lossfn.py:5-53); every function computes in float32.

- ``global_stylized_loss``: per-channel spatial mean and std distance; the
  std applies Bessel's correction (N − 1), as torch ``Tensor.std``.
- ``local_feature_loss``: MSE against the conv-free AdaAttN target.
- ``cosine_distance``: the channel × channel cosine distance matrix (+1e-6
  in the denominator, unlike the attention module).
- ``image_similarity_loss``: L1 between the row-normalized distance
  matrices of consecutive frames, divided by the pixel count.
Tensors are NHWC.
"""

import torch

from vst_tpu_torch.losses.perceptual import mse


def _spatial_mean_std(f):
    """Per-sample, per-channel mean and std over H·W (Bessel)."""
    x = f.float()
    _, h, w, _ = x.shape
    m = x.mean(dim=(1, 2))
    var = torch.square(x - m[:, None, None, :]).sum(dim=(1, 2)) / (h * w - 1)
    return m, torch.sqrt(var)


def global_stylized_loss(fcs, fs):
    """Mean + std distance of the stylized output's and the style's
    features at one tap."""
    m1, s1 = _spatial_mean_std(fcs)
    m2, s2 = _spatial_mean_std(fs)
    return mse(m1, m2) + mse(s1, s2)


def local_feature_loss(fcs, adaattn_target):
    return mse(fcs, adaattn_target)


def cosine_distance(fu, fv):
    """(b, c, c) channel-pair cosine distance of two NHWC maps of one
    shape (AdaAttN/lossfn.py:25-38)."""
    b, h, w, c = fu.shape
    u = fu.reshape(b, h * w, c).float()
    v = fv.reshape(b, h * w, c).float()
    dots = torch.matmul(u.transpose(1, 2), v)
    nu = torch.sqrt(torch.square(u).sum(dim=1))
    nv = torch.sqrt(torch.square(v).sum(dim=1))
    return 1.0 - dots / (nu[:, :, None] * nv[:, None, :] + 1e-6)


def image_similarity_loss(fc1, fc2, fcs1, fcs2):
    """Frame-pair similarity-structure preservation
    (AdaAttN/lossfn.py:41-53)."""
    n = fc1.shape[1] * fc1.shape[2]
    d_c = cosine_distance(fc1, fc2)
    d_cs = cosine_distance(fcs1, fcs2)
    d_c = d_c / d_c.sum(dim=1, keepdim=True)
    d_cs = d_cs / d_cs.sum(dim=1, keepdim=True)
    return torch.abs(d_c - d_cs).sum() / n
