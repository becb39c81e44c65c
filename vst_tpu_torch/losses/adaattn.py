"""AdaAttN training losses.  Counterpart of ``vst_tpu/losses/adaattn.py``
(parity: AdaAttN/lossfn.py:5-53); every function computes in float32
(float64 for float64 inputs).

- ``global_stylized_loss``: per-channel spatial mean and std distance; the
  std applies Bessel's correction (N − 1), as torch ``Tensor.std``.
- ``local_feature_loss``: MSE against the conv-free AdaAttN target.
- ``cosine_distance``: the channel × channel cosine distance matrix (+1e-6
  in the denominator, unlike the attention module).
- ``image_similarity_loss``: L1 between the row-normalized distance
  matrices of consecutive frames, divided by the pixel count.
Tensors are NHWC.

Each takes ``spatial=`` (``parallel/spatial.py``): the content-side maps
are this rank's row blocks of an H-sharded frame (the style's stay
whole), their sums over H·W are all-reduced over the axis (the mean and
the Bessel std in the unsharded code's two passes, the cosine distance's
dots and norms), and each loss returns this rank's share, the shares
summing over the axis: an MSE of row blocks its block sum over the
frame's count, a term of all-reduced or whole quantities divided by the
axis size (``losses/perceptual.py::_share``).
"""

import torch

from vst_tpu_torch.losses.perceptual import _acc, _share, mse
from vst_tpu_torch.parallel.mesh import batch_shards


def _sum_hw(x, spatial):
    """Σ over dims 1 and 2, over the frame when x is a row block."""
    s = x.sum(dim=(1, 2))
    if spatial is None:
        return s
    from vst_tpu_torch.parallel.spatial import all_reduce_sum

    return all_reduce_sum(spatial, s)


def _spatial_mean_std(f, spatial=None):
    """Per-sample, per-channel mean and std over H·W (Bessel); over the
    frame when f is a row block."""
    x = _acc(f)
    _, h, w, _ = x.shape
    if spatial is None:
        m = x.mean(dim=(1, 2))
        count = h * w
    else:
        from vst_tpu_torch.parallel.spatial import all_reduce_sum_count

        total, count = all_reduce_sum_count(spatial, x.sum(dim=(1, 2)), h * w)
        m = total / count
    var = _sum_hw(torch.square(x - m[:, None, None, :]), spatial) / (count - 1)
    return m, torch.sqrt(var)


def global_stylized_loss(fcs, fs, spatial=None):
    """Mean + std distance of the stylized output's and the style's
    features at one tap; with ``spatial``, ``fcs`` a row block and ``fs``
    whole."""
    m1, s1 = _spatial_mean_std(fcs, spatial)
    m2, s2 = _spatial_mean_std(fs)
    return _share(mse(m1, m2) + mse(s1, s2), spatial)


def local_feature_loss(fcs, adaattn_target, spatial=None):
    return mse(fcs, adaattn_target, spatial)


def cosine_distance(fu, fv, spatial=None):
    """(b, c, c) channel-pair cosine distance of two NHWC maps of one
    shape (AdaAttN/lossfn.py:25-38); of the frame when they are row
    blocks."""
    b, h, w, c = fu.shape
    u = _acc(fu).reshape(b, h * w, c)
    v = _acc(fv).reshape(b, h * w, c)
    dots = torch.matmul(u.transpose(1, 2), v)
    su, sv = torch.square(u).sum(dim=1), torch.square(v).sum(dim=1)
    if spatial is not None:
        from vst_tpu_torch.parallel.spatial import all_reduce_sum

        dots, su, sv = (all_reduce_sum(spatial, t) for t in (dots, su, sv))
    nu, nv = torch.sqrt(su), torch.sqrt(sv)
    return 1.0 - dots / (nu[:, :, None] * nv[:, None, :] + 1e-6)


def image_similarity_loss(fc1, fc2, fcs1, fcs2, mesh=None, spatial=None):
    """Frame-pair similarity-structure preservation
    (AdaAttN/lossfn.py:41-53): a sum over the batch, multiplied by the
    number of shards when the batch is this rank's shard of ``mesh``."""
    n = fc1.shape[1] * fc1.shape[2]
    if spatial is not None:
        from vst_tpu_torch.parallel.spatial import frame_count

        n = frame_count(spatial, n, fc1)
    d_c = cosine_distance(fc1, fc2, spatial)
    d_cs = cosine_distance(fcs1, fcs2, spatial)
    d_c = d_c / d_c.sum(dim=1, keepdim=True)
    d_cs = d_cs / d_cs.sum(dim=1, keepdim=True)
    return _share(torch.abs(d_c - d_cs).sum() / n * batch_shards(mesh),
                  spatial)
