"""Optical-flow temporal losses of ReCoNet.  Counterpart of
``vst_tpu/losses/temporal.py`` (parity: ReCoNet/train_single/
train_candy.py:91-123):

- ``reconet_feature_temporal_loss`` (FTL): the flow resized bilinearly to
  the feature map and rescaled per axis, the first frame's features
  warped, the occlusion mask resized and re-binarized (> 0), the masked
  squared error divided by the COUNT of nonzero mask elements;
- ``reconet_output_temporal_loss`` (OTL): on vgg-normalized images, the
  input term relaxed to Rec.709 luminance, divided by the same count;
- ``rtnstv_temporal_loss``: RTNSTV's masked output loss on 0–255 frames
  (RTNSTV/train.py:117-133), divided by the SUM of the channel-expanded
  mask + 1e-8.

Computed in float32 (float64 for float64 inputs).
"""

import torch

from vst_tpu_torch.ops.image import rgb_to_luma709
from vst_tpu_torch.ops.resize import resize_bilinear
from vst_tpu_torch.ops.warp import warp


def _acc(x):
    return x.double() if x.dtype == torch.float64 else x.float()


def reconet_feature_temporal_loss(feature_map1, feature_map2, flow, mask):
    """FTL between consecutive frames' encoder features (N, Hf, Wf, C),
    with the image-resolution flow (N, H, W, 2) and occlusion mask (N, H,
    W).  Unweighted: the caller scales by lambda_f."""
    _, hf, wf, _ = feature_map1.shape
    h, w = flow.shape[1:3]
    acc = _acc(flow).dtype
    scale = torch.tensor([wf / w, hf / h], dtype=acc, device=flow.device)
    feature_flow = resize_bilinear(_acc(flow), (hf, wf)) * scale
    warped = warp(feature_map1, feature_flow)
    fmask = resize_bilinear(_acc(mask)[..., None], (hf, wf))
    fmask = (fmask > 0).to(acc).expand(feature_map1.shape)
    err = torch.square(_acc(feature_map2) - _acc(warped))
    return torch.sum(fmask * err) / torch.count_nonzero(fmask).to(acc)


def reconet_output_temporal_loss(img1n, img2n, styled1n, styled2n, flow,
                                 mask):
    """OTL with the luminance-relaxed input term; the four (N, H, W, 3)
    images are already vgg-normalized, as in the reference, which
    normalizes before warping."""
    output_term = _acc(styled2n) - _acc(warp(styled1n, flow))
    input_term = _acc(img2n) - _acc(warp(img1n, flow))
    luma = rgb_to_luma709(input_term)[..., None].expand(output_term.shape)
    cmask = _acc(mask)[..., None].expand(output_term.shape)
    loss = torch.sum(cmask * torch.square(output_term - luma))
    return loss / torch.count_nonzero(cmask).to(loss.dtype)


def rtnstv_temporal_loss(styled1, styled2, flow, mask):
    """The first styled frame warped by ``flow`` against the second, on
    0–255 frames (N, H, W, 3), masked by ``mask`` (N, H, W).  Unweighted:
    the caller scales by lam."""
    cmask = _acc(mask)[..., None].expand(styled2.shape)
    err = torch.square(_acc(styled2) - _acc(warp(styled1, flow)))
    return torch.sum(cmask * err) / (torch.sum(cmask) + 1e-8)
