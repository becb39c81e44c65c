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

Computed in float32 (float64 for float64 inputs).  With a ``mesh`` the
batch is this rank's shard of the global batch: the divisor is the global
batch's count (``parallel/mesh.py::batch_total``) and the loss is
multiplied by the number of shards, so that the mean over ranks is the
global batch's loss.

Each takes ``spatial=`` (``parallel/spatial.py``): the inputs are this
rank's row blocks of H-sharded frames (the flow and mask too), the flow
and mask are resized inside the block (FTL's integer factor 4 needs no
exchange; ``ops/resize.py`` handles the rest), the warp gathers its
source over the axis (``ops/warp.py``), and the mask counts are totals
over the data and space axes of the mesh (``batch_total``); each returns
this rank's share, the shares summing over the space axis.
"""

import torch

from vst_tpu_torch.ops.image import rgb_to_luma709
from vst_tpu_torch.ops.resize import resize_bilinear
from vst_tpu_torch.ops.warp import warp
from vst_tpu_torch.parallel.mesh import batch_shards, batch_total


def _acc(x):
    return x.double() if x.dtype == torch.float64 else x.float()


def _count_mesh(mesh, spatial):
    """The mesh a mask count is totalled over: ``mesh``, or the spatial
    context's own."""
    return mesh if mesh is not None or spatial is None else spatial.mesh


def reconet_feature_temporal_loss(feature_map1, feature_map2, flow, mask,
                                  mesh=None, spatial=None):
    """FTL between consecutive frames' encoder features (N, Hf, Wf, C),
    with the image-resolution flow (N, H, W, 2) and occlusion mask (N, H,
    W).  Unweighted: the caller scales by lambda_f."""
    mesh = _count_mesh(mesh, spatial)
    _, hf, wf, _ = feature_map1.shape
    h, w = flow.shape[1:3]
    acc = _acc(flow).dtype
    scale = torch.tensor([wf / w, hf / h], dtype=acc, device=flow.device)
    blocks = None
    if spatial is not None:
        from vst_tpu_torch.parallel.spatial import level_rows

        # the flow's, the mask's and the feature maps' blocks, for the
        # resizes and the warp
        blocks = level_rows(spatial, h, hf)
    feature_flow = resize_bilinear(_acc(flow), (hf, wf), spatial,
                                   blocks) * scale
    warped = warp(feature_map1, feature_flow, spatial=spatial,
                  sizes=None if blocks is None else [o for _, o in blocks])
    fmask = resize_bilinear(_acc(mask)[..., None], (hf, wf), spatial, blocks)
    fmask = (fmask > 0).to(acc).expand(feature_map1.shape)
    err = torch.square(_acc(feature_map2) - _acc(warped))
    count = batch_total(mesh, torch.count_nonzero(fmask).to(acc))
    return torch.sum(fmask * err) * batch_shards(mesh) / count


def reconet_output_temporal_loss(img1n, img2n, styled1n, styled2n, flow,
                                 mask, mesh=None, spatial=None):
    """OTL with the luminance-relaxed input term; the four (N, H, W, 3)
    images are already vgg-normalized, as in the reference, which
    normalizes before warping."""
    mesh = _count_mesh(mesh, spatial)
    sizes = None
    if spatial is not None:
        from vst_tpu_torch.parallel.spatial import level_rows

        # both warps' blocks
        sizes = [r for r, in level_rows(spatial, img1n.shape[1])]
    output_term = _acc(styled2n) - _acc(warp(styled1n, flow,
                                             spatial=spatial, sizes=sizes))
    input_term = _acc(img2n) - _acc(warp(img1n, flow, spatial=spatial,
                                         sizes=sizes))
    luma = rgb_to_luma709(input_term)[..., None].expand(output_term.shape)
    cmask = _acc(mask)[..., None].expand(output_term.shape)
    loss = torch.sum(cmask * torch.square(output_term - luma))
    count = batch_total(mesh, torch.count_nonzero(cmask).to(loss.dtype))
    return loss * batch_shards(mesh) / count


def rtnstv_temporal_loss(styled1, styled2, flow, mask, mesh=None,
                         spatial=None):
    """The first styled frame warped by ``flow`` against the second, on
    0–255 frames (N, H, W, 3), masked by ``mask`` (N, H, W).  Unweighted:
    the caller scales by lam."""
    mesh = _count_mesh(mesh, spatial)
    cmask = _acc(mask)[..., None].expand(styled2.shape)
    err = torch.square(_acc(styled2) - _acc(warp(styled1, flow,
                                                 spatial=spatial)))
    total = batch_total(mesh, torch.sum(cmask))
    return torch.sum(cmask * err) * batch_shards(mesh) / (total + 1e-8)
