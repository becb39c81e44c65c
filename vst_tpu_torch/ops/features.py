"""Multi-scale feature pyramid.  Counterpart of ``vst_tpu/ops/features.py``
(parity: AdaAttN/utilities.py:98-109)."""

from collections.abc import Sequence

import torch

from vst_tpu_torch.ops.resize import resize_bilinear


def feature_down_sample(feats: Sequence[torch.Tensor],
                        last_feat_idx: int) -> torch.Tensor:
    """feats[0..last_feat_idx] bilinearly resized to feats[last_feat_idx]'s
    spatial size and concatenated along channels (NHWC)."""
    target = feats[last_feat_idx]
    size = tuple(target.shape[1:3])
    parts = [resize_bilinear(feats[i], size) for i in range(last_feat_idx)]
    return torch.cat(parts + [target], dim=-1)
